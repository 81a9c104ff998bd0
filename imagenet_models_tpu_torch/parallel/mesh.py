"""Process groups for data parallelism: one process per device. Port of
imagenet_models_tpu/parallel/mesh.py.

The JAX package runs one program over a device mesh and reduces with
`lax.pmean` inside `shard_map`; here each process drives one GPU (or, with
IMTPU_PLATFORM=cpu, the CPU) and the train step reduces through
`torch.distributed`: NCCL between GPUs, gloo on the CPU. Every device
collective of the port is an `all_reduce` or a `broadcast`, which is what
gloo carries on CUDA tensors too; small host objects (the run name) travel by
`broadcast_object_list`.

ZeRO-1 (`zero1_owners`): each parameter leaf is owned whole by one rank,
which alone keeps its optimizer moments and EMA shadow, updates it, and
broadcasts it. The JAX package shards each leaf along an axis instead
(`zero1_spec`); the update is elementwise but for LAMB's per-leaf trust
ratio, which whole leaves keep local, and the math is the same either way.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

# elements per flat fp32 bucket of a collective (64 MiB)
BUCKET_NUMEL = 1 << 24


def init_distributed(coordinator: str = "", num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device: Optional[torch.device] = None,
                     local_rank: Optional[int] = None) -> torch.device:
    """Join the process group and return this process's device.

    `coordinator` is "host:port" (with `num_processes` and `process_id`: a
    `tcp://` rendezvous), "auto" (`env://`: torchrun's RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT, the counterpart of jax.distributed's own
    detection) or "" (one process, no group). `device` is the entry's device
    type: a CUDA device joins over NCCL, the CPU over gloo. On CUDA each
    process takes cuda:LOCAL_RANK (the environment's, else `local_rank`,
    else its rank modulo the visible device count) and makes it current. A
    failed rendezvous or NCCL initialisation raises."""
    device = torch.device("cuda" if device is None else device)
    if coordinator == "auto":
        rank_, world_, init = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://"
    elif coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("--dist-coordinator host:port needs --dist-num-processes and "
                             "--dist-process-id")
        rank_, world_, init = int(process_id), int(num_processes), f"tcp://{coordinator}"
    else:
        rank_ = world_ = init = None
    if device.type == "cuda":
        if local_rank is None or "LOCAL_RANK" in os.environ:
            local_rank = int(os.environ.get("LOCAL_RANK", (rank_ or 0) % torch.cuda.device_count()))
        device = torch.device("cuda", local_rank if init else torch.cuda.current_device())
        torch.cuda.set_device(device)
    if init:
        dist.init_process_group("gloo" if device.type == "cpu" else "nccl", init_method=init,
                                world_size=world_, rank=rank_)
    return device


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def data_group():
    """The group a train step reduces over: every process, or None when this
    process is alone (no group joined)."""
    return dist.group.WORLD if initialized() else None


def world(group=None) -> int:
    return dist.get_world_size(group) if initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if initialized() else 0


def is_primary() -> bool:
    """Whether this process writes files and logs: rank 0, or the only one."""
    return rank() == 0


def destroy() -> None:
    if initialized():
        dist.destroy_process_group()


def rank_seed(seed: int, rank_: int) -> int:
    """The seed of a rank's generators: seed + rank, as timm's
    random_seed(seed, rank) (the JAX step folds the rank into its key)."""
    return seed + rank_


def collective_device(group=None) -> torch.device:
    """Where a host value must be to enter a collective: the current CUDA
    device under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _global_rank(group, r: int) -> int:
    return r if group is None or group is dist.group.WORLD else dist.get_global_rank(group, r)


def zero1_owners(params: Mapping[str, torch.Tensor], n_ranks: int) -> Dict[str, int]:
    """The rank that owns each leaf under ZeRO-1: greedily by element count,
    the largest leaf first (ties in the mapping's order), each to the rank
    with the fewest elements so far (ties to the lowest rank). It depends
    only on the names, shapes and order, so every rank and every run agrees."""
    load = [0] * max(int(n_ranks), 1)
    owners = {}
    for name, p in sorted(params.items(), key=lambda kv: -kv[1].numel()):
        r = min(range(len(load)), key=lambda i: (load[i], i))
        owners[name] = r
        load[r] += p.numel()
    return {name: owners[name] for name in params}


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Consecutive runs of `tensors` of at most BUCKET_NUMEL elements each (a
    larger tensor alone)."""
    out, cur, size = [], [], 0
    for t in tensors:
        if cur and size + t.numel() > BUCKET_NUMEL:
            out.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += t.numel()
    if cur:
        out.append(cur)
    return out


def _unflatten(flat: torch.Tensor, chunk: Sequence[torch.Tensor]) -> None:
    """Copy the consecutive pieces of `flat` into the tensors of `chunk`, in
    one multi-tensor copy (a copy a tensor is a launch a leaf, which held
    the all-reduce of map_convnext_tiny's 344 gradients on the host)."""
    pieces = flat.split([t.numel() for t in chunk])
    torch._foreach_copy_(list(chunk), [v.view_as(t) for v, t in zip(pieces, chunk)])


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace every tensor by its mean over the group's ranks, in place,
    through a few flat fp32 buckets (sum, then a division by the world)."""
    n = world(group)
    for chunk in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1).float() for t in chunk])
        dist.all_reduce(flat, group=group)
        flat /= n
        _unflatten(flat, chunk)


@torch.no_grad()
def broadcast_from_owners(tensors: Mapping[str, torch.Tensor], owners: Mapping[str, int],
                          group=None) -> None:
    """Give every rank the owner's value of each tensor, in place: per owner,
    its leaves in flat fp32 buckets broadcast from it. Every rank passes
    tensors of the same names and shapes (a non-owner's values are
    overwritten)."""
    me = rank(group)
    for r in range(world(group)):
        mine = [t for k, t in tensors.items() if owners[k] == r]
        for chunk in _buckets(mine):
            if me == r:
                flat = torch.cat([t.reshape(-1).float() for t in chunk])
            else:
                flat = torch.empty(sum(t.numel() for t in chunk), dtype=torch.float32,
                                   device=chunk[0].device)
            dist.broadcast(flat, src=_global_rank(group, r), group=group)
            if me != r:
                _unflatten(flat, chunk)


def gather_owned(parts: Mapping[str, torch.Tensor], like: Mapping[str, torch.Tensor],
                 owners: Mapping[str, int], group=None) -> Dict[str, torch.Tensor]:
    """The full mapping of a ZeRO-1 sharded state on every rank: `parts` holds
    this rank's own leaves; each other leaf, shaped as in `like` (fp32, on
    its device), comes from its owner by `broadcast_from_owners`."""
    full = {k: parts[k] if k in parts else torch.empty(p.shape, dtype=torch.float32,
                                                        device=p.device)
            for k, p in like.items()}
    broadcast_from_owners(full, owners, group)
    return full


class AllReduceMean(torch.autograd.Function):
    """The mean of a tensor over the group's ranks, with autograd: the
    backward is the mean of the cotangents over the ranks (`lax.pmean`'s
    transpose), so that each rank's backward carries every rank's use of a
    statistic shared by all."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / world(group)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / world(ctx.group), None


def all_reduce_sum(values: Sequence[float], group=None) -> List[float]:
    """The sums over the group's ranks of host numbers, in float64."""
    t = torch.tensor(list(values), dtype=torch.float64, device=collective_device(group))
    dist.all_reduce(t, group=group)
    return t.tolist()


def any_rank(flag: bool, group=None) -> bool:
    """Whether `flag` is set on any rank (an all_reduce MAX)."""
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=collective_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def barrier(group=None) -> None:
    """Wait until every rank is here (a one-element all_reduce)."""
    all_reduce_sum([0.0], group)


def broadcast_object(obj, src: int = 0, group=None):
    """Rank `src`'s `obj` on every rank (a picklable host object)."""
    box = [obj]
    dist.broadcast_object_list(box, src=_global_rank(group, src), group=group,
                               device=collective_device(group))
    return box[0]

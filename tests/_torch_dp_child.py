"""The ranks of the port's data-parallel CPU tests (tests/test_torch_parallel.py,
tests/test_torch_split_bn.py): each process joins a gloo group of `world`
ranks, runs the named tasks in order and writes what each found to
`<workdir>/<task>.<rank>.pt`. It imports only the port (and torch, numpy),
never JAX; the tests spawn it with torch.multiprocessing and hold what it
writes against the JAX package in their own process.

Inputs come from the test through `workdir`: `inputs.pt` holds the weights
(port state dicts), the batches and the settings of every task."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from imagenet_models_tpu_torch.ckpt.saver import CheckpointSaver, _gathered, resume_checkpoint
from imagenet_models_tpu_torch.data.loader import DataLoader
from imagenet_models_tpu_torch.models.convnext import ConvNeXt
from imagenet_models_tpu_torch.models.resnet import MAP_ResNet
from imagenet_models_tpu_torch.nn import layers as tl
from imagenet_models_tpu_torch.parallel import mesh
from imagenet_models_tpu_torch.train import engine
from imagenet_models_tpu_torch.train.losses import create_loss_fn
from imagenet_models_tpu_torch.train.optim import create_optimizer
from imagenet_models_tpu_torch.train.state import create_train_state, make_train_step

# the models of the tests: test_zero1.py's BN-bearing mmcap ConvNeXt, and
# test_torch_resnet.py's narrow MAP_ResNet
CONVNEXT = dict(depths=(1, 1, 1, 1), dims=(8, 8, 16, 16), num_classes=13, global_pool="mmcap",
                last_dim=16, n_groups=2, n_tokens=2, gram_group=2, bp_dim=16, ca_dim=16,
                num_heads=2)
RESNET = dict(nblock=(1, 1, 1, 1), channels=(16, 16, 32, 32), se=True, stem_type="deep",
              num_classes=7, last_dim=32, n_groups=2, n_tokens=2, gram_group=16)
MODELS = {"convnext": (ConvNeXt, CONVNEXT), "resnet": (MAP_ResNet, RESNET)}


def build(kind: str, state_dict) -> torch.nn.Module:
    """The test's model with the given weights, its dropouts at 0 (the two
    frameworks draw other bits; drop-path is 0 in these models)."""
    cls, cfg = MODELS[kind]
    model = cls(**cfg)
    model.load_state_dict(state_dict, strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def trainer(kind: str, state_dict, recipe: dict, group=None, zero1: bool = False):
    """(state, step) of `recipe` ("opt", "loss", "dec_lam", "ema") for the
    model, over `group` (None: one process)."""
    model = build(kind, state_dict)
    opt = create_optimizer("lamb", **recipe["opt"])
    state = create_train_state(model, opt, ema_decay=recipe["ema"], device="cpu", group=group,
                               zero1=zero1)
    step = make_train_step(model, opt, create_loss_fn(**recipe["loss"]),
                           dec_lam=recipe["dec_lam"], ema_decay=recipe["ema"], group=group,
                           zero1=zero1)
    return state, step


def local_rows(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """This rank's contiguous block of a global batch (the loader's shard)."""
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def dump(state) -> dict:
    """The whole state as this rank sees it, ZeRO-1 leaves gathered from
    their owners (a collective)."""
    opt, ema = _gathered(state)
    return {"model": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "opt": {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
                    for k, v in opt.items() if k != "grouped"},
            "ema": None if ema is None else {k: v.clone() for k, v in ema.items()},
            "ema_batch_stats": state.ema_batch_stats, "step": state.step,
            "owned_opt": sorted(state.opt_state["mu"]),
            "owned_ema": None if state.ema_params is None else sorted(state.ema_params)}


# ---------------------------------------------------------------- tasks

def task_train(rank, world, group, spec, workdir):
    """One step of the recipe on this rank's rows of each global batch of
    `batches`; writes the metrics of every step and the state after them. With
    `save`, a checkpoint of the state goes to that directory."""
    state, step = trainer(spec["model"], spec["weights"], spec["recipe"], group, spec["zero1"])
    gen = torch.Generator().manual_seed(mesh.rank_seed(0, rank))
    metrics = []
    for images, targets in spec["batches"]:
        state, m = step(state, local_rows(images, rank, world), local_rows(targets, rank, world),
                        gen)
        metrics.append({k: v.item() for k, v in m.items()})
    out = {"metrics": metrics, "owners": state.owners, **dump(state)}
    if spec.get("save"):
        saver = CheckpointSaver(spec["save"], generator=gen)
        saver.save_checkpoint(state, epoch=0, metric=1.0)
        saver.close()
        out["generator"] = gen.get_state()
    return out


def task_resume(rank, world, group, spec, workdir):
    """Resume a checkpoint into a fresh state (ZeRO-1 over the group) and
    write the state as this rank holds it."""
    state, _ = trainer(spec["model"], spec["weights"], spec["recipe"], group, spec["zero1"])
    gen = torch.Generator().manual_seed(mesh.rank_seed(0, rank))
    fresh = gen.get_state()
    state, epoch = resume_checkpoint(spec["path"], state, generator=gen)
    return {"epoch": epoch, "generator": gen.get_state(), "fresh_generator": fresh,
            "ema_part": None if state.ema_params is None else dict(state.ema_params),
            "mu_part": dict(state.opt_state["mu"]), **dump(state)}


def task_preempt(rank, world, group, spec, workdir):
    """Five batches with sync points at 0 and 3 (log interval 3) and 4 (the
    last); rank 1 alone gets the signal during batch 1."""
    ran = []

    def step_fn(state, images, targets, generator):
        ran.append(len(ran))
        if rank == 1 and len(ran) == 2:
            engine._PREEMPT["signaled"] = True
        return state, {"loss": torch.ones(())}

    class Loader:
        batch_size, mixup_enabled = 2, False

        def __len__(self):
            return 5

        def __iter__(self):
            for _ in range(5):
                yield np.zeros((2, 4, 4, 3), np.float32), np.zeros((2,), np.int64)

    try:
        engine.train_one_epoch(0, None, step_fn, Loader(), None, torch.device("cpu"),
                               log_interval=3)
        raised = None
    except engine.Preempted as e:
        raised = str(e)
    finally:
        engine._PREEMPT["signaled"] = False
    return {"raised": raised, "ran": ran}


class Samples:
    """`images` and `labels` by index, the loader's dataset interface."""

    def __init__(self, images, labels):
        self.images, self.labels = images, labels

    def __len__(self):
        return len(self.labels)

    def load(self, i):
        return self.images[i], int(self.labels[i])


def flags_step(images, targets):
    """An eval step whose top-1 and top-5 flags follow from the inputs."""
    x = images.reshape(images.shape[0], -1)
    logits = x[:, :13]
    top5 = torch.topk(logits, 5, dim=-1).indices
    return logits, (top5[:, 0] == targets).float(), (top5 == targets[:, None]).any(dim=1).float()


def task_validate(rank, world, group, spec, workdir):
    """`engine.validate` over this rank's shard of a sharded eval loader."""
    loader = DataLoader(Samples(spec["images"], spec["labels"]), spec["batch"],
                        lambda img, rng: img, num_workers=1, num_shards=world, shard_id=rank)
    sizes = [len(t) for _, t in loader]
    metrics, stats = engine.validate(flags_step, loader, torch.device("cpu"), tta=spec["tta"])
    return {"metrics": dict(metrics), "local_sizes": sizes}


def task_bn(rank, world, group, spec, workdir):
    """One training forward and backward of a split BatchNorm with
    synchronised statistics over this rank's rows; writes the output rows,
    the input's and the affine's gradients and the running statistics."""
    bn = tl.BatchNorm(spec["x"].shape[-1])
    bn.load_state_dict(spec["weights"])
    tl.set_bn_splits(bn, spec["splits"])
    tl.set_bn_sync(bn, group)
    bn.train()
    x = local_rows(spec["x"], rank, world).clone().requires_grad_()
    y = bn(x)
    (y * local_rows(spec["g"], rank, world)).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


TASKS = {"train": task_train, "resume": task_resume, "preempt": task_preempt,
         "validate": task_validate, "bn": task_bn}


def main(rank: int, world: int, port: int, workdir: str, tasks) -> None:
    """torch.multiprocessing entry: join the gloo group, run `tasks` (names of
    entries of inputs.pt, each with its "task"), write each result."""
    torch.set_num_threads(1)
    os.environ["IMTPU_PLATFORM"] = "cpu"
    mesh.init_distributed(f"127.0.0.1:{port}", world, rank, device=torch.device("cpu"))
    try:
        inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
        for name in tasks:
            spec = inputs[name]
            out = TASKS[spec["task"]](rank, world, mesh.data_group(), spec, workdir)
            torch.save(out, os.path.join(workdir, f"{name}.{rank}.pt"))
            dist.barrier()
    finally:
        mesh.destroy()

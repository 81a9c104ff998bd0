"""Train state, train step and eval step. Port of imagenet_models_tpu/train/state.py.

The JAX package keeps parameters in a pytree beside a stateless module; here
the module holds them, so `TrainState` carries the model with the step count,
the optimizer state and the EMA shadow (ModelEmaV2: parameters and BatchNorm
running statistics).

Data parallelism is one process per device over a process group
(`parallel.mesh`), in the JAX step's two formulations:
- replicated (JAX's `shard_map` step, :197-207, :251-261): each rank runs
  its own rows, BatchNorm normalises with per-rank statistics, and after the
  microbatch loop the gradients, the loss and the BatchNorm running
  statistics are mean-all-reduced; every rank then makes the same update;
- ZeRO-1 (JAX's global-jit step, :56-100, :225-249): the BatchNorms
  synchronise their statistics (JAX's global-batch statistics), gradients
  and loss are reduced as above, and the optimizer state and the EMA shadow
  of the parameters exist only for the leaves a rank owns
  (`mesh.zero1_owners`): each rank updates its leaves, then each owner
  broadcasts them.
At world 1 both give the one-process step's bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from imagenet_models_tpu_torch.core.registry import resolve_device
from imagenet_models_tpu_torch.nn.heads import average_head_logits
from imagenet_models_tpu_torch.nn.layers import grouped_weights, set_bn_sync
from imagenet_models_tpu_torch.parallel import mesh
from imagenet_models_tpu_torch.train.losses import multi_head_loss
from imagenet_models_tpu_torch.train.optim import Optimizer, global_norm

_BN_STATS = ("running_mean", "running_var")


@dataclass
class TrainState:
    """`owners` (ZeRO-1 only) maps every parameter to the rank that owns it;
    `opt_state` and `ema_params` then hold this rank's leaves alone. `group`
    is the process group of the ranks (None: one process)."""
    step: int
    model: torch.nn.Module
    opt_state: Dict
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    ema_batch_stats: Optional[Dict[str, torch.Tensor]] = None
    owners: Optional[Dict[str, int]] = None
    group: Any = None

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return {k: b for k, b in self.model.named_buffers() if k.endswith(_BN_STATS)}

    def owned(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The entries of `tree` (keyed by parameter) that this rank keeps."""
        if self.owners is None:
            return dict(tree)
        me = mesh.rank(self.group)
        return {k: v for k, v in tree.items() if self.owners[k] == me}


def create_train_state(model: torch.nn.Module, optimizer: Optimizer, ema_decay: float = 0.0,
                       device: Optional[torch.device | str] = None, group=None,
                       zero1: bool = False) -> TrainState:
    """Move `model` to `device` (the GPU when None) and make its optimizer
    state, and with `ema_decay` an EMA shadow of its parameters and BN
    running statistics (copies of the current values).

    With a process `group`, every rank first takes rank 0's parameters and
    buffers (one broadcast); with `zero1` too, the optimizer state and the
    parameters' EMA shadow are made for this rank's leaves only (the
    counterpart of JAX's place_state(..., zero1=True))."""
    model.to(resolve_device(device))
    state = TrainState(step=0, model=model, opt_state={}, group=group)
    if group is not None:
        tensors = {k: t for k, t in [*model.named_parameters(), *model.named_buffers()]
                   if t.is_floating_point()}  # integer buffers are tables made at build
        mesh.broadcast_from_owners(tensors, dict.fromkeys(tensors, 0), group)
        if zero1:
            state.owners = mesh.zero1_owners(state.params(), mesh.world(group))
    state.opt_state = optimizer.init(state.owned(state.params()), grouped=grouped_weights(model))
    if ema_decay:
        state.ema_params = {k: p.detach().clone() for k, p in state.owned(state.params()).items()}
        state.ema_batch_stats = {k: b.detach().clone() for k, b in state.batch_stats().items()}
    return state


def full_ema_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """The EMA shadow of every parameter: under ZeRO-1 gathered from the
    owners (a collective: every rank calls it), else the state's own."""
    if state.owners is None:
        return state.ema_params
    return mesh.gather_owned(state.ema_params, state.params(), state.owners, state.group)


def make_train_step(model: torch.nn.Module, optimizer: Optimizer, base_loss: Callable,
                    dec_lam: float = 0.0, ema_decay: float = 0.0, grad_accum: int = 1,
                    token_distillation: bool = True, use_kernel: Optional[bool] = None,
                    group=None, zero1: bool = False):
    """The train step (state.py:103-261) for `model`, which the state must hold.

    Returns step(state, images, targets, generator=None) -> (state, metrics).
    The batch (this rank's rows) is split into `grad_accum` microbatches in
    order; each runs the training forward (the multi-head loss for a tuple
    of head outputs) and its backward, the gradients are averaged, the
    optimizer updates the parameters, then the EMA shadow moves to
    d*e + (1-d)*p. BatchNorm running statistics carry from one microbatch to
    the next. `generator` (on the images' device) draws the stochastic-depth
    masks; the head's dropouts draw from PyTorch's default generator of that
    device. metrics holds the mean microbatch "loss" and the "grad_norm" of
    the averaged gradients, as 0-d tensors on the device. `use_kernel` is the
    model's kernel dispatch (the ConvNeXt blocks' LN+MLP, MaxViT's partition
    attention, GA-CSWin's stripe attention; None: the kernels for CUDA
    tensors, False: their plain twins).

    With a process `group`, the averaged gradients, the loss and (replicated
    formulation) the BatchNorm running statistics are mean-all-reduced
    before the update, so every rank's metrics are the global ones; each
    rank passes its own generator (seeded from the run's seed and its rank).
    `zero1` selects the ZeRO-1 formulation (module docstring): the model's
    BatchNorms synchronise their statistics over `group` from here on, and
    the state must come from create_train_state(..., group, zero1=True).
    Without a group `zero1` changes nothing: one process owns every leaf.
    """
    zero1 = zero1 and group is not None
    if zero1:
        set_bn_sync(model, group)

    def loss_of(images, targets, generator):
        out = model(images, use_kernel=use_kernel, generator=generator)
        if isinstance(out, (tuple, list)):
            return multi_head_loss(out, targets, base_loss, dec_lam,
                                   token_distillation=token_distillation)
        return base_loss(out, targets)

    def step(state: TrainState, images: torch.Tensor, targets: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Tuple[TrainState, Dict]:
        if state.model is not model:
            raise ValueError("the train state holds another model than this step's")
        if (state.owners is not None) != zero1:
            raise ValueError("the train state's ZeRO-1 placement does not match this step's")
        if images.shape[0] % grad_accum:
            raise ValueError(f"batch of {images.shape[0]} does not split into {grad_accum} "
                             "microbatches")
        model.train()
        params = state.params()
        for p in params.values():
            p.grad = None
        mb = images.shape[0] // grad_accum
        losses = []
        for a in range(grad_accum):
            loss = loss_of(images[a * mb:(a + 1) * mb], targets[a * mb:(a + 1) * mb], generator)
            loss.backward()
            losses.append(loss.detach())
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in params.items()}
        if grad_accum > 1:
            grads = {k: g / grad_accum for k, g in grads.items()}
        loss = torch.stack(losses).mean()
        if group is not None:
            # the DDP all-reduce (JAX's pmean, :197-207); the running
            # statistics of synchronised BatchNorms agree already
            stats = [] if zero1 else list(state.batch_stats().values())
            mesh.all_reduce_mean([*grads.values(), loss, *stats], group)
        if zero1:
            optimizer.step(params, grads, state.opt_state, owned=state.owned(params).keys())
        else:
            optimizer.step(params, grads, state.opt_state)
        if ema_decay and state.ema_params is not None:
            d = ema_decay
            with torch.no_grad():
                for shadow, live in ((state.ema_params, params),
                                     (state.ema_batch_stats, state.batch_stats())):
                    ema = list(shadow.values())
                    torch._foreach_mul_(ema, d)
                    torch._foreach_add_(ema, [live[k] for k in shadow], alpha=1 - d)
        if zero1:
            mesh.broadcast_from_owners(params, state.owners, group)
        state.step += 1
        metrics = {"loss": loss, "grad_norm": global_norm(list(grads.values()))}
        for p in params.values():
            p.grad = None
        return state, metrics

    return step


def make_eval_step(model: torch.nn.Module, tta: int = 0, use_kernel: Optional[bool] = None,
                   use_ema: bool = False, state: Optional[TrainState] = None
                   ) -> Callable[[torch.Tensor, torch.Tensor],
                                 Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Eval step: forward in eval mode, average the multi-head logits, return
    (logits, top-1 flags, top-5 flags) per example, flags as fp32 0/1
    (state.py:265-304).

    With `use_ema`, the forward reads the EMA shadow of `state` (parameters
    and BN running statistics) instead of the model's own tensors, leaving
    the model untouched; under ZeRO-1 the shadow is gathered from its owners
    once per train step of the state (`full_ema_params`, collective; the
    copy is kept until the next gather), so every rank evaluates the same
    model. tta > 1 also averages logits over
    groups of `tta` consecutive samples and strides the targets; the flags
    then have B // tta entries (the remainder is dropped)."""
    if use_ema and (state is None or state.ema_params is None):
        raise ValueError("use_ema needs a train state made with ema_decay")
    gathered = {}

    def ema_tensors():
        if gathered.get("step") != state.step:
            gathered.clear()
            gathered.update(step=state.step, params=full_ema_params(state))
        return {**gathered["params"], **state.ema_batch_stats}

    def forward(images):
        if not use_ema:
            return model(images, use_kernel=use_kernel)
        return torch.func.functional_call(model, ema_tensors(), (images,),
                                          {"use_kernel": use_kernel}, strict=False)

    def step(images: torch.Tensor, targets: torch.Tensor):
        model.eval()
        with torch.inference_mode():
            logits = average_head_logits(forward(images))
            if tta and tta > 1:
                g = logits.shape[0] // tta
                logits = logits[: g * tta].reshape(g, tta, -1).mean(dim=1)
                targets = targets[: g * tta: tta]
            top5 = torch.topk(logits, 5, dim=-1).indices
            correct1 = (top5[:, 0] == targets).float()
            correct5 = (top5 == targets[:, None]).any(dim=1).float()
        return logits, correct1, correct5

    return step

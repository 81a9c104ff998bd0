"""Train state, train step and eval step. Port of imagenet_models_tpu/train/state.py.

The JAX package keeps parameters in a pytree beside a stateless module; here
the module holds them, so `TrainState` carries the model with the step count,
the optimizer state and the EMA shadow (ModelEmaV2: parameters and BatchNorm
running statistics). One process, one device: the mesh, shard_map, BN-stat
pmean and ZeRO-1 placement of the JAX step come with the DDP slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from imagenet_models_tpu_torch.core.registry import resolve_device
from imagenet_models_tpu_torch.nn.heads import average_head_logits
from imagenet_models_tpu_torch.nn.layers import grouped_weights
from imagenet_models_tpu_torch.train.losses import multi_head_loss
from imagenet_models_tpu_torch.train.optim import Optimizer, global_norm

_BN_STATS = ("running_mean", "running_var")


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    opt_state: Dict
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    ema_batch_stats: Optional[Dict[str, torch.Tensor]] = None

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return {k: b for k, b in self.model.named_buffers() if k.endswith(_BN_STATS)}


def create_train_state(model: torch.nn.Module, optimizer: Optimizer, ema_decay: float = 0.0,
                       device: Optional[torch.device | str] = None) -> TrainState:
    """Move `model` to `device` (the GPU when None) and make its optimizer
    state, and with `ema_decay` an EMA shadow of its parameters and BN
    running statistics (copies of the current values)."""
    model.to(resolve_device(device))
    state = TrainState(step=0, model=model, opt_state={})
    state.opt_state = optimizer.init(state.params(), grouped=grouped_weights(model))
    if ema_decay:
        state.ema_params = {k: p.detach().clone() for k, p in state.params().items()}
        state.ema_batch_stats = {k: b.detach().clone() for k, b in state.batch_stats().items()}
    return state


def make_train_step(model: torch.nn.Module, optimizer: Optimizer, base_loss: Callable,
                    dec_lam: float = 0.0, ema_decay: float = 0.0, grad_accum: int = 1,
                    token_distillation: bool = True, use_kernel: Optional[bool] = None):
    """The train step (state.py:103-221) for `model`, which the state must hold.

    Returns step(state, images, targets, generator=None) -> (state, metrics).
    The batch is split into `grad_accum` microbatches in order; each runs the
    training forward (the multi-head loss for a tuple of head outputs) and
    its backward, the gradients are averaged, the optimizer updates the
    parameters, then the EMA shadow moves to d*e + (1-d)*p. BatchNorm running
    statistics carry from one microbatch to the next. `generator` (on the
    images' device) draws the stochastic-depth masks; the head's dropouts
    draw from PyTorch's default generator of that device. metrics holds the
    mean microbatch "loss" and the "grad_norm" of the averaged gradients, as
    0-d tensors on the device. `use_kernel` is the model's kernel dispatch
    (the ConvNeXt blocks' LN+MLP, MaxViT's partition attention, GA-CSWin's
    stripe attention; None: the kernels for CUDA tensors, False: their plain
    twins).
    """

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
        optimizer.step(params, grads, state.opt_state)
        if ema_decay and state.ema_params is not None:
            d = ema_decay
            with torch.no_grad():
                for shadow, live in ((state.ema_params, params),
                                     (state.ema_batch_stats, state.batch_stats())):
                    ema = list(shadow.values())
                    torch._foreach_mul_(ema, d)
                    torch._foreach_add_(ema, [live[k] for k in shadow], alpha=1 - d)
        state.step += 1
        metrics = {"loss": torch.stack(losses).mean(), "grad_norm": global_norm(list(grads.values()))}
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
    the model untouched. tta > 1 also averages logits over groups of `tta`
    consecutive samples and strides the targets; the flags then have
    B // tta entries (the remainder is dropped)."""
    if use_ema and (state is None or state.ema_params is None):
        raise ValueError("use_ema needs a train state made with ema_decay")

    def forward(images):
        if not use_ema:
            return model(images, use_kernel=use_kernel)
        tensors = {**state.ema_params, **state.ema_batch_stats}
        return torch.func.functional_call(model, tensors, (images,),
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

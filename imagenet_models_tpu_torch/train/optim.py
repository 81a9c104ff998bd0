"""Optimizers with timm's semantics. Port of imagenet_models_tpu/train/optim.py.

The JAX package builds optax chains; the port has one class, `Optimizer`,
that runs the same chain over a model's named fp32 parameters and updates
them in place: an optional clip (global norm, value, or adaptive), then timm
LAMB, AdamW, Adam or SGD (Nesterov or plain momentum), then the learning rate
(a constant, or a schedule of the number of updates made so far). LAMB, the
main path's optimizer, runs as multi-tensor (`torch._foreach_*`) calls over
all parameters at once: a loop of per-parameter ops launched thousands of
small kernels per step and left the card idle for half of it.
"""

from __future__ import annotations

import math
from typing import Callable, Collection, Dict, Mapping, Optional, Sequence, Union

import torch

Schedule = Union[float, Callable[[int], float]]

# the reference parser's --opt-eps default is None: each optimizer's own
# default (timm Lamb 1e-6, torch AdamW/Adam 1e-8)
_OPT_DEFAULT_EPS = {"lamb": 1e-6, "adamw": 1e-8, "adam": 1e-8}
_NO_DECAY_NAMES = ("x_cls", "pos_embed", "relative_position_bias_table")
# timm Lamb's max_grad_norm: every LAMB gradient is pre-divided by
# max(1, global_norm / 1.0)
_LAMB_MAX_GRAD_NORM = 1.0


def wd_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """True where weight decay applies, by the port's parameter names:
    never on rank <= 1 leaves (biases, norm scales, layer-scale gammas), the
    learned tokens x_cls and pos_embed, or rel-pos bias tables (timm's
    no_weight_decay(); optim.py:20-42)."""
    return {name: p.dim() > 1 and name.rsplit(".", 1)[-1] not in _NO_DECAY_NAMES
            for name, p in params.items()}


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of fp32 tensors, as a 0-d
    tensor on their device (no host sync)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def _unitwise_norm(name: str, x: torch.Tensor, groups: Optional[int] = None) -> torch.Tensor:
    """optax.unitwise_norm of the JAX leaf that the torch leaf `name` holds,
    in torch layout, broadcast to x's shape. optax picks the units by the
    JAX rank: a vector (after squeeze) is one unit; a rank-2 or rank-3 leaf
    sums over axis 0; a rank-4 leaf over axes 0-2. So a Linear (O, I) weight
    (JAX (I, O)) sums each row; a conv (O, I, kh, kw) weight (JAX HWIO) each
    output filter; a grouped pointwise weight (O, I/g, 1, 1) (`groups` = g;
    JAX (g, I/g, O/g)) sums over its g groups; any other leaf has the JAX
    layout and takes optax's rule as it is."""
    if x.squeeze().dim() <= 1:
        return torch.sqrt(x.square().sum()).expand_as(x)
    if groups is not None:
        o, i = x.shape[:2]
        xg = x.reshape(groups, o // groups, i)
        return torch.sqrt(xg.square().sum(dim=0, keepdim=True)).expand_as(xg).reshape(x.shape)
    if name.endswith(".weight") and x.dim() in (2, 4):
        dims = tuple(range(1, x.dim()))
    elif x.dim() in (2, 3):
        dims = (0,)
    elif x.dim() == 4:
        dims = (0, 1, 2)
    else:
        raise ValueError(f"adaptive clipping takes leaves of rank 1-4, {name} is {tuple(x.shape)}")
    return torch.sqrt(x.square().sum(dim=dims, keepdim=True)).expand_as(x)


class Optimizer:
    """The update rule of `create_optimizer`, as one object.

    `init(params)` makes the state; `step(params, grads, state)` updates the
    parameters and the state in place (no grad), one optimizer update per
    call. `params` and `grads` are mappings of parameter name to tensor, in
    one order (`dict(model.named_parameters())`).

    Under ZeRO-1 a rank's state covers only the leaves it owns: `init` is
    given those, and `step(..., owned=names)` updates only those, while the
    clip and LAMB's global-norm divisor still read every gradient of `grads`
    (the full, reduced gradients, which every rank holds). With every leaf
    owned, the update is the one-process update, bit for bit.
    """

    def __init__(self, opt: str = "lamb", learning_rate: Schedule = 1e-3,
                 weight_decay: float = 0.0, eps: Optional[float] = None,
                 betas=(0.9, 0.999), momentum: float = 0.9, clip_grad: Optional[float] = None,
                 clip_mode: str = "norm"):
        opt = opt.lower()
        if opt not in ("lamb", "adamw", "adam", "sgd", "nesterov", "momentum"):
            raise ValueError(f"unknown optimizer {opt}")
        if clip_mode not in ("norm", "value", "agc"):
            raise ValueError(f"unknown clip mode {clip_mode}")
        self.opt = opt
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.eps = _OPT_DEFAULT_EPS.get(opt, 1e-8) if eps is None else eps
        self.b1, self.b2 = betas
        self.momentum = momentum
        self.clip_grad, self.clip_mode = clip_grad, clip_mode

    def init(self, params: Mapping[str, torch.Tensor],
             grouped: Optional[Mapping[str, int]] = None) -> Dict:
        """`grouped` names the grouped pointwise weights with their group
        count (`nn.layers.grouped_weights`): adaptive clipping takes their
        unit-wise norm in the JAX layout."""
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        # "count" drives the bias corrections, "schedule_count" the learning
        # rate schedule: optax keeps them in two states (set_schedule_count)
        state = {"count": 0, "schedule_count": 0, "grouped": dict(grouped or {})}
        if self.opt in ("lamb", "adamw", "adam"):
            state["mu"], state["nu"] = zeros(), zeros()
        else:
            state["trace"] = zeros()
        return state

    def _clip(self, params, grads, grouped):
        if self.clip_grad is None:
            return grads
        c = self.clip_grad
        if self.clip_mode == "norm":  # optax.clip_by_global_norm
            norm = global_norm(list(grads.values()))
            return {k: torch.where(norm < c, g, (g / norm) * c) for k, g in grads.items()}
        if self.clip_mode == "value":
            return {k: g.clamp(-c, c) for k, g in grads.items()}
        out = {}  # optax.adaptive_grad_clip(c, eps=1e-3), units of the JAX layout
        for k, g in grads.items():
            g_norm = _unitwise_norm(k, g, grouped.get(k))
            max_norm = c * torch.clamp(_unitwise_norm(k, params[k].float(), grouped.get(k)), min=1e-3)
            out[k] = torch.where(g_norm < max_norm, g, g * (max_norm / torch.clamp(g_norm, min=1e-6)))
        return out

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
             state: Dict, owned: Optional[Collection[str]] = None) -> None:
        grads = self._clip(params, {k: g.float() for k, g in grads.items()},
                           state["grouped"])
        names = list(params) if owned is None else [k for k in params if k in owned]
        lr = self.learning_rate
        if callable(lr):
            lr = lr(state["schedule_count"])
        state["count"] += 1
        state["schedule_count"] += 1
        t = state["count"]
        decay = wd_mask(params)
        wd = self.weight_decay
        if self.opt == "lamb":
            self._lamb(params, grads, state, decay, lr, t, names)
            return
        for k in names:
            p, g = params[k], grads[k]
            if self.opt in ("adamw", "adam"):  # optax.scale_by_adam (+ add_decayed_weights)
                mu = state["mu"][k].mul_(self.b1).add_((1 - self.b1) * g)
                nu = state["nu"][k].mul_(self.b2).add_((1 - self.b2) * g.square())
                upd = (mu / (1 - self.b1 ** t)) / (torch.sqrt(nu / (1 - self.b2 ** t)) + self.eps)
                if self.opt == "adamw" and decay[k]:
                    upd = upd + wd * p.float()
            else:  # add_decayed_weights, then optax.trace (Nesterov unless "momentum")
                if decay[k]:
                    g = g + wd * p.float()
                tr = state["trace"][k].mul_(self.momentum).add_(g)
                upd = g + self.momentum * tr if self.opt != "momentum" else tr
            p.sub_((lr * upd).to(p.dtype))

    def _lamb(self, params, grads, state, decay, lr, t, names) -> None:
        """timm 0.9.2 Lamb (optim.py:79-144), which optax.lamb is not:
        gradients pre-divided by max(1, global_norm / 1.0); eps outside the
        bias-corrected sqrt; the trust ratio only on decayed leaves. The
        leaves of `names` are updated; the global norm is over all grads."""
        ps = [params[k] for k in names]
        mus = [state["mu"][k] for k in names]
        nus = [state["nu"][k] for k in names]
        gs = [grads[k] for k in names]
        clip = torch.clamp(global_norm(list(grads.values())) / _LAMB_MAX_GRAD_NORM, min=1.0)
        gs = torch._foreach_div(gs, clip)
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, gs, alpha=1.0 - self.b1)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_addcmul_(nus, gs, gs, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(nus)
        torch._foreach_div_(denom, math.sqrt(1.0 - self.b2 ** t))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mus, 1.0 - self.b1 ** t)
        torch._foreach_div_(upd, denom)
        adapt = [i for i, k in enumerate(names) if decay[k]] if self.weight_decay else []
        if adapt:
            dp = [ps[i] for i in adapt]
            du = [upd[i] for i in adapt]
            torch._foreach_add_(du, dp, alpha=self.weight_decay)
            w = torch.stack(torch._foreach_norm(dp))
            u = torch.stack(torch._foreach_norm(du))
            trust = torch.where((w > 0) & (u > 0), w / u, torch.ones_like(w))
            torch._foreach_mul_(du, list(trust.unbind()))
        torch._foreach_add_(ps, upd, alpha=-lr)


def set_schedule_count(opt_state: Dict, count: int) -> Dict:
    """Point the learning rate schedule's step count at `count` steps
    (optim.py:42-59), in place, and return the state.

    timm steps its LR scheduler by epoch, apart from the optimizer, so an
    optimizer state that is rebuilt (--no-resume-opt) or resumed at another
    epoch (--start-epoch, a mid-epoch recovery snapshot) must have the
    schedule re-pointed, or the warmup and cosine would rewind while the logs
    show the epoch's LR. The bias-correction count ("count") is left as it
    is, as with a fresh torch optimizer."""
    opt_state["schedule_count"] = int(count)
    return opt_state


def create_optimizer(opt: str = "lamb", learning_rate: Schedule = 1e-3, weight_decay: float = 0.0,
                     eps: Optional[float] = None, betas=(0.9, 0.999), momentum: float = 0.9,
                     clip_grad: Optional[float] = None, clip_mode: str = "norm") -> Optimizer:
    """timm create_optimizer_v2's choices (optim.py:170-207): "lamb" (timm
    Lamb), "adamw", "adam", "sgd"/"nesterov" (Nesterov SGD), "momentum"
    (plain momentum SGD); weight decay masked by `wd_mask`; `clip_grad` clips
    before the optimizer by global norm, value, or adaptively ("agc")."""
    return Optimizer(opt, learning_rate, weight_decay, eps, betas, momentum, clip_grad, clip_mode)

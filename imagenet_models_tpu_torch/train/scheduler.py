"""LR schedules with timm semantics. Port of imagenet_models_tpu/train/scheduler.py.

timm's CosineLRScheduler: linear warmup from warmup_lr over warmup_epochs,
then cosine over the whole t_initial horizon (warmup_prefix=False), with
restarts (cycle_mul, cycle_decay, cycle_limit), k-decay, and bounded
per-epoch noise; and a step schedule. A schedule is a function of the
(possibly fractional) epoch that returns the learning rate as a float.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np


def lr_noise_table(total_epochs: int, noise_range: Optional[Sequence[float]],
                   noise_pct: float = 0.67, noise_std: float = 1.0,
                   seed: int = 42) -> Optional[np.ndarray]:
    """Per-epoch multiplicative noise factors (timm Scheduler._add_noise:
    lr <- lr + lr*noise inside the noise range): a bounded normal per epoch
    from a NumPy generator seeded with seed + epoch. noise_range is in
    epochs: a start (open-ended) or [start, end)."""
    if not noise_range:
        return None
    lo = float(noise_range[0])
    hi = float(noise_range[1]) if len(noise_range) > 1 else float("inf")
    table = np.zeros(max(total_epochs, 1), np.float32)
    for t in range(len(table)):
        if lo <= t < hi:
            rng = np.random.default_rng(seed + t)
            while True:  # timm's rejection loop
                n = float(rng.standard_normal()) * noise_std
                if abs(n) < noise_pct:
                    table[t] = n
                    break
    return table


def cosine_schedule(base_lr: float, epochs: int, warmup_epochs: float = 5,
                    warmup_lr: float = 1e-6, min_lr: float = 1e-5,
                    cooldown_epochs: int = 0, cycle_mul: float = 1.0,
                    cycle_decay: float = 1.0, cycle_limit: int = 1,
                    k_decay: float = 1.0,
                    noise_table: Optional[np.ndarray] = None) -> Callable[[float], float]:
    """timm CosineLRScheduler. With one cycle, epochs past the horizon hold
    min_lr: that is the cooldown tail."""

    def lr_at(epoch: float) -> float:
        e = float(epoch)
        if e < warmup_epochs:
            lr = warmup_lr + (base_lr - warmup_lr) * e / max(warmup_epochs, 1e-8)
        else:
            if cycle_mul == 1.0:
                i = math.floor(e / epochs)
                t_curr = e - i * epochs
                t_i = float(epochs)
            else:
                arg = max(1.0 - e / epochs * (1.0 - cycle_mul), 1e-8)
                i = math.floor(math.log(arg) / math.log(cycle_mul))
                t_curr = e - epochs * (cycle_mul ** i - 1.0) / (cycle_mul - 1.0)
                t_i = epochs * cycle_mul ** i
            if i < cycle_limit:
                lr_max = base_lr * cycle_decay ** i
                frac = (t_curr ** k_decay) / (t_i ** k_decay)
                lr = min_lr + 0.5 * (lr_max - min_lr) * (1 + math.cos(math.pi * frac))
            else:
                lr = min_lr
        if noise_table is not None:
            idx = min(max(int(epoch), 0), len(noise_table) - 1)
            lr = lr * (1.0 + float(noise_table[idx]))
        return lr

    return lr_at


def step_schedule(base_lr: float, decay_epochs: int = 30, decay_rate: float = 0.1,
                  warmup_epochs: float = 0, warmup_lr: float = 1e-6) -> Callable[[float], float]:
    def lr_at(epoch: float) -> float:
        e = float(epoch)
        if e < warmup_epochs:
            return warmup_lr + (base_lr - warmup_lr) * e / max(warmup_epochs, 1e-8)
        return base_lr * decay_rate ** (e // decay_epochs)

    return lr_at


def create_scheduler(sched: str = "cosine", **kwargs) -> Callable[[float], float]:
    if sched == "cosine":
        kwargs.pop("decay_epochs", None), kwargs.pop("decay_rate", None)
        return cosine_schedule(**kwargs)
    if sched == "step":
        for k in ("epochs", "min_lr", "cooldown_epochs", "cycle_mul",
                  "cycle_decay", "cycle_limit", "k_decay", "noise_table"):
            kwargs.pop(k, None)
        return step_schedule(**kwargs)
    raise ValueError(f"unknown scheduler {sched} (cosine/step; timm's plateau scheduler "
                     "is metric-driven and not supported)")

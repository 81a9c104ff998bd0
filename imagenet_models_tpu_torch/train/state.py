"""Eval step. Port of `make_eval_step` in imagenet_models_tpu/train/state.py
(:265-304); the train step comes with the next slice."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from imagenet_models_tpu_torch.nn.heads import average_head_logits


def make_eval_step(model: torch.nn.Module, tta: int = 0,
                   use_kernel: Optional[bool] = None
                   ) -> Callable[[torch.Tensor, torch.Tensor],
                                 Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Eval step: forward, average the multi-head logits, return (logits,
    top-1 flags, top-5 flags) per example, flags as fp32 0/1.

    tta > 1 also averages logits over groups of `tta` consecutive samples and
    strides the targets; the flags then have B // tta entries (the remainder
    is dropped)."""
    model.eval()

    def step(images: torch.Tensor, targets: torch.Tensor):
        with torch.inference_mode():
            logits = average_head_logits(model(images, use_kernel=use_kernel))
            if tta and tta > 1:
                g = logits.shape[0] // tta
                logits = logits[: g * tta].reshape(g, tta, -1).mean(dim=1)
                targets = targets[: g * tta: tta]
            top5 = torch.topk(logits, 5, dim=-1).indices
            correct1 = (top5[:, 0] == targets).float()
            correct5 = (top5 == targets[:, None]).any(dim=1).float()
        return logits, correct1, correct5

    return step

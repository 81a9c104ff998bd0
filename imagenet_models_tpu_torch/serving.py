"""Serving forward: uint8 NHWC images -> fp32 head-averaged logits.

Port of imagenet_models_tpu/serving.py:32-45 (`make_serving_fn`). The JAX
package also freezes this function with `jax.export`; the port's
counterpart (`torch.export`) comes later.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from imagenet_models_tpu_torch.core.registry import IMAGENET_MEAN, IMAGENET_STD
from imagenet_models_tpu_torch.nn.heads import average_head_logits


def make_serving_fn(model: torch.nn.Module, mean: Sequence[float] = IMAGENET_MEAN,
                    std: Sequence[float] = IMAGENET_STD,
                    use_kernel: Optional[bool] = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """Eval forward over a uint8 (B, H, W, 3) batch -> fp32 (B, num_classes).

    Input contract: images already resized and center-cropped to the model's
    eval geometry on the host; `(x/255 - mean)/std` happens here.
    """
    model.eval()

    def fn(images_u8: torch.Tensor) -> torch.Tensor:
        if images_u8.dtype != torch.uint8 or images_u8.dim() != 4:
            raise ValueError(f"expected uint8 NHWC images, got {images_u8.dtype} "
                             f"{tuple(images_u8.shape)}")
        m = torch.tensor(mean, dtype=torch.float32, device=images_u8.device)
        s = torch.tensor(std, dtype=torch.float32, device=images_u8.device)
        with torch.inference_mode():
            x = (images_u8.float() / 255.0 - m) / s
            return average_head_logits(model(x, use_kernel=use_kernel))

    return fn

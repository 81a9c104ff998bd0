"""Pieces of the GA head library that other families share. Port of the parts
of imagenet_models_tpu/nn/ga_head.py that MaxViT's MBConv uses: the
squeeze-and-excitation module and `make_divisible`. The GA head itself
(ClassAttn, LayerScaleBlockClassAttn, Bottleneck) comes with GA-ConvNeXt.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from imagenet_models_tpu_torch.nn.layers import conv2d_nhwc, relu


class SEModule(nn.Module):
    """timm SEModule on NHWC input: global mean, 1x1 conv to `rd_channels`,
    `act`, 1x1 conv back, sigmoid gate (nn/ga_head.py:104-121). MaxViT's
    MBConv passes SiLU as `act`."""

    def __init__(self, channels: int, rd_channels: int, act: Callable = relu,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, rd_channels, 1)
        self.fc2 = nn.Conv2d(rd_channels, channels, 1)
        self.act = act
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        s = x.mean(dim=(1, 2), keepdim=True)
        s = self.act(conv2d_nhwc(s, self.fc1.weight, self.fc1.bias, dtype=dt))
        s = conv2d_nhwc(s, self.fc2.weight, self.fc2.bias, dtype=dt)
        return x * torch.sigmoid(s)


def make_divisible(v: int, divisor: int = 8, min_value: Optional[int] = None) -> int:
    """timm make_divisible (nn/ga_head.py:124-129)."""
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v

"""Common NN building blocks on channels-last (NHWC) tensors.

Port of imagenet_models_tpu/nn/layers.py, the parts the eval path uses.
Parameters keep the reference's torch layouts (Conv2d (O, I/g, kh, kw),
Linear (O, I)), so a state_dict exported from the JAX package loads with
`strict=True`. Activations stay NHWC as in the JAX package: a contiguous
(B, H, W, C) tensor viewed as (B, C, H, W) is `channels_last`, which is what
`F.conv2d` is given.

Compute-dtype policy (the JAX `dtype=` attribute): parameters are fp32 and are
cast to `dtype` at use. With `dtype=None` a layer computes in the promotion of
its input and parameter dtypes, as flax does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU (torch nn.GELU's default; nn/layers.py:27)."""
    return F.gelu(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def _promote(x: torch.Tensor, p: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype or torch.promote_types(x.dtype, p.dtype)


def trunc_normal_(t: torch.Tensor, std: float = 0.02,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """timm trunc_normal_(std=.02), cut at +-2 (nn/layers.py:64)."""
    return nn.init.trunc_normal_(t, std=std, a=-2.0, b=2.0, generator=generator)


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                stride: int = 1, padding="same", groups: int = 1,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax nn.Conv on NHWC `x` with a torch-layout (O, I/g, kh, kw) weight.

    `padding="same"` is flax's default SAME rule (low side gets the smaller
    half); an int pads symmetrically. The NCHW view handed to cuDNN is
    channels_last, so the result permutes back to a contiguous NHWC tensor.
    """
    dt = _promote(x, weight, dtype)
    xn = x.to(dt).permute(0, 3, 1, 2)
    if padding == "same":
        kh, kw = weight.shape[-2:]
        pads = []
        for size, k in ((xn.shape[3], kw), (xn.shape[2], kh)):
            total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            xn = F.pad(xn, pads)
        padding = 0
    y = F.conv2d(xn, weight.to(dt), None if bias is None else bias.to(dt),
                 stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


class Dense(nn.Linear):
    """nn.Linear computing in `dtype` (flax nn.Dense's dtype semantics)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promote(x, self.weight, self.compute_dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing (channel) axis, eps 1e-6, fp32 statistics.

    flax nn.LayerNorm semantics: statistics and the affine in fp32, then a
    cast to `dtype` (or to the promotion of the input with fp32 when None).
    """

    def __init__(self, dim: int, eps: float = 1e-6, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.compute_dtype or torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(out)


class BatchNorm(nn.Module):
    """BatchNorm over every axis but the last, eval mode (running statistics).

    Matches nn/layers.py:BatchNorm's eval branch (:184-185, :244-247): eps
    1e-5, `(x - mean) * rsqrt(var + eps) * scale + bias` in fp32, then a cast
    to `dtype` (or the input dtype). The parameter and buffer names are torch
    BatchNorm's; `num_batches_tracked` is not kept, as the JAX export has no
    such leaf. Train-mode statistics come with the train-step port.
    """

    def __init__(self, dim: int, eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("train-mode BatchNorm is not ported yet; call .eval()")
        inv = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        y = (x.float() - self.running_mean.float()) * inv + self.bias.float()
        return y.to(self.compute_dtype or x.dtype)


class DropPath(nn.Module):
    """Stochastic depth: identity at eval (nn/layers.py:DropPath)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.rate > 0.0:
            raise NotImplementedError("train-mode DropPath is not ported yet; call .eval()")
        return x


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Channel shuffle on the trailing axis (nn/layers.py:273-284)."""
    *lead, c = x.shape
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    return x.reshape(*lead, c // groups, groups).transpose(-1, -2).reshape(*lead, c)


class GroupedDense(nn.Module):
    """Grouped pointwise projection == torch grouped 1x1 Conv2d.

    The parameter keeps the torch grouped-conv layout (O, I/g, 1, 1)
    (nn/layers.py:287-315 holds it as (g, I/g, O/g)); input (..., I), group g
    of the input maps to group g of the output.
    """

    def __init__(self, in_features: int, features: int, groups: int = 1,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if in_features % groups or features % groups:
            raise ValueError(f"({in_features}, {features}) do not split into {groups} groups")
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(features, in_features // groups, 1, 1))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.groups
        out_f, in_g = self.weight.shape[:2]
        dt = self.compute_dtype or x.dtype
        lead = x.shape[:-1]
        xg = x.to(dt).reshape(*lead, g, in_g)
        w = self.weight.to(dt).reshape(g, out_f // g, in_g)
        y = torch.einsum("...gi,goi->...go", xg, w).reshape(*lead, out_f)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class GroupConvMlp(nn.Module):
    """Grouped MLP with a channel shuffle between the layers (nn/layers.py:318-344)."""

    def __init__(self, in_features: int, hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None, act: Callable = relu,
                 groups: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        hidden = hidden_features or in_features
        out = out_features or in_features
        self.fc1 = GroupedDense(in_features, hidden, groups=groups, dtype=dtype)
        self.fc2 = GroupedDense(hidden, out, groups=groups, dtype=dtype)
        self.act = act
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.fc1(x))
        return self.fc2(channel_shuffle(x, self.groups))


class ConvNormAct(nn.Sequential):
    """Conv (no bias) + BatchNorm + activation; torch keys `.0` conv, `.1` bn
    (nn/layers.py:347-380)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 act: Optional[Callable] = relu, dtype: Optional[torch.dtype] = None):
        super().__init__(
            nn.Conv2d(in_features, features, kernel_size, stride=stride,
                      padding=padding, groups=groups, bias=False),
            BatchNorm(features, dtype=dtype))
        self.act = act
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self[0]
        x = conv2d_nhwc(x, conv.weight, None, stride=conv.stride[0],
                        padding=conv.padding[0], groups=conv.groups,
                        dtype=self.compute_dtype)
        x = self[1](x)
        return x if self.act is None else self.act(x)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """F.adaptive_avg_pool2d on NHWC (nn/layers.py:402-429)."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    return F.adaptive_avg_pool2d(_nchw(x), tuple(out_hw)).permute(0, 2, 3, 1)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize, half-pixel centers, no antialias (nn/layers.py:432-440)."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    y = F.interpolate(_nchw(x), size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def scale_features(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """MultiScale resize rule (nn/layers.py:443-456): features smaller than
    the target are upsampled by adaptive-avg duplication, larger ones are
    downsampled bilinearly. Load-bearing for checkpoint parity."""
    h = x.shape[1]
    if h < out_hw[0]:
        return adaptive_avg_pool(x, out_hw)
    if h > out_hw[0]:
        return resize_bilinear(x, out_hw)
    return x


def init_weights_(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """The JAX package's init scheme: trunc-normal(0.02) for every conv and
    dense kernel, zeros for biases, ones for norm scales, BN running mean 0 and
    var 1. Modules are visited in registration order, so a seeded generator
    gives the same weights on every machine."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear, GroupedDense)):
                trunc_normal_(m.weight, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (LayerNorm, BatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, BatchNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)

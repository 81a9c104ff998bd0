"""GA (Gramian Attention) head pieces. Port of imagenet_models_tpu/nn/ga_head.py:
the class attention with layer scale that each GA branch ends in
(`ClassAttn`, `LayerScaleBlockClassAttn`), the squeeze-and-excitation module
and `make_divisible` (MaxViT's MBConv uses them too), and `Bottleneck`, the
SE bottleneck of GA-ConvNeXt's stage 5 and of GA-CSWin's
`stage5="bottleneck"`. Inputs are channels-last; parameter names are the
reference's torch ones.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from imagenet_models_tpu_torch.nn.layers import (
    BatchNorm,
    Dense,
    DropPath,
    GroupConvMlp,
    LayerNorm,
    conv2d_nhwc,
    gelu,
    relu,
)


class ClassAttn(nn.Module):
    """Single-query class attention (nn/ga_head.py:34-65): q from token 0
    only, k and v over all tokens, `dim_embed` wide, projected back to `dim`."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, dim_embed: int = 128,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads, self.dim_embed = num_heads, dim_embed
        self.q = Dense(dim, dim_embed, bias=qkv_bias, dtype=dtype)
        self.k = Dense(dim, dim_embed, bias=qkv_bias, dtype=dtype)
        self.v = Dense(dim, dim_embed, bias=qkv_bias, dtype=dtype)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj = Dense(dim_embed, dim, dtype=dtype)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        e, h = self.dim_embed, self.num_heads
        d = e // h
        q = self.q(x[:, 0]).reshape(b, 1, h, d).transpose(1, 2)
        q = q * torch.tensor(d ** -0.5, dtype=q.dtype, device=q.device)
        k = self.k(x).reshape(b, n, h, d).transpose(1, 2)
        v = self.v(x).reshape(b, n, h, d).transpose(1, 2)
        attn = torch.matmul(q, k.transpose(-1, -2))
        attn = torch.softmax(attn.float(), dim=-1).to(attn.dtype)
        out = torch.matmul(self.attn_drop(attn), v).transpose(1, 2).reshape(b, 1, e)
        return self.proj_drop(self.proj(out))


class LayerScaleBlockClassAttn(nn.Module):
    """Class-attention block with layer scale (nn/ga_head.py:68-101): the
    class token attends over [class token, image tokens], then a grouped MLP,
    each pre-norm with a residual scaled by gamma (init 1e-4)."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, mlp_block_groups: int = 2, init_values: float = 1e-4,
                 dim_embed: int = 128, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
        self.gamma_2 = nn.Parameter(torch.full((dim,), init_values))
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = ClassAttn(dim, num_heads=num_heads, qkv_bias=qkv_bias, attn_drop=attn_drop,
                              proj_drop=drop, dim_embed=dim_embed, dtype=dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = GroupConvMlp(dim, int(dim * mlp_ratio), act=gelu, drop=drop,
                                groups=mlp_block_groups, dtype=dtype)

    def forward(self, x: torch.Tensor, x_cls: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a = self.attn(self.norm1(torch.cat([x_cls, x], dim=1)))
        x_cls = x_cls + self.drop_path(self.gamma_1.to(a.dtype) * a, generator)
        m = self.mlp(self.norm2(x_cls))
        return x_cls + self.drop_path(self.gamma_2.to(m.dtype) * m, generator)


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


class Bottleneck(nn.Module):
    """The ResNet-style SE bottleneck of the GA stage 5 (nn/ga_head.py:132-163):
    an unconditional 1x1 conv (with bias) + BatchNorm shortcut; 1x1, 3x3 and
    1x1 convs without bias, each with a BatchNorm, ReLU after the first two;
    `SEModule(make_divisible(planes // 4))` before the third; drop path on
    the branch; a ReLU join. Torch keys `conv1`, `bn1`, ..., `se.fc1`,
    `downsample.0` and `downsample.1`. Every BatchNorm takes `use_kernel`
    (kernels 7 and 8 in training with IMTPU_PALLAS_BN on)."""

    def __init__(self, inplanes: int, planes: int, outplanes: int, drop_path: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes, dtype=dtype)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.se = SEModule(planes, make_divisible(planes // 4), dtype=dtype)
        self.conv3 = nn.Conv2d(planes, outplanes, 1, bias=False)
        self.bn3 = BatchNorm(outplanes, dtype=dtype)
        self.downsample = nn.Sequential(nn.Conv2d(inplanes, outplanes, 1),
                                        BatchNorm(outplanes, dtype=dtype))
        self.drop_path = DropPath(drop_path)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.compute_dtype
        conv, bn = self.downsample
        shortcut = bn(conv2d_nhwc(x, conv.weight, conv.bias, dtype=dt), use_kernel=use_kernel)
        h = relu(self.bn1(conv2d_nhwc(x, self.conv1.weight, None, dtype=dt), use_kernel=use_kernel))
        h = relu(self.bn2(conv2d_nhwc(h, self.conv2.weight, None, padding=1, dtype=dt),
                          use_kernel=use_kernel))
        h = self.se(h)
        h = self.bn3(conv2d_nhwc(h, self.conv3.weight, None, dtype=dt), use_kernel=use_kernel)
        return relu(self.drop_path(h, generator) + shortcut)

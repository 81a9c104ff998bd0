"""ConvNeXt backbone + MAP head. Port of imagenet_models_tpu/models/convnext.py.

Attribute names and parameter shapes are the reference's torch ones
(`downsample_layers.0.0`, `stages.0.0.pwconv1.weight` as (4C, C),
`head.mmcap.mmcap.0...`), so the state_dict from `ckpt.convert` loads with
`strict=True`. The public forward takes NHWC float input, as the JAX model
does, and keeps NHWC tokens inside: the depthwise conv sees a channels_last
view and the LN+MLP kernel sees (N, C) rows, with no copies between.

Compute dtype: fp32 parameters cast to `dtype` at use (the JAX `dtype=`
attribute); the residual stream keeps the compute dtype.

Modes: a built model is in eval mode, as the JAX forward's default
`training=False`; `model.train()` gives JAX's `training=True` forward (the
kernels' fast GELU, stochastic depth, and the head's training behaviour).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from imagenet_models_tpu_torch.core.registry import register_default_cfg, register_model
from imagenet_models_tpu_torch.nn.heads import MAPHead
from imagenet_models_tpu_torch.nn.layers import (
    Dense,
    DropPath,
    LayerNorm,
    conv2d_nhwc,
    dropout,
    gelu,
    init_weights_,
)
from imagenet_models_tpu_torch.ops.convnext_block import convnext_block_apply


class ConvNeXtBlock(nn.Module):
    """dw7x7 conv -> LN -> Linear(4C) -> GELU -> Linear(C) -> layer-scale ->
    drop-path + residual (models/convnext.py:45-85)."""

    def __init__(self, dim: int, drop_path: float = 0.0, ls_init_value: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), float(ls_init_value)))
                      if ls_init_value > 0 else None)
        self.drop_path = DropPath(drop_path)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        xc = x if self.compute_dtype is None else x.to(self.compute_dtype)
        branch = convnext_block_apply(
            xc, self.dwconv.weight, self.dwconv.bias, self.norm.weight, self.norm.bias,
            self.pwconv1.weight, self.pwconv1.bias, self.pwconv2.weight, self.pwconv2.bias,
            self.gamma, eps=self.norm.eps, use_kernel=use_kernel, training=self.training)
        return x + self.drop_path(branch, generator).to(x.dtype)


class ConvNeXt(nn.Module):
    """ConvNeXt with optional MAP head (models/convnext.py:88-158)."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), num_classes: int = 1000,
                 drop_path_rate: float = 0.0, ls_init_value: float = 1e-6,
                 head_init_scale: float = 1.0, global_pool: str = "avg",
                 last_dim: int = 384, n_groups: int = 4, n_tokens: int = 3,
                 gram_group: int = 8, bp_dim: int = 192, bp_groups: int = 1,
                 gram_dim: Optional[int] = None, ca_dim: int = 128, num_heads: int = 8,
                 gram: bool = True, split_norm: bool = False, self_distill_token: bool = True,
                 distill_tokens: int = 0, drop_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.global_pool = global_pool
        # the avg head's dropout in training (models/convnext.py:152); the
        # mmcap head ignores it, as JAX's passes fc_drop=0.0 (:143)
        self.drop_rate = drop_rate
        self.compute_dtype = dtype
        self.downsample_layers = nn.ModuleList()
        self.downsample_layers.append(nn.Sequential(
            nn.Conv2d(in_chans, dims[0], 4, stride=4), LayerNorm(dims[0], dtype=dtype)))
        for i in range(1, 4):
            self.downsample_layers.append(nn.Sequential(
                LayerNorm(dims[i - 1], dtype=dtype), nn.Conv2d(dims[i - 1], dims[i], 2, stride=2)))
        dp_rates = np.linspace(0, drop_path_rate, sum(depths))
        self.stages = nn.ModuleList()
        cur = 0
        for i in range(4):
            self.stages.append(nn.ModuleList(
                ConvNeXtBlock(dims[i], drop_path=float(dp_rates[cur + j]),
                              ls_init_value=ls_init_value, dtype=dtype)
                for j in range(depths[i])))
            cur += depths[i]
        if global_pool == "mmcap":
            self.head = MAPHead(
                multi_scale_level=3, channels=[dims[0]] + list(dims), last_dim=last_dim,
                n_tokens=n_tokens, n_groups=n_groups, self_distill_token=self_distill_token,
                distill_tokens=distill_tokens, mlp_ratio=4, mlp_groups=2,
                head_fn="split_norm" if split_norm else "norm",
                num_classes=num_classes, non_linearity=gelu, gram=gram, bp_dim=bp_dim,
                bp_groups=bp_groups, gram_group=gram_group, gram_dim=gram_dim,
                ca_dim=ca_dim, num_heads=num_heads, dtype=dtype)
        elif global_pool == "avg":
            self.norm = LayerNorm(dims[-1], dtype=dtype)
            self.head = Dense(dims[-1], num_classes, dtype=dtype)
        else:
            raise ValueError(f"unknown global_pool {global_pool!r}")
        init_weights_(self, generator)
        if global_pool == "avg" and head_init_scale != 1.0:
            with torch.no_grad():
                self.head.weight.mul_(head_init_scale)
                self.head.bias.mul_(head_init_scale)
        self.eval()

    def forward(self, x: torch.Tensor, pre_logits: bool = False,
                use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None):
        """x: NHWC float images. Eval output: a tuple of per-group logits for
        the mmcap head, a logits tensor for the avg head; in training the
        mmcap head gives (org, avg) pairs. `generator` (on x's device) draws
        the stochastic-depth masks and the avg head's dropout mask."""
        dt = self.compute_dtype
        features = []
        for i, (ds, stage) in enumerate(zip(self.downsample_layers, self.stages)):
            if i == 0:
                conv, norm = ds
                x = norm(conv2d_nhwc(x, conv.weight, conv.bias, stride=4, dtype=dt))
                features.append(x)
            else:
                norm, conv = ds
                x = conv2d_nhwc(norm(x), conv.weight, conv.bias, stride=2, dtype=dt)
            for blk in stage:
                x = blk(x, use_kernel=use_kernel, generator=generator)
            features.append(x)
        if self.global_pool == "mmcap":
            return self.head(features, pre_logits=pre_logits, use_kernel=use_kernel)
        x = self.norm(x.mean(dim=(1, 2)))
        if self.training:
            x = dropout(x, self.drop_rate, generator)
        return self.head(x)


def _convnext(**kwargs) -> ConvNeXt:
    kwargs.pop("in_22k", None)
    return ConvNeXt(**kwargs)


@register_model
def convnext_tiny(**kwargs):
    return _convnext(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), **kwargs)


@register_model
def convnext_small(**kwargs):
    return _convnext(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768), **kwargs)


@register_model
def map_convnext_tiny(**kwargs):
    return _convnext(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), global_pool="mmcap",
                     last_dim=384, n_groups=4, n_tokens=2, gram_group=24, bp_dim=384,
                     ca_dim=384, num_heads=12, **kwargs)


@register_model
def map_convnext_small(**kwargs):
    return _convnext(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768), global_pool="mmcap",
                     last_dim=384, n_groups=4, n_tokens=3, gram_group=16, bp_dim=384,
                     ca_dim=384, num_heads=12, **kwargs)


for _n in ("convnext_tiny", "convnext_small", "map_convnext_tiny", "map_convnext_small"):
    register_default_cfg(_n, {"crop_pct": 0.875, "interpolation": "bicubic"})

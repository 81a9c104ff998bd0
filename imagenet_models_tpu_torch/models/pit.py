"""PiT (Pooling-based Vision Transformer) with the GAP or MAP head. Port of
imagenet_models_tpu/models/pit.py.

A 16x16 stride-8 conv patch embed (a 27x27 map at 224 px) plus a learned
position embedding, three transformer stages (`nn.vit.ViTBlock`) with a
depthwise stride-2 conv pooling between them, and the pyramid [embed, s1,
s2, s3] into `MAPHead` at `multi_scale_level=2` with `head_fn="norm"`
(models/pit.py:27-106). Attribute names are the reference's torch ones
(`patch_embed.conv`, `pos_embed` as (1, C, H, W), `transformers.0.blocks.0.
attn.qkv`, `pools.0.conv`, `head.mmcap...`), so the state_dict from
`ckpt.convert` loads with `strict=True`. Everything is NHWC end to end.

With IMTPU_TLNMLP at "1" each block's norm2 + MLP pair is kernels 1 and 2
on the card (C = 144, 288 and 576). The position embedding fixes the input
size: a model runs at `img_size` only.

Modes: a built model is in eval mode, as the JAX forward's default
`training=False`; `model.train()` gives JAX's `training=True` forward.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from imagenet_models_tpu_torch.core.registry import register_default_cfg, register_model
from imagenet_models_tpu_torch.nn.heads import MAPHead
from imagenet_models_tpu_torch.nn.layers import (
    Dense,
    conv2d_nhwc,
    gelu,
    init_weights_,
    trunc_normal_,
)
from imagenet_models_tpu_torch.nn.vit import ViTBlock


class ConvEmbed(nn.Module):
    """The patch embed: one conv with bias, VALID padding."""

    def __init__(self, in_chans: int, dim: int, patch_size: int, stride: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = nn.Conv2d(in_chans, dim, patch_size, stride=stride)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x, self.conv.weight, self.conv.bias, stride=self.conv.stride[0],
                           padding=0, dtype=self.compute_dtype)


class ConvHeadPooling(nn.Module):
    """A depthwise 3x3 stride-2 conv with bias (pad 1) that doubles the
    channels (pit.py:81-85)."""

    def __init__(self, dim: int, out_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = nn.Conv2d(dim, out_dim, 3, stride=2, padding=1, groups=dim)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x, self.conv.weight, self.conv.bias, stride=2, padding=1,
                           groups=self.conv.groups, dtype=self.compute_dtype)


class Transformer(nn.Module):
    def __init__(self, blocks: Sequence[ViTBlock]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class PoolingTransformer(nn.Module):
    """models/pit.py:27-106. The JAX module's dropout after the position
    embedding is left out: both factories drop `drop_rate`, so it is 0."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, stride: int = 8,
                 base_dims: Sequence[int] = (48, 48, 48), depth: Sequence[int] = (2, 6, 4),
                 heads: Sequence[int] = (3, 6, 12), mlp_ratio: float = 4.0,
                 num_classes: int = 1000, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, pool_type: str = "gap", last_dim: int = 384,
                 n_groups: int = 4, n_tokens: int = 3, gram_group: int = 24,
                 self_distill_token: bool = True, gram: bool = True, multi_scale_level: int = 2,
                 dtype: Optional[torch.dtype] = None, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width = math.floor((img_size - patch_size) / stride + 1)
        self.img_size, self.pool_type = img_size, pool_type
        dims = [b * h for b, h in zip(base_dims, heads)]
        self.patch_embed = ConvEmbed(in_chans, dims[0], patch_size, stride, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, dims[0], width, width))
        total, idx = sum(depth), 0
        self.transformers = nn.ModuleList()
        self.pools = nn.ModuleList()
        for s, (dim, n) in enumerate(zip(dims, depth)):
            self.transformers.append(Transformer(
                ViTBlock(dim, heads[s], mlp_ratio=mlp_ratio, qkv_bias=True,
                         attn_drop=attn_drop_rate, drop_path=drop_path_rate * (idx + i) / total,
                         dtype=dtype)
                for i in range(n)))
            idx += n
            if s < len(depth) - 1:
                self.pools.append(ConvHeadPooling(dim, dims[s + 1], dtype=dtype))
        if pool_type == "map":
            self.head = MAPHead(
                multi_scale_level=multi_scale_level, channels=[dims[0]] + dims,
                last_dim=last_dim, n_tokens=n_tokens, n_groups=n_groups,
                self_distill_token=self_distill_token, mlp_ratio=4, mlp_groups=2,
                head_fn="norm", fc_drop=0.0, num_classes=num_classes, non_linearity=gelu,
                gram=gram, bp_dim=last_dim, bp_groups=1, gram_group=gram_group,
                gram_dim=last_dim, ca_dim=192, num_heads=12, dtype=dtype)
        else:
            self.head = Dense(dims[-1], num_classes, dtype=dtype)
        init_weights_(self, generator)
        with torch.no_grad():
            trunc_normal_(self.pos_embed, generator=generator)
        self.eval()

    def forward(self, x: torch.Tensor, pre_logits: bool = False,
                use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None):
        """x: NHWC float images of `img_size`. Eval output: a tuple of
        per-group logits for the MAP head, a logits tensor for the GAP head;
        in training the MAP head gives (org, avg) pairs. `use_kernel` is the
        LN+MLP's dispatch (with IMTPU_TLNMLP at "1") and the MAP head's
        BatchNorms'; `generator` (on x's device) draws the stochastic-depth
        masks."""
        if tuple(x.shape[1:3]) != (self.img_size, self.img_size):
            raise ValueError(f"this PiT's position embedding is sized for {self.img_size} px "
                             f"input, got {tuple(x.shape[1:3])}")
        x = self.patch_embed(x)
        x = x + self.pos_embed.permute(0, 2, 3, 1).to(x.dtype)
        features = [x]
        for s, stage in enumerate(self.transformers):
            b, h, w, c = x.shape
            t = x.reshape(b, h * w, c)
            for blk in stage.blocks:
                t = blk(t, use_kernel=use_kernel, generator=generator)
            x = t.reshape(b, h, w, c)
            features.append(x)
            if s < len(self.pools):
                x = self.pools[s](x)
        if self.pool_type == "map":
            return self.head(features, pre_logits=pre_logits, use_kernel=use_kernel)
        return self.head(features[-1].mean(dim=(1, 2)))


@register_model
def pit_s(**kwargs):
    """models/pit.py:112-118."""
    kwargs.pop("drop", None), kwargs.pop("drop_rate", None)
    return PoolingTransformer(pool_type="gap", **kwargs)


@register_model
def map_pit_s(**kwargs):
    """models/pit.py:121-129."""
    kwargs.pop("drop", None), kwargs.pop("drop_rate", None)
    return PoolingTransformer(pool_type="map", last_dim=384, n_groups=2, n_tokens=4,
                              gram_group=32, **kwargs)


register_default_cfg("pit_s", {"crop_pct": 0.95, "interpolation": "bicubic"})
register_default_cfg("map_pit_s", {"crop_pct": 0.95, "interpolation": "bicubic"})

"""GA-ConvNeXt: a 5-stage ConvNeXt with Gramian-Attention branch heads.
Port of imagenet_models_tpu/models/ga_convnext.py.

A 4x4 stride-4 stem; four ConvNeXt stages (`GAStage`: LayerNorm + 2x2
stride-2 downsample where the width changes, then `GABlock`s), stage 3
emitting `stage3_naggre` taps every depth // (stage3_naggre + 1) blocks when
it is deeper than 5; the multi-scale concat on the stage-3 grid (stages 0-1
average-pooled, the taps, stage 2, stage 3 resized bilinearly); an SE
`Bottleneck` as stage 5; then `branches` heads, each a 1x1 conv, train-mode
BatchNorm, a one-block `gram_layer` stage at `gram_dim`, the normalized upper
triangle of the Gram matrix, a grouped projection and BatchNorm, a
class-attention block and its classifier. The forward returns a tuple of the
branches' logits in both modes, as JAX's does.

Every GABlock, in the backbone and in the gram layers, is the ConvNeXt block
of `ops.convnext_block.convnext_block_apply`: kernels 1 and 2 on CUDA tensors,
and with IMTPU_DW_WGRAD at "1" kernel 9 for the dw conv's weight gradient.
The BatchNorms of stage 5 and of the heads take kernels 7 and 8 in training
with IMTPU_PALLAS_BN on.

Attribute names and parameter shapes are the reference's torch ones (`stem.0`,
`stages.1.downsample.1`, `stages.2.blocks.4.mlp.fc1`, `stages.4.conv2`,
`stages.4.downsample.0`, `gram_contraction.{k}.{0,1}`, `gram_layer.{k}.blocks.0`,
`gram_embedding.{k}.{0,1}`, `ga.{k}`, `fc.{k}`), so the state_dict from
`ckpt.convert` loads with `strict=True`. Everything is NHWC end to end.

Modes: a built model is in eval mode, as the JAX forward's default
`training=False`; `model.train()` gives JAX's `training=True` forward (batch
statistics, the fast GELU, stochastic depth).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from imagenet_models_tpu_torch.core.registry import register_default_cfg, register_model
from imagenet_models_tpu_torch.nn.ga_head import Bottleneck, LayerScaleBlockClassAttn
from imagenet_models_tpu_torch.nn.heads import gram_triu_normalize, triu_gather_tables
from imagenet_models_tpu_torch.nn.layers import (
    BatchNorm,
    Dense,
    DropPath,
    GroupedDense,
    LayerNorm,
    Mlp,
    adaptive_avg_pool,
    conv2d_nhwc,
    init_weights_,
    resize_bilinear,
)
from imagenet_models_tpu_torch.ops.convnext_block import convnext_block_apply


class GABlock(nn.Module):
    """timm-style ConvNeXt block: dw7x7 conv -> LN -> Mlp(GELU) -> layer scale
    -> drop-path + residual (models/ga_convnext.py:42-70); no `gamma` when
    ls_init_value <= 0."""

    def __init__(self, dim: int, drop_path: float = 0.0, ls_init_value: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim)
        self.gamma = (nn.Parameter(torch.full((dim,), float(ls_init_value)))
                      if ls_init_value > 0 else None)
        self.drop_path = DropPath(drop_path)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        xc = x if self.compute_dtype is None else x.to(self.compute_dtype)
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        branch = convnext_block_apply(
            xc, self.conv_dw.weight, self.conv_dw.bias, self.norm.weight, self.norm.bias,
            fc1.weight, fc1.bias, fc2.weight, fc2.bias, self.gamma, eps=self.norm.eps,
            use_kernel=use_kernel, training=self.training)
        return x + self.drop_path(branch, generator).to(x.dtype)


class GAStage(nn.Module):
    """A ConvNeXt stage (models/ga_convnext.py:73-103): LayerNorm + a 2x2
    stride-2 conv where the width or the stride changes, then `depth`
    GABlocks; deeper than 5, it also returns `stage3_naggre` taps, the block
    outputs every depth // (stage3_naggre + 1) blocks."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 2, depth: int = 2,
                 dp_rates: Optional[Sequence[float]] = None, ls_init_value: float = 1e-6,
                 stage3_naggre: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if in_chs != out_chs or stride > 1:
            self.downsample = nn.Sequential(LayerNorm(in_chs, dtype=dtype),
                                            nn.Conv2d(in_chs, out_chs, stride, stride=stride))
        self.stride = stride
        dp = list(dp_rates) if dp_rates is not None else [0.0] * depth
        self.blocks = nn.ModuleList(
            GABlock(out_chs, drop_path=float(dp[j]), ls_init_value=ls_init_value, dtype=dtype)
            for j in range(depth))
        self.interval = depth // (stage3_naggre + 1) if depth > 5 else 0
        self.naggre = stage3_naggre
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None):
        if hasattr(self, "downsample"):
            norm, conv = self.downsample
            x = conv2d_nhwc(norm(x), conv.weight, conv.bias, stride=self.stride,
                            dtype=self.compute_dtype)
        taps = []
        for j, blk in enumerate(self.blocks):
            x = blk(x, use_kernel=use_kernel, generator=generator)
            if self.interval and (j + 1) % self.interval == 0 and len(taps) < self.naggre:
                taps.append(x)
        if len(self.blocks) > 5:
            return x, taps
        return x


class GA_ConvNeXt(nn.Module):
    """models/ga_convnext.py:106-184. `generator` seeds the weights (the JAX
    package's init scheme). `drop_rate` is taken and unused, as in JAX."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3, 1),
                 dims: Sequence[int] = (96, 192, 384, 768, 768), num_classes: int = 1000,
                 drop_path_rate: float = 0.0, ls_init_value: float = 1e-6, branches: int = 5,
                 gram_embedding_groups: int = 8, dim_embed: int = 128, stage3_naggre: int = 2,
                 gram_dim: int = 192, gram_layer: bool = True, drop_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.branches, self.gram_dim = branches, gram_dim
        self.compute_dtype = dtype
        splits = np.split(np.linspace(0, drop_path_rate, sum(depths)), np.cumsum(depths)[:-1])
        self.stem = nn.Sequential(nn.Conv2d(in_chans, dims[0], 4, stride=4),
                                  LayerNorm(dims[0], dtype=dtype))
        stages, prev = [], dims[0]
        for i in range(4):
            stages.append(GAStage(prev, dims[i], stride=1 if i == 0 else 2, depth=depths[i],
                                  dp_rates=splits[i], ls_init_value=ls_init_value,
                                  stage3_naggre=stage3_naggre, dtype=dtype))
            prev = dims[i]
        n_taps = min(stage3_naggre, depths[2] // stages[2].interval) if stages[2].interval else 0
        concat = dims[0] + dims[1] + (n_taps + 1) * dims[2] + dims[3]
        stages.append(Bottleneck(concat, dims[4] // 4, dims[4], drop_path=drop_path_rate,
                                 dtype=dtype))
        self.stages = nn.ModuleList(stages)

        c = dims[4]
        tri = gram_dim * (gram_dim + 1) // 2
        self.gram_contraction = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, gram_dim, 1), BatchNorm(gram_dim, dtype=dtype))
            for _ in range(branches))
        if gram_layer:
            self.gram_layer = nn.ModuleList(
                GAStage(gram_dim, gram_dim, stride=1, depth=1, dp_rates=splits[-1],
                        ls_init_value=ls_init_value, dtype=dtype) for _ in range(branches))
        self.gram_embedding = nn.ModuleList(
            nn.Sequential(GroupedDense(tri, c, groups=gram_embedding_groups, dtype=dtype),
                          BatchNorm(c, dtype=dtype)) for _ in range(branches))
        self.ga = nn.ModuleList(
            LayerScaleBlockClassAttn(c, num_heads=8, mlp_block_groups=4, dim_embed=dim_embed,
                                     dtype=dtype) for _ in range(branches))
        self.fc = nn.ModuleList(Dense(c, num_classes, dtype=dtype) for _ in range(branches))
        # the tables of the Gram triangle's scatter-free backward (not saved)
        for name, t in zip(("triu_index", "triu_inverse", "triu_mask"),
                           triu_gather_tables(gram_dim)):
            self.register_buffer(name, t, persistent=False)
        init_weights_(self, generator)
        self.eval()

    def forward(self, x: torch.Tensor, pre_logits: bool = False,
                use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """x: NHWC float images. Returns a tuple of the branches' logits
        (B, num_classes) in both modes, or with `pre_logits` each branch's
        class token (B, dims[4]) before its classifier. `use_kernel` is the
        dispatch of the ConvNeXt blocks' kernels and of the BatchNorms (with
        IMTPU_PALLAS_BN on; None: the kernels for CUDA tensors); `generator`
        (on x's device) draws the stochastic-depth masks."""
        kw = dict(use_kernel=use_kernel, generator=generator)
        conv, norm = self.stem
        x = norm(conv2d_nhwc(x, conv.weight, conv.bias, stride=4, dtype=self.compute_dtype))
        feats, taps = [], []
        for stage in self.stages[:4]:
            out = stage(x, **kw)
            x, taps = out if isinstance(out, tuple) else (out, taps)
            feats.append(x)

        # the multi-scale concat on the stage-3 grid (models/ga_convnext.py:148-153)
        hw = tuple(feats[2].shape[1:3])
        parts = [adaptive_avg_pool(feats[0], hw), adaptive_avg_pool(feats[1], hw)] + taps
        x = torch.cat(parts + [feats[2], resize_bilinear(feats[3], hw)], dim=-1)
        x = self.stages[4](x, **kw)

        b, h, w, c = x.shape
        img_tokens = x.reshape(b, h * w, c)
        triu = (self.triu_index, self.triu_inverse, self.triu_mask)
        outs = []
        for k in range(self.branches):
            proj, bn = self.gram_contraction[k]
            g = bn(conv2d_nhwc(x, proj.weight, proj.bias, dtype=self.compute_dtype),
                   use_kernel=use_kernel)
            if hasattr(self, "gram_layer"):
                g = self.gram_layer[k](g, **kw)
            # x/H, then the product over HW tokens (ga_convnext.py:452-460)
            gv = gram_triu_normalize(g.reshape(b, h * w, self.gram_dim), scale=1.0 / h, triu=triu)
            gv = self.gram_embedding[k](gv)
            token = self.ga[k](img_tokens, gv.reshape(b, 1, c).to(x.dtype), generator=generator)
            outs.append(token[:, 0] if pre_logits else self.fc[k](token[:, 0]))
        return tuple(outs)


def _factory(depths, dims, dim_embed, stage3_naggre, **kwargs) -> GA_ConvNeXt:
    kwargs.pop("in_22k", None)
    return GA_ConvNeXt(depths=depths, dims=dims, dim_embed=dim_embed,
                       stage3_naggre=stage3_naggre, gram_dim=192, gram_embedding_groups=8,
                       **kwargs)


@register_model
def ga_convnext_tiny_688(**kwargs):
    """models/ga_convnext.py:216-219."""
    return _factory((3, 3, 9, 3, 1), (96, 192, 384, 688, 688), 168, 2, **kwargs)


@register_model
def ga_convnext_tiny_768(**kwargs):
    """models/ga_convnext.py:222-225."""
    return _factory((3, 3, 9, 3, 1), (96, 192, 384, 768, 768), 192, 2, **kwargs)


@register_model
def ga_convnext_small_688(**kwargs):
    """models/ga_convnext.py:228-231."""
    return _factory((3, 3, 27, 3, 1), (96, 192, 384, 688, 688), 168, 4, **kwargs)


@register_model
def ga_convnext_small_768(**kwargs):
    """models/ga_convnext.py:234-237."""
    return _factory((3, 3, 27, 3, 1), (96, 192, 384, 768, 768), 192, 4, **kwargs)


@register_model
def ga_convnext_base_976(**kwargs):
    """models/ga_convnext.py:240-243."""
    return _factory((3, 3, 27, 3, 1), (128, 256, 512, 976, 976), 240, 4, **kwargs)


@register_model
def ga_convnext_base_1024(**kwargs):
    """models/ga_convnext.py:246-249."""
    return _factory((3, 3, 27, 3, 1), (128, 256, 512, 1024, 1024), 256, 4, **kwargs)


@register_model
def ga_convnext_tiny(**kwargs):
    """The README's training model (README.md:51): ga_convnext_tiny_768."""
    return ga_convnext_tiny_768(**kwargs)


@register_model
def ga_convnext_small(**kwargs):
    return ga_convnext_small_768(**kwargs)


@register_model
def ga_convnext_base(**kwargs):
    return ga_convnext_base_1024(**kwargs)


for _n in ("ga_convnext_tiny", "ga_convnext_small", "ga_convnext_base"):
    for _suffix in ("", "_688", "_768", "_976", "_1024"):
        register_default_cfg(_n + _suffix, {"crop_pct": 0.875, "interpolation": "bicubic"})

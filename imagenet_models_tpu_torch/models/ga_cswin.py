"""GA-CSWin: a 5-stage CSWin transformer with Gramian-Attention branch heads.
Port of imagenet_models_tpu/models/ga_cswin.py.

Deep 3-conv stem; four CSWin stages joined by `MergeBlock` (3x3 stride-2
conv + LayerNorm); the stage-3 taps every depth//(stage3_naggre+1) blocks;
the multi-scale concat on the 1/16 grid (stages 1-2 average-pooled, stage 4
resized bilinearly); stage 5 = `MergeBlockLCF` (1x1 conv + LayerNorm) and one
CSWinBlock, or with `stage5="bottleneck"` the SE `Bottleneck` of GA-ConvNeXt
(`stage5.2.`); then `branches` heads, each a grouped projection, train-mode
BatchNorm, a CSWin `gram_layer`, the normalized upper triangle of the Gram
matrix, another grouped projection and BatchNorm, a class-attention block and
its classifier. The forward returns a tuple of the branches' logits in both
modes, as JAX's does.

Attribute names and parameter shapes are the reference's torch ones
(`stage1_conv_embed.{0,2,5,7,10,12}`, `stage5.1.` / `stage5.2.`,
`gram_contraction.{k}.{0,1}`, `gram_layer.{k}.1.`, `attns.{0,1}.get_v`, ...),
so the state_dict from `ckpt.convert` loads with `strict=True`. Everything is
NHWC end to end.

A CSWinBlock's form depends on its map (one full window where the map is one
stripe high), so the model is built for `img_size` and runs at that input
size only. The idx=0 stripes of maps at most 16 high take the stripe
kernels (at 224 px: the 14x14 stage 3, the stage-5 block and the gram
layers), in eval and in training; stages 1 and 2 and the idx=1 stripes take
the composition (`ops.cswin_attention`).

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
    GroupedDense,
    LayerNorm,
    adaptive_avg_pool,
    conv2d_nhwc,
    gelu,
    init_weights_,
    resize_bilinear,
    resolve_act,
)
from imagenet_models_tpu_torch.ops.cswin_attention import CSWinBlock


class MergeBlock(nn.Module):
    """3x3 stride-2 conv + LayerNorm (ga_cswin.py:46-56)."""

    def __init__(self, dim: int, dim_out: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim_out, 3, stride=2, padding=1)
        self.norm = LayerNorm(dim_out, dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d_nhwc(x, self.conv.weight, self.conv.bias, stride=2, padding=1,
                        dtype=self.compute_dtype)
        return self.norm(x)


class MergeBlockLCF(nn.Module):
    """1x1 conv + LayerNorm (ga_cswin.py:59-69)."""

    def __init__(self, dim: int, dim_out: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim_out, 1)
        self.norm = LayerNorm(dim_out, dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(conv2d_nhwc(x, self.conv.weight, self.conv.bias, dtype=self.compute_dtype))


def _conv_out(side: int, k: int, s: int, p: int) -> int:
    return (side + 2 * p - k) // s + 1


class GA_CSWinTransformer(nn.Module):
    """ga_cswin.py:72-214. `img_size` fixes each block's form; `generator`
    seeds the weights (the JAX package's init scheme)."""

    def __init__(self, embed_dim: int = 64, depth: Sequence[int] = (1, 2, 21, 1),
                 dims: Sequence[int] = (64, 128, 256, 512),
                 num_heads: Sequence[int] = (2, 4, 8, 16, 16),
                 split_size: Sequence[int] = (1, 2, 7, 7, 7), num_classes: int = 1000,
                 mlp_ratio: float = 4.0, mlp_ratio_stage4: float = 4.0,
                 mlp_ratio_stage5: float = 4.0, qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 stage3_naggre: int = 4, ga_mlp_groups: int = 2, ga_layer_mlp_groups: int = 1,
                 branches: int = 5, gram_dim: int = 192, deep_stem: bool = True,
                 stage5: str = "CSWin", stage5_mlp_groups: int = 1, ga_layer: bool = True,
                 use_chk: bool = False, dtype: Optional[torch.dtype] = None, in_chans: int = 3,
                 img_size: int = 224, generator: Optional[torch.Generator] = None):
        super().__init__()
        if not deep_stem:
            raise NotImplementedError("deep_stem=False (the 7x7 stride-4 stem) is not ported yet")
        self.img_size, self.use_chk = img_size, use_chk
        self.branches, self.gram_dim = branches, gram_dim
        self.compute_dtype = dtype
        dpr = np.linspace(0, drop_path_rate, sum(depth))
        # the deep stem (ga_cswin.py:107-119), keys of the reference's Sequential
        self.stage1_conv_embed = nn.ModuleDict({
            "0": nn.Conv2d(in_chans, embed_dim, 3, stride=2, padding=1, bias=False),
            "2": LayerNorm(embed_dim, dtype=dtype),
            "5": nn.Conv2d(embed_dim, embed_dim, 3, padding=1, bias=False),
            "7": LayerNorm(embed_dim, dtype=dtype),
            "10": nn.Conv2d(embed_dim, dims[0], 3, stride=2, padding=1, bias=False),
            "12": LayerNorm(dims[0], dtype=dtype)})
        side = _conv_out(_conv_out(img_size, 3, 2, 1), 3, 2, 1)

        def stage(n, dim, nh, ss, ratio, off, side, last=False):
            return nn.ModuleList(
                CSWinBlock(dim, nh, split_size=ss, mlp_ratio=ratio, qkv_bias=qkv_bias,
                           drop=drop_rate, attn_drop=attn_drop_rate,
                           drop_path=float(dpr[off + i]), last_stage=last or side == ss,
                           dtype=dtype)
                for i in range(n))

        sides = [side]
        for _ in range(3):
            sides.append(_conv_out(sides[-1], 3, 2, 1))
        self.stage1 = stage(depth[0], dims[0], num_heads[0], split_size[0], mlp_ratio, 0, sides[0])
        self.merge1 = MergeBlock(dims[0], dims[1], dtype)
        self.stage2 = stage(depth[1], dims[1], num_heads[1], split_size[1], mlp_ratio, depth[0],
                            sides[1])
        self.merge2 = MergeBlock(dims[1], dims[2], dtype)
        self.stage3 = stage(depth[2], dims[2], num_heads[2], split_size[2], mlp_ratio,
                            sum(depth[:2]), sides[2])
        self.merge3 = MergeBlock(dims[2], dims[3], dtype)
        self.stage4 = stage(depth[3], dims[3], num_heads[3], split_size[-1], mlp_ratio_stage4,
                            sum(depth[:3]), sides[3], last=True)
        self.tap_interval = depth[2] // (stage3_naggre + 1)
        self.n_taps = min(stage3_naggre, depth[2] // self.tap_interval if self.tap_interval else 0)
        concat = dims[0] + dims[1] + (self.n_taps + 1) * dims[2] + dims[3]

        c, s16 = dims[3], sides[2]  # stage 5 and the heads run on the 1/16 grid
        if stage5 == "CSWin":
            self.stage5 = nn.ModuleDict({
                "1": MergeBlockLCF(concat, c, dtype),
                "2": CSWinBlock(c, num_heads[4], split_size=split_size[4],
                                mlp_ratio=mlp_ratio_stage5, qkv_bias=qkv_bias, drop=drop_rate,
                                attn_drop=attn_drop_rate, drop_path=float(dpr[-1]),
                                last_stage=s16 == split_size[4], mlp_groups=stage5_mlp_groups,
                                dtype=dtype)})
        else:  # the SE bottleneck on the concat, JAX's `stage5_block` (ga_cswin.py:181-184)
            self.stage5 = nn.ModuleDict({
                "2": Bottleneck(concat, c // 4, c, drop_path=drop_path_rate, dtype=dtype)})

        tri = gram_dim * (gram_dim + 1) // 2
        self.gram_contraction = nn.ModuleList(
            nn.Sequential(GroupedDense(c, gram_dim, groups=8, dtype=dtype),
                          BatchNorm(gram_dim, dtype=dtype)) for _ in range(branches))
        if ga_layer:
            self.gram_layer = nn.ModuleList(
                nn.ModuleDict({"1": CSWinBlock(gram_dim, 6, split_size=split_size[4],
                                               qkv_bias=qkv_bias, drop=drop_rate,
                                               attn_drop=attn_drop_rate,
                                               drop_path=float(dpr[-1]),
                                               last_stage=s16 == split_size[4],
                                               mlp_groups=ga_layer_mlp_groups, dtype=dtype)})
                for _ in range(branches))
        self.gram_embedding = nn.ModuleList(
            nn.Sequential(GroupedDense(tri, c, groups=8, dtype=dtype), BatchNorm(c, dtype=dtype))
            for _ in range(branches))
        self.ga = nn.ModuleList(
            LayerScaleBlockClassAttn(c, num_heads=8, mlp_block_groups=ga_mlp_groups,
                                     dim_embed=c // 4, dtype=dtype) for _ in range(branches))
        self.fc = nn.ModuleList(Dense(c, num_classes, dtype=dtype) for _ in range(branches))
        # the tables of the Gram triangle's scatter-free backward (not saved)
        for name, t in zip(("triu_index", "triu_inverse", "triu_mask"),
                           triu_gather_tables(gram_dim)):
            self.register_buffer(name, t, persistent=False)
        init_weights_(self, generator)
        self.eval()

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        st, dt = self.stage1_conv_embed, self.compute_dtype
        act = resolve_act(gelu, not self.training)
        for conv, norm, last in ((st["0"], st["2"], False), (st["5"], st["7"], False),
                                 (st["10"], st["12"], True)):
            x = norm(conv2d_nhwc(x, conv.weight, None, stride=conv.stride[0], padding=1, dtype=dt))
            if not last:
                x = act(x)
        return x

    def forward(self, x: torch.Tensor, pre_logits: bool = False,
                use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """x: NHWC float images of `img_size`. Returns a tuple of the
        branches' logits (B, num_classes) in both modes, or with `pre_logits`
        each branch's class token (B, dims[3]) before its classifier.
        `use_kernel` is the dispatch of the stripe attention and of the
        gram BatchNorms (with IMTPU_PALLAS_BN on; None: the kernels for CUDA
        tensors); `generator` (on x's device) draws the stochastic-depth
        masks."""
        if tuple(x.shape[1:3]) != (self.img_size, self.img_size):
            raise ValueError(f"this GA-CSWin is built for {self.img_size} px input (each block's "
                             f"form follows its map), got {tuple(x.shape[1:3])}")
        if self.use_chk and self.training:
            # torch.utils.checkpoint would redraw the DropPath masks from an
            # explicit generator in its recompute, unlike the first pass
            raise NotImplementedError("use_chk (per-block gradient checkpointing) is not ported yet")
        kw = dict(use_kernel=use_kernel, generator=generator)
        x = self._stem(x)
        xs = []
        for blk in self.stage1:
            x = blk(x, **kw)
        xs.append(x)
        x = self.merge1(x)
        for blk in self.stage2:
            x = blk(x, **kw)
        xs.append(x)
        x = self.merge2(x)
        for i, blk in enumerate(self.stage3):
            x = blk(x, **kw)
            if self.tap_interval and (i + 1) % self.tap_interval == 0 and len(xs) < 2 + self.n_taps:
                xs.append(x)
        xs.append(x)
        x = self.merge3(x)
        for blk in self.stage4:
            x = blk(x, **kw)
        xs.append(x)

        # the multi-scale concat on the 1/16 grid (ga_cswin.py:165-171)
        hw = tuple(xs[2].shape[1:3])
        parts = [adaptive_avg_pool(xs[0], hw), adaptive_avg_pool(xs[1], hw)] + xs[2:-1]
        x = torch.cat(parts + [resize_bilinear(xs[-1], hw)], dim=-1)
        if "1" in self.stage5:
            x = self.stage5["1"](x)
        x = self.stage5["2"](x, **kw)

        b, h, w, c = x.shape
        img_tokens = x.reshape(b, h * w, c)
        triu = (self.triu_index, self.triu_inverse, self.triu_mask)
        outs = []
        for k in range(self.branches):
            proj, norm = self.gram_contraction[k]
            g = norm(proj(x), use_kernel=use_kernel)
            if hasattr(self, "gram_layer"):
                g = self.gram_layer[k]["1"](g, **kw)
            gv = gram_triu_normalize(g.reshape(b, h * w, self.gram_dim), scale=1.0 / h, triu=triu)
            gv = self.gram_embedding[k](gv)
            token = self.ga[k](img_tokens, gv.reshape(b, 1, c).to(x.dtype), generator=generator)
            outs.append(token[:, 0] if pre_logits else self.fc[k](token[:, 0]))
        return tuple(outs)


def _pop_drop(kwargs) -> dict:
    """The JAX factories drop `drop` and `drop_rate` (ga_cswin.py:273)."""
    kwargs.pop("drop", None)
    kwargs.pop("drop_rate", None)
    return kwargs


# (embed_dim, depth, dims, num_heads, split_size) of the registered sizes
# (ga_cswin.py:270-316)
_CFGS = {
    "tiny": (64, (1, 2, 21, 1), (64, 128, 256, 512), (2, 4, 8, 16, 16), (1, 2, 7, 7, 7)),
    "small": (64, (2, 4, 32, 2), (64, 128, 256, 512), (2, 4, 8, 16, 16), (1, 2, 7, 7, 7)),
    "base": (96, (2, 4, 32, 2), (96, 192, 384, 768), (4, 8, 16, 32, 32), (1, 2, 7, 7, 7)),
    "base_384": (96, (2, 4, 32, 2), (96, 192, 384, 768), (4, 8, 16, 32, 32),
                 (1, 2, 12, 12, 12)),
}


def _ga_cswin(size: str, **kwargs) -> GA_CSWinTransformer:
    """The registered size's architecture, any of it overridden by kwargs."""
    embed_dim, depth, dims, heads, split = _CFGS[size]
    cfg = dict(embed_dim=embed_dim, depth=depth, dims=dims, num_heads=heads, split_size=split,
               img_size=384 if size == "base_384" else 224)
    return GA_CSWinTransformer(**{**cfg, **_pop_drop(kwargs)})


@register_model
def ga_cswin_tiny(**kwargs):
    """ga_CSWin_64_12211_tiny_224 (ga_cswin.py:270-278)."""
    return _ga_cswin("tiny", **kwargs)


@register_model
def ga_cswin_small(**kwargs):
    """ga_CSWin_64_24322_small_224 (ga_cswin.py:281-289)."""
    return _ga_cswin("small", **kwargs)


@register_model
def ga_cswin_base(**kwargs):
    """GA-CSWin-B, 96-dim embed (ga_cswin.py:292-301)."""
    return _ga_cswin("base", **kwargs)


@register_model
def ga_cswin_base_384(**kwargs):
    """GA-CSWin-B at 384 px, stripes of (1, 2, 12, 12, 12) (ga_cswin.py:304-316)."""
    return _ga_cswin("base_384", **kwargs)


# the reference's default_cfgs names (ga_cswin.py:319-327)
@register_model
def ga_CSWin_64_12211_tiny_224(**kwargs):
    return ga_cswin_tiny(**kwargs)


@register_model
def ga_CSWin_64_24322_small_224(**kwargs):
    return ga_cswin_small(**kwargs)


for _n in ("ga_cswin_tiny", "ga_cswin_small", "ga_cswin_base",
           "ga_CSWin_64_12211_tiny_224", "ga_CSWin_64_24322_small_224"):
    register_default_cfg(_n, {"crop_pct": 0.9, "interpolation": "bicubic"})
register_default_cfg("ga_cswin_base_384", {"crop_pct": 1.0, "interpolation": "bicubic",
                                           "input_size": (384, 384, 3)})

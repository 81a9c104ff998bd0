"""Cross-shaped window (CSWin) attention with LePE, channels-last.

Port of imagenet_models_tpu/ops/cswin_attention.py: the window partition
(`img2windows`, `windows2img`), `LePEAttention` (one stripe orientation with
its depthwise-3x3 LePE conv `get_v`) and `CSWinBlock` (two half-channel
orientations, or one full window in the last stage, then `proj` and the
MLP). `LePEAttention` has two routes:

- the stripe route, for idx=0 (vertical stripes of width `split_size`) where
  the gate `ops.stripe_attention.use_fused_stripe_attn` allows it:
  `stripe_attention` on the unpartitioned q, k, v (the CUDA kernels 5 and 6
  on the card, their twin on the CPU), LePE in fp32 inside it;
- the composition (the JAX package's default "stacked" form) for idx=1,
  idx=-1 and idx=0 when the gate is off: partition, the LePE conv in the
  compute dtype, scores out of the product in the compute dtype before an
  fp32 softmax, reverse;
- the flash route, with IMTPU_FLASH_ATTN at "1" (`ops.flash_attention.
  _FLASH_ATTN`) for every orientation, unless attention dropout is active in
  training: the stripe route is off, and the stacked composition runs with
  `ops.flash_attention.window_attention` (kernel 12 on the card, its twin on
  the CPU) in place of its two products and softmax, on the flattened
  (B*nWin*heads, n, d) windows, with LePE in the compute dtype added after
  (cswin_attention.py:131-135, :214-224).

In bf16 the stripe route rounds LePE differently (fp32 against bf16), as in
the JAX package. `CSWinBlock`'s norm2 + MLP pair takes `ln_mlp_apply`
(kernels 1 and 2 on the card) with IMTPU_TLNMLP at "1" where
`use_transformer_lnmlp` allows it and the MLP is not grouped
(cswin_attention.py:341-354). The other opt-in routes (`IMTPU_CSWIN_FUSED`,
`IMTPU_CSWIN_DIRECT`, `IMTPU_CSWIN_INNER`) are XLA formulations of the same
function, kept in JAX as receipts of slower TPU timings; the port has no
counterpart of them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from imagenet_models_tpu_torch.nn.layers import (
    Dense,
    DropPath,
    GroupConvMlp,
    LayerNorm,
    Mlp,
    conv2d_nhwc,
    gelu,
)
from imagenet_models_tpu_torch.ops import flash_attention as flash_ops
from imagenet_models_tpu_torch.ops.convnext_block import ln_mlp_apply, use_transformer_lnmlp
from imagenet_models_tpu_torch.ops.stripe_attention import stripe_attention, use_fused_stripe_attn


def img2windows(x: torch.Tensor, hs: int, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nWin, hs*ws, C), windows row-major, tokens row-major
    within a window (cswin_attention.py:27-33)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // hs, hs, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, hs * ws, c)


def windows2img(x: torch.Tensor, hs: int, ws: int, h: int, w: int) -> torch.Tensor:
    """Inverse of img2windows: (B*nWin, hs*ws, C) -> (B, H, W, C)."""
    b = x.shape[0] // ((h // hs) * (w // ws))
    x = x.reshape(b, h // hs, w // ws, hs, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


class LePEAttention(nn.Module):
    """One stripe orientation (cswin_attention.py:61-226). idx -1: the full
    window (last stage); 0: vertical stripes (H x split_size); 1: horizontal
    stripes (split_size x W). q, k, v are (B, H, W, dim) and unscaled; the
    output is (B, H, W, dim). `get_v` is the reference's depthwise Conv2d
    (dim, 1, 3, 3) with bias."""

    def __init__(self, dim: int, num_heads: int, idx: int, split_size: int,
                 attn_drop: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads, self.idx, self.split_size = num_heads, idx, split_size
        self.attn_drop_rate = attn_drop
        self.compute_dtype = dtype
        self.get_v = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)
        self.attn_drop = nn.Dropout(attn_drop)

    def geometry(self, h: int, w: int) -> Tuple[int, int]:
        if self.idx == -1:
            return h, w
        if self.idx == 0:
            return h, self.split_size
        return self.split_size, w

    def _to_heads(self, t: torch.Tensor) -> torch.Tensor:  # (B*, n, C) -> (B*, heads, n, d)
        bn, n, c = t.shape
        return t.reshape(bn, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def _lepe_windows(self, v: torch.Tensor) -> torch.Tensor:
        """The per-window depthwise 3x3 on v, zero-padded at each window's
        borders, as flax's nn.Conv: parameters cast to the compute dtype, the
        bias added in it (cswin_attention.py:83-117); (B*nWin, heads, n, d)."""
        b, h, w, c = v.shape
        hs, ws = self.geometry(h, w)
        dt = self.compute_dtype or v.dtype
        vw = img2windows(v, hs, ws).reshape(-1, hs, ws, c)
        lepe = conv2d_nhwc(vw, self.get_v.weight, None, padding=1, groups=c, dtype=dt)
        lepe = lepe + self.get_v.bias.to(dt)
        return self._to_heads(lepe.reshape(-1, hs * ws, c))

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
        b, h, w, c = q.shape
        hs, ws = self.geometry(h, w)
        scale = (c // self.num_heads) ** -0.5
        flash = flash_ops._FLASH_ATTN == "1"
        if self.idx == 0 and not flash and use_fused_stripe_attn(
                q.shape, self.split_size, self.attn_drop_rate, self.training,
                head_dim=c // self.num_heads):
            # taps t = 3*kh + kw of the (C, 1, 3, 3) weight: w9 = (9, C)
            w9 = self.get_v.weight.reshape(c, 9).t().float()
            wb = self.get_v.bias.reshape(1, c).float()
            return stripe_attention(q, k, v, w9, wb, ws=self.split_size,
                                    num_heads=self.num_heads, scale=scale,
                                    use_kernel=use_kernel)
        # the stacked composition (cswin_attention.py:205-226): q times the
        # scale in q's dtype (in bf16 the scale rounds first), scores out of
        # the product in the input dtype, softmax in fp32 cast back
        qw = self._to_heads(img2windows(q, hs, ws))
        qw = qw * torch.tensor(scale, dtype=qw.dtype, device=qw.device)
        kw = self._to_heads(img2windows(k, hs, ws))
        lepe = self._lepe_windows(v)
        vw = self._to_heads(img2windows(v, hs, ws))
        if flash and not (self.attn_drop_rate > 0 and self.training):
            bw, nh, n, d = qw.shape
            out = flash_ops.window_attention(*(t.reshape(bw * nh, n, d) for t in (qw, kw, vw)),
                                             use_kernel=use_kernel)
            out = out.reshape(bw, nh, n, d) + lepe
        else:
            attn = torch.matmul(qw, kw.transpose(-1, -2))
            attn = torch.softmax(attn.float(), dim=-1).to(attn.dtype)
            out = torch.matmul(self.attn_drop(attn), vw) + lepe
        out = out.transpose(1, 2).reshape(-1, hs * ws, c)
        return windows2img(out, hs, ws, h, w)


class CSWinBlock(nn.Module):
    """CSWin block on (B, H, W, C) (cswin_attention.py:244-367): norm1, qkv,
    two half-channel stripe orientations (idx 0 and 1) or, in the last stage,
    one full window (idx -1), proj, a residual with stochastic depth, then
    norm2 and the MLP (`GroupConvMlp` when mlp_groups > 1) with another; with
    IMTPU_TLNMLP at "1" an ungrouped norm2 + MLP pair is one `ln_mlp_apply`
    on the same parameters (eps 1e-6). `use_kernel` reaches the attention
    and the LN+MLP.

    The JAX block decides the last-stage form from the map it is given
    (`last_stage or h == split_size`), which fixes its parameters; here the
    caller says so at construction (`last_stage`), and a map with
    h == split_size given to a two-orientation block raises."""

    def __init__(self, dim: int, num_heads: int, split_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, last_stage: bool = False, mlp_groups: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.split_size, self.last_stage = split_size, last_stage
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        if last_stage:
            branches = [LePEAttention(dim, num_heads, -1, split_size, attn_drop, dtype)]
        else:
            branches = [LePEAttention(dim // 2, num_heads // 2, i, split_size, attn_drop, dtype)
                        for i in (0, 1)]
        self.attns = nn.ModuleList(branches)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        hidden = int(dim * mlp_ratio)
        self.mlp_groups, self.compute_dtype = mlp_groups, dtype
        if mlp_groups == 1:
            self.mlp = Mlp(dim, hidden, act=gelu, drop=drop, dtype=dtype)
        else:
            self.mlp = GroupConvMlp(dim, hidden, act=gelu, drop=drop, groups=mlp_groups,
                                    dtype=dtype)

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        if not self.last_stage and h == self.split_size:
            raise ValueError(f"a {h}x{w} map is one stripe high: this block needs "
                             f"last_stage=True (its LePE is then one full window)")
        qkv = self.qkv(self.norm1(x))
        # channel slices, [q | k | v]: the stripe kernels read them in place
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        if self.last_stage:
            att = self.attns[0](q, k, v, use_kernel=use_kernel)
        else:
            half = c // 2
            att = torch.cat([self.attns[0](q[..., :half], k[..., :half], v[..., :half],
                                           use_kernel=use_kernel),
                             self.attns[1](q[..., half:], k[..., half:], v[..., half:],
                                           use_kernel=use_kernel)], dim=-1)
        x = x + self.drop_path(self.proj(att), generator)
        if self.mlp_groups == 1 and use_transformer_lnmlp(self.mlp.drop.p, not self.training):
            xc = x if self.compute_dtype is None else x.to(self.compute_dtype)
            m = ln_mlp_apply(xc, self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
                             self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias, eps=1e-6,
                             training=self.training, use_kernel=use_kernel).to(x.dtype)
        else:
            m = self.mlp(self.norm2(x))
        return x + self.drop_path(m, generator)

"""Block-window / dilated-grid attention (MaxViT), channels-last.

Port of imagenet_models_tpu/ops/window_attention.py: the window and grid
partitions and their reverses, the relative-position index and bias tables,
the gate that picks the partition-attention kernels, and `AttentionCl` with
its two routes:

- the partition route: `qkv` on the unpartitioned (B, H, W, C) map, q scaled
  through a bf16 scale vector, then `ops.partition_attention` (the CUDA
  kernels 3 and 4 on the card, their twin on the CPU), then `proj`;
- the composition route (the default of the JAX package, its channel-slice
  form): the caller partitions, attention runs per window in torch ops with
  the JAX route's roundings, and the caller reverses;
- the flash route, with IMTPU_FLASH_ATTN at "1" (`ops.flash_attention.
  _FLASH_ATTN`) where the composition would run, unless attention dropout is
  active in training: qkv split in the stacked (3, B, heads, N, d) form, q
  scaled in its dtype, then `ops.flash_attention.window_attention_heads` with
  the fp32 rel-pos bias (kernel 13 on the card, its twin on the CPU), or
  `window_attention` on the flattened heads without a rel-pos table (kernel
  12), then `proj` (window_attention.py:248-280).

The JAX package's other opt-in routes (`IMTPU_QKV_SPLIT=stack`,
`IMTPU_RELPOS_MATMUL`) are not ported; they give the same results.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imagenet_models_tpu_torch.nn.layers import Dense, trunc_normal_
from imagenet_models_tpu_torch.ops import flash_attention as flash_ops
from imagenet_models_tpu_torch.ops.partition_attention import partition_attention


def window_partition(x: torch.Tensor, ws: Tuple[int, int]) -> torch.Tensor:
    """Contiguous blocks: (B, H, W, C) -> (B*nW, wh, ww, C) (window_attention.py:26-31)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws[0], ws[0], w // ws[1], ws[1], c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws[0], ws[1], c)


def window_reverse(x: torch.Tensor, ws: Tuple[int, int], hw: Tuple[int, int]) -> torch.Tensor:
    h, w = hw
    c = x.shape[-1]
    x = x.reshape(-1, h // ws[0], w // ws[1], ws[0], ws[1], c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def grid_partition(x: torch.Tensor, gs: Tuple[int, int]) -> torch.Tensor:
    """Dilated grid: (B, H, W, C) -> (B*nW, gh, gw, C), token (a, b) of window
    (i, j) at pixel (a*H/gh + i, b*W/gw + j) (window_attention.py:41-46)."""
    b, h, w, c = x.shape
    x = x.reshape(b, gs[0], h // gs[0], gs[1], w // gs[1], c)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(-1, gs[0], gs[1], c)


def grid_reverse(x: torch.Tensor, gs: Tuple[int, int], hw: Tuple[int, int]) -> torch.Tensor:
    h, w = hw
    c = x.shape[-1]
    x = x.reshape(-1, h // gs[0], w // gs[1], gs[0], gs[1], c)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(-1, h, w, c)


def _rel_pos_index(wh: int, ww: int) -> np.ndarray:
    """(area, area) index into a (2wh-1)*(2ww-1) relative-position table
    (window_attention.py:56-66)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


class RelPosBiasTf(nn.Module):
    """timm RelPosBiasTf: a zero-init table (heads, 2H-1, 2W-1), gathered into
    the (heads, T, T) bias (window_attention.py:86-106)."""

    def __init__(self, window_size: Tuple[int, int], num_heads: int):
        super().__init__()
        wh, ww = window_size
        self.num_heads, self.area = num_heads, wh * ww
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(num_heads, 2 * wh - 1, 2 * ww - 1))
        self.register_buffer("index", torch.from_numpy(_rel_pos_index(wh, ww).reshape(-1)),
                             persistent=False)

    def forward(self) -> torch.Tensor:
        flat = self.relative_position_bias_table.reshape(self.num_heads, -1)
        return flat[:, self.index].reshape(self.num_heads, self.area, self.area)


class RelPosBias(nn.Module):
    """timm RelPosBias: a trunc-normal table ((2H-1)*(2W-1), heads)
    (window_attention.py:109-123)."""

    def __init__(self, window_size: Tuple[int, int], num_heads: int):
        super().__init__()
        wh, ww = window_size
        self.num_heads, self.area = num_heads, wh * ww
        self.relative_position_bias_table = nn.Parameter(
            trunc_normal_(torch.empty((2 * wh - 1) * (2 * ww - 1), num_heads)))
        self.register_buffer("index", torch.from_numpy(_rel_pos_index(wh, ww).reshape(-1)),
                             persistent=False)

    def forward(self) -> torch.Tensor:
        bias = self.relative_position_bias_table[self.index]
        return bias.reshape(self.area, self.area, self.num_heads).permute(2, 0, 1)


def use_fused_partition_attn(x_shape, ps, part_type: str, attn_drop: float,
                             deterministic: bool) -> bool:
    """Whether `PartitionAttention` takes the partition-attention kernels
    (window_attention.py:126-155, its default mode): never at eval, which
    takes the partition -> AttentionCl -> reverse composition; in training
    unless attention dropout is on (the kernels draw no random numbers), or
    H or W does not divide by the window, or the map is a single window
    (whose partition is a view). The JAX gate's last test, a 4 MB bound on
    one window-row strip of qkv, is the TPU's VMEM block size: the CUDA
    kernels stage one window at a time, so it has no counterpart here."""
    del part_type  # both partition types take the kernels
    if deterministic or attn_drop > 0:
        return False
    h, w = x_shape[1], x_shape[2]
    return not (h % ps[0] or w % ps[1] or (h == ps[0] and w == ps[1]))


class AttentionCl(nn.Module):
    """Channels-last multi-head self-attention over the trailing token grid
    with an optional relative-position bias (window_attention.py:158-280).
    `head_first=False`: the qkv channels are [q | k | v], each [head, d].

    Called with `partition` = ("block" | "grid", (ph, pw)), x is the
    unpartitioned (B, H, W, C) map and attention runs per window through
    `partition_attention` (the JAX module's `partition` attribute; the
    parameters are the same either way). Without, x is (..., C) and every
    leading index but the first is a token of one attention window; it takes
    the flash route with IMTPU_FLASH_ATTN at "1", else the composition.
    `use_kernel` goes to the partition or flash attention."""

    def __init__(self, dim: int, dim_out: Optional[int] = None, dim_head: int = 32,
                 bias: bool = True, rel_pos_type: Optional[str] = None,
                 window_size: Optional[Tuple[int, int]] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        dim_out = dim_out or dim
        self.dim_attn = dim_out if dim_out > dim else dim
        self.dim_head = dim_head
        self.num_heads = self.dim_attn // dim_head
        self.qkv = Dense(dim, self.dim_attn * 3, bias=bias, dtype=dtype)
        if rel_pos_type == "bias_tf":
            self.rel_pos = RelPosBiasTf(window_size, self.num_heads)
        elif rel_pos_type == "bias":
            self.rel_pos = RelPosBias(window_size, self.num_heads)
        elif rel_pos_type is not None:
            raise ValueError(f"unknown rel_pos_type {rel_pos_type!r}")
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj = Dense(self.dim_attn, dim_out, bias=bias, dtype=dtype)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x: torch.Tensor, partition: Optional[Tuple[str, Tuple[int, int]]] = None,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
        nh = self.num_heads
        qkv = self.qkv(x)
        bias = self.rel_pos() if hasattr(self, "rel_pos") else None
        if partition is not None:
            part_type, ps = partition
            if bias is None:
                bias = torch.zeros(nh, ps[0] * ps[1], ps[0] * ps[1], device=x.device)
            # q pre-scaled through a scale vector in the activation dtype (in
            # bf16, 32**-0.5 becomes 0.1767578), as window_attention.py:211-214
            c = self.dim_attn
            scale = torch.ones(3 * c, device=x.device)
            scale[:c] = self.dim_head ** -0.5
            out = partition_attention(qkv * scale.to(qkv.dtype), bias, part_type=part_type,
                                      ps=ps, num_heads=nh, use_kernel=use_kernel)
            return self.proj_drop(self.proj(out))
        if flash_ops._FLASH_ATTN == "1" and not (self.attn_drop.p > 0 and self.training):
            out = self._flash(qkv, bias, use_kernel)
        else:
            out = slice_attention(qkv, bias, nh, self.attn_drop)
        return self.proj_drop(self.proj(out))

    def _flash(self, qkv: torch.Tensor, bias: Optional[torch.Tensor],
               use_kernel: Optional[bool]) -> torch.Tensor:
        """The flash route's attention (window_attention.py:248-270): qkv
        (B, ..., 3C) with every leading index but the first a token of one
        window, split in the stacked form; returns (B, ..., C)."""
        lead = qkv.shape[:-1]
        b, n = qkv.shape[0], int(np.prod(lead[1:]))
        nh, d = self.num_heads, self.dim_head
        qkv = qkv.reshape(b, n, 3, nh, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        qs = q * torch.tensor(d ** -0.5, dtype=q.dtype, device=q.device)
        if bias is not None:
            out = flash_ops.window_attention_heads(qs, k, v, bias.float(), use_kernel=use_kernel)
        else:
            out = flash_ops.window_attention(*(t.reshape(b * nh, n, d) for t in (qs, k, v)),
                                             use_kernel=use_kernel)
            out = out.reshape(b, nh, n, d)
        return out.transpose(1, 2).reshape(*lead, nh * d)


def slice_attention(qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int,
                    attn_drop: Optional[nn.Module] = None) -> torch.Tensor:
    """The composition route's attention, in the channel-slice form
    (window_attention.py:221-246): qkv (B, ..., 3C) with every leading index
    but the first a token of one window, q unscaled; returns (B, ..., C).
    The JAX route's roundings: q times the scale in q's dtype (in bf16,
    32**-0.5 becomes 0.1767578), products out of the einsums in the input
    dtype, the bias cast to the scores' dtype, softmax in fp32 cast back."""
    lead = qkv.shape[:-1]
    b, n, c = qkv.shape[0], int(np.prod(lead[1:])), qkv.shape[-1] // 3
    d = c // num_heads
    qkv = qkv.reshape(b, n, 3 * c)
    q = qkv[..., :c].reshape(b, n, num_heads, d)
    k = qkv[..., c:2 * c].reshape(b, n, num_heads, d)
    v = qkv[..., 2 * c:].reshape(b, n, num_heads, d)
    attn = torch.einsum("bnhd,bmhd->bhnm", q * torch.tensor(d ** -0.5, dtype=q.dtype), k)
    if bias is not None:
        attn = attn + bias.to(attn.dtype)
    attn = F.softmax(attn.float(), dim=-1).to(attn.dtype)
    if attn_drop is not None:
        attn = attn_drop(attn)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(*lead, c)

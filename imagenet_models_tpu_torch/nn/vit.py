"""The standard ViT transformer block on (B, N, C) tokens. Port of
imagenet_models_tpu/nn/vit.py (timm's `vision_transformer.Block` as the
reference PiT uses it): pre-LayerNorm, fused-qkv multi-head self-attention,
a GELU MLP, one stochastic-depth draw per branch.

The attention keeps the JAX roundings: q times the scale in q's dtype, the
scores out of the product in the compute dtype, softmax in fp32 and cast
back. With IMTPU_TLNMLP at "1" (where `use_transformer_lnmlp` allows it) the
norm2 + MLP pair is one `ln_mlp_apply` on the same parameters, eps 1e-6:
kernels 1 and 2 on the card, their twin on the CPU (nn/vit.py:76-90).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from imagenet_models_tpu_torch.nn.layers import Dense, DropPath, LayerNorm, Mlp, gelu
from imagenet_models_tpu_torch.ops.convnext_block import ln_mlp_apply, use_transformer_lnmlp


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection (nn/vit.py:28-56):
    the qkv channels are [3, heads, d]."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        d = self.dim // h
        qkv = self.qkv(x)
        q, k, v = (qkv[..., i * self.dim:(i + 1) * self.dim].reshape(b, n, h, d)
                   for i in range(3))
        attn = torch.einsum("bnhd,bmhd->bhnm", q * torch.tensor(d ** -0.5, dtype=q.dtype), k)
        attn = F.softmax(attn.float(), dim=-1).to(attn.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", self.attn_drop(attn), v).reshape(b, n, c)
        return self.proj_drop(self.proj(out))


class ViTBlock(nn.Module):
    """Pre-norm attention and MLP, each with a residual (nn/vit.py:59-99).
    `use_kernel` reaches the LN+MLP; `generator` draws the stochastic-depth
    masks."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 attn_drop: float = 0.0, drop: float = 0.0, drop_path: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = Attention(dim, num_heads=num_heads, qkv_bias=qkv_bias, attn_drop=attn_drop,
                              proj_drop=drop, dtype=dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), act=gelu, drop=drop, dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x)), generator)
        if use_transformer_lnmlp(self.mlp.drop.p, not self.training):
            xc = x if self.compute_dtype is None else x.to(self.compute_dtype)
            m = ln_mlp_apply(xc, self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
                             self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias,
                             eps=self.norm2.eps, training=self.training,
                             use_kernel=use_kernel).to(x.dtype)
        else:
            m = self.mlp(self.norm2(x))
        return x + self.drop_path(m, generator)

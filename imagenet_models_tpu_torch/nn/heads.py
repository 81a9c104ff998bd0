"""MAP head library: Gram-token seeded multi-token class-attention pooling.
Port of imagenet_models_tpu/nn/heads.py.

Inputs are channels-last, as in the JAX package. Module and parameter names
are the reference's torch names (`mmcap.mmcap.0.gram_token_extraction...`),
so a state_dict exported from the JAX package loads with `strict=True`.
Under `module.train()` the head runs as JAX's `training=True`: batch
statistics in its BatchNorms, its dropouts, the fast GELU, and `MAPHead`
returns (org, avg) logit pairs. `Head`, `SplitNormHead` and `NormMlpHead`
come with later slices. `use_kernel` reaches every BatchNorm of the head.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from imagenet_models_tpu_torch.nn.layers import (
    BatchNorm,
    ConvNormAct,
    Dense,
    GroupConvMlp,
    GroupedDense,
    LayerNorm,
    gelu,
    relu,
    scale_features,
)


def average_head_logits(out) -> torch.Tensor:
    """Mean of per-branch logits in fp32: the multi-head eval contract
    (nn/heads.py:43-49)."""
    if isinstance(out, (tuple, list)):
        return sum(o.float() for o in out) / len(out)
    return out.float()


def triu_flat_index(c: int) -> torch.Tensor:
    """Flat (row-major) indices of the upper triangle of a (c, c) matrix."""
    iu = torch.triu_indices(c, c)
    return iu[0] * c + iu[1]


def triu_gather_tables(c: int, device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(index, inverse, mask) of the upper-triangle gather from a flat (c*c)
    Gram: `index` picks the triangle; `inverse` maps each of the c*c entries
    to its place in the triangle (0 where it has none) and `mask` is 1 where
    it has one."""
    index = triu_flat_index(c)
    inverse = torch.zeros(c * c, dtype=torch.long)
    inverse[index] = torch.arange(index.numel())
    mask = torch.zeros(c * c)
    mask[index] = 1.0
    return index.to(device), inverse.to(device), mask.to(device)


class _TriuTake(torch.autograd.Function):
    """Upper-triangle gather whose backward is a gather by the inverse index
    times a 0/1 mask, as JAX's custom VJP (nn/heads.py:52-79), instead of
    autograd's scatter-add into the (B, c*c) Gram gradient."""

    @staticmethod
    def forward(ctx, gflat, index, inverse, mask):
        ctx.save_for_backward(inverse, mask)
        return gflat[:, index]

    @staticmethod
    def backward(ctx, d):
        inverse, mask = ctx.saved_tensors
        return d[:, inverse] * mask.to(d.dtype), None, None, None


def gram_triu_normalize(x: torch.Tensor, scale: float, interleave: int = 1,
                        triu: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
    """Gram matrix -> upper triangle -> L2-normalize (nn/heads.py:82-121).

    x: (B, N, C) tokens. Returns fp32 (B, C*(C+1)//2), L2-normalized and
    optionally token-interleaved for a following grouped projection. `triu`
    is `triu_gather_tables(C)`, made here when not given.

    bf16 tokens: the product runs on fp32 copies, so every bf16*bf16 product
    is exact and the Gram comes out in fp32, as JAX's
    `preferred_element_type=float32`; the 1/(h*w) scale goes after the
    product. A bf16 `torch.matmul` would round the Gram to bf16 before the
    triu and the normalize. On a GPU this needs TF32 off for matmuls
    (`torch.backends.cuda.matmul.allow_tf32 = False`, PyTorch's default).
    """
    b, n, c = x.shape
    if x.dtype == torch.bfloat16:
        xf = x.float()
        gram = torch.bmm(xf.transpose(1, 2), xf) * (scale * scale)
    else:
        xf = x.float() * scale
        gram = torch.bmm(xf.transpose(1, 2), xf)  # (B, C, C)
    if triu is None:
        triu = triu_gather_tables(c, x.device)
    flat = _TriuTake.apply(gram.reshape(b, c * c), *triu)
    norm = flat.square().sum(-1, keepdim=True).sqrt()
    flat = flat / norm.clamp_min(1e-12)
    if interleave > 1:
        g = flat.shape[-1]
        flat = flat.reshape(b, g // interleave, interleave).transpose(-1, -2).reshape(b, g)
    return flat


class GramToken(nn.Module):
    """Gram-matrix class-token extraction (nn/heads.py:124-160).
    NHWC in, (B, num_tokens, out_dim) class tokens out."""

    def __init__(self, ch_dim: int, num_groups: int = 8, num_tokens: int = 1,
                 bp_groups: int = 1, bp_dim: int = 192, out_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.out_dim = out_dim or ch_dim
        self.num_tokens = num_tokens
        self.ch_reduction = ConvNormAct(ch_dim, bp_dim, 1, groups=bp_groups, act=None,
                                        dtype=dtype)
        gram_dim = bp_dim * (bp_dim + 1) // 2
        feats = self.out_dim * num_tokens
        self.bp_reduction = nn.Sequential(
            GroupedDense(gram_dim, feats, groups=num_groups, bias=False, dtype=dtype),
            BatchNorm(feats, dtype=dtype))
        # the reference's triu index buffer (the JAX export drops it), and the
        # tables of its scatter-free backward
        index, inverse, mask = triu_gather_tables(bp_dim)
        self.register_buffer("bp_index", index, persistent=False)
        self.register_buffer("bp_inverse", inverse, persistent=False)
        self.register_buffer("bp_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None) -> torch.Tensor:
        h = self.ch_reduction(x, use_kernel=use_kernel)
        b, hh, ww, c = h.shape
        flat = gram_triu_normalize(h.reshape(b, hh * ww, c), scale=1.0 / (hh * ww),
                                   interleave=self.num_tokens,
                                   triu=(self.bp_index, self.bp_inverse, self.bp_mask))
        flat = self.bp_reduction(flat)
        # token t takes channels [t::nt] in out_dim-major order
        return flat.reshape(b, self.out_dim, self.num_tokens).transpose(1, 2)


class ClassAttention(nn.Module):
    """Multi-token class attention with optional interactive head mixing
    (nn/heads.py:163-228)."""

    def __init__(self, in_dim: int, dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, n_tokens: int = 1, embed_dim: int = 128,
                 interactive: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        e = embed_dim
        self.num_heads, self.embed_dim, self.n_tokens = num_heads, e, n_tokens
        self.scale = qk_scale or (e // num_heads) ** -0.5
        self.interactive = interactive
        self.dim_mismatch = in_dim != dim
        if self.dim_mismatch:
            self.q = Dense(in_dim, e, bias=qkv_bias, dtype=dtype)
            self.k1 = Dense(in_dim, e, bias=qkv_bias, dtype=dtype)
            self.k2 = Dense(dim, e, bias=qkv_bias, dtype=dtype)
            self.v1 = Dense(in_dim, e, bias=qkv_bias, dtype=dtype)
            self.v2 = Dense(dim, e, bias=qkv_bias, dtype=dtype)
        else:
            self.q = Dense(dim, e, bias=qkv_bias, dtype=dtype)
            self.k = Dense(dim, e, bias=qkv_bias, dtype=dtype)
            self.v = Dense(dim, e, bias=qkv_bias, dtype=dtype)
        if interactive:
            self.w1 = Dense(num_heads, num_heads, dtype=dtype)
            self.w2 = Dense(num_heads, num_heads, dtype=dtype)
        self.proj = Dense(e, dim, dtype=dtype)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj_drop = nn.Dropout(proj_drop)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        b, n, _ = t.shape
        return t.reshape(b, n, self.num_heads, -1).transpose(1, 2)  # (B, h, n, d)

    def _mix(self, attn: torch.Tensor, w: Dense) -> torch.Tensor:
        return attn + w(attn.movedim(1, -1)).movedim(-1, 1)

    def forward(self, x) -> torch.Tensor:
        if self.dim_mismatch:
            cls, img = x
            # the reference concatenates k(cls) before k(img)
            k = torch.cat([self._heads(self.k1(cls)), self._heads(self.k2(img))], dim=-2)
            v = torch.cat([self._heads(self.v1(cls)), self._heads(self.v2(img))], dim=-2)
        else:
            cls = x[:, : self.n_tokens]
            k, v = self._heads(self.k(x)), self._heads(self.v(x))
        q = self._heads(self.q(cls)) * self.scale
        attn = torch.matmul(q, k.transpose(-1, -2))
        if self.interactive:  # pre-softmax head mixing
            attn = self._mix(attn, self.w1)
        attn = torch.softmax(attn.float(), dim=-1).to(attn.dtype)
        if self.interactive:  # post-softmax additive mixing, not re-normalized
            attn = self._mix(attn, self.w2)
        out = torch.matmul(self.attn_drop(attn), v)
        b = out.shape[0]
        out = out.transpose(1, 2).reshape(b, self.n_tokens, self.embed_dim)
        return self.proj_drop(self.proj(out))


class CABlock(nn.Module):
    """Class-attention block: CA + grouped MLP with pre-norms (nn/heads.py:231-269)."""

    def __init__(self, in_dim: int, dim: int, num_heads: int = 32, mlp_ratio: float = 4.0,
                 groups: int = 2, qkv_bias: bool = True, drop: float = 0.05,
                 attn_drop: float = 0.05, act: Callable = gelu, n_tokens: int = 1,
                 ca_dim: Optional[int] = None, interactive: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim_mismatch = in_dim != dim
        if self.dim_mismatch:
            self.norm1_1 = LayerNorm(in_dim, dtype=dtype)
            self.norm1_2 = LayerNorm(dim, dtype=dtype)
        else:
            self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = ClassAttention(in_dim, dim, num_heads=num_heads, qkv_bias=qkv_bias,
                                   attn_drop=attn_drop, proj_drop=drop, n_tokens=n_tokens,
                                   embed_dim=ca_dim or dim, interactive=interactive,
                                   dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = GroupConvMlp(dim, int(dim * mlp_ratio), act=act, drop=drop, groups=groups,
                                dtype=dtype)

    def forward(self, x: Tuple[torch.Tensor, torch.Tensor]):
        x_cls, x_img = x
        if self.dim_mismatch:  # no residual on the mismatch path
            x_cls = self.attn((self.norm1_1(x_cls), self.norm1_2(x_img)))
        else:
            u = torch.cat([x_cls, x_img], dim=1)
            x_cls = x_cls + self.attn(self.norm1(u))
        x_cls = x_cls + self.mlp(self.norm2(x_cls))
        return x_cls, x_img


class CAP(nn.Module):
    """Class-attention pooling over one feature map, gram- or learned-token
    seeded (nn/heads.py:272-337)."""

    def __init__(self, last_dim: int = 1024, num_heads: int = 8, mlp_ratio: float = 4.0,
                 mlp_groups: int = 2, n_layers: int = 1, n_tokens: int = 1,
                 distill_tokens: int = 0, attn_drop: float = 0.0,
                 self_distill_token: bool = False,
                 act: Callable = gelu, gram: bool = False, gram_group: int = 8,
                 bp_groups: int = 1, gram_dim: Optional[int] = None, bp_dim: int = 192,
                 ca_dim: Optional[int] = None, interactive: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.last_dim, self.n_tokens = last_dim, n_tokens
        self.distill_tokens, self.self_distill_token = distill_tokens, self_distill_token
        self.gram = gram
        gram_dim = gram_dim or last_dim
        cls_tokens = n_tokens + distill_tokens
        self.all_tokens = cls_tokens + (1 if self_distill_token else 0)
        if gram:
            self.gram_token_extraction = GramToken(
                last_dim, num_groups=gram_group, num_tokens=n_tokens, bp_groups=bp_groups,
                bp_dim=bp_dim, out_dim=gram_dim, dtype=dtype)
            if distill_tokens > 0:
                self.x_distill = nn.Parameter(torch.zeros(1, distill_tokens, gram_dim))
        else:
            self.x_cls = nn.Parameter(torch.zeros(1, cls_tokens, last_dim))
        self.attention = nn.ModuleList(
            CABlock(gram_dim, last_dim, num_heads=num_heads, mlp_ratio=mlp_ratio,
                    groups=mlp_groups, attn_drop=attn_drop, act=act, n_tokens=self.all_tokens,
                    ca_dim=ca_dim, interactive=interactive, dtype=dtype)
            for _ in range(n_layers))

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        if self.gram:
            x_cls = self.gram_token_extraction(x, use_kernel=use_kernel)
            if self.distill_tokens > 0:
                dst = self.x_distill.expand(b, -1, -1).to(x_cls.dtype)
                x_cls = torch.cat([x_cls, dst], dim=1)
        else:
            x_cls = self.x_cls.expand(b, -1, -1).to(x.dtype)
        img = x.reshape(b, h * w, c)
        if self.self_distill_token:
            x_cls = torch.cat([x_cls, x_cls.mean(dim=1, keepdim=True)], dim=1)
        for blk in self.attention:
            x_cls, img = blk((x_cls, img))
        return x_cls.reshape(b, self.all_tokens * self.last_dim)


class MultiScale(nn.Module):
    """Pyramid fusion: every level resized to level `multi_scale_level`,
    concatenated, 1x1 ConvNormAct (nn/heads.py:340-355)."""

    def __init__(self, multi_scale_level: int, in_dim: int, out_dim: int,
                 act: Callable = relu, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.multi_scale_level = multi_scale_level
        self.concat_conv = ConvNormAct(in_dim, out_dim, 1, act=act, dtype=dtype)

    def forward(self, features: Sequence[torch.Tensor],
                use_kernel: Optional[bool] = None) -> torch.Tensor:
        target = tuple(features[self.multi_scale_level].shape[1:3])
        x = torch.cat([scale_features(f, target) for f in features], dim=-1)
        return self.concat_conv(x, use_kernel=use_kernel)


class MAP(nn.Module):
    """n_groups parallel CAPs over the fused multi-scale feature (nn/heads.py:358-408)."""

    def __init__(self, multi_scale_level: int = 0, channels: Sequence[int] = (64, 256, 512, 1024, 2048),
                 last_dim: int = 1024, non_linearity: Callable = relu, gram: bool = False,
                 gram_group: int = 16, bp_groups: int = 1, bp_dim: int = 192,
                 gram_dim: Optional[int] = None, num_heads: int = 8, mlp_ratio: float = 2.0,
                 mlp_groups: int = 1, n_layers: int = 1, n_tokens: int = 1,
                 distill_tokens: int = 0, self_distill_token: bool = False,
                 attn_drop: float = 0.0,
                 act: Callable = gelu, ca_dim: Optional[int] = None, n_groups: int = 1,
                 interactive: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.use_multi_scale = multi_scale_level > 0
        if self.use_multi_scale:
            self.multi_scale = MultiScale(multi_scale_level, sum(channels), last_dim,
                                          act=non_linearity, dtype=dtype)
        elif channels[-1] != last_dim:
            self.channel_convertor = ConvNormAct(channels[-1], last_dim, 1, act=relu,
                                                 dtype=dtype)
        self.mmcap = nn.ModuleList(
            CAP(last_dim=last_dim, num_heads=num_heads, mlp_ratio=mlp_ratio,
                mlp_groups=mlp_groups, n_layers=n_layers, n_tokens=n_tokens,
                distill_tokens=distill_tokens, attn_drop=attn_drop,
                self_distill_token=self_distill_token,
                act=act, gram=gram, gram_group=gram_group, bp_groups=bp_groups,
                gram_dim=gram_dim, bp_dim=bp_dim, ca_dim=ca_dim, interactive=interactive,
                dtype=dtype)
            for _ in range(n_groups))

    def forward(self, features: Sequence[torch.Tensor],
                use_kernel: Optional[bool] = None) -> List[torch.Tensor]:
        if self.use_multi_scale:
            x = self.multi_scale(features, use_kernel=use_kernel)
        else:
            x = features[-1]
            if hasattr(self, "channel_convertor"):
                x = self.channel_convertor(x, use_kernel=use_kernel)
        return [cap(x, use_kernel=use_kernel) for cap in self.mmcap]


class NormHead(nn.Module):
    """LayerNorm + Linear (nn/heads.py:426-459).

    pre_logits=True returns PER-TOKEN logits (B, nt, num_classes): the
    normalized features split into nt chunks, each multiplied by its slice of
    the fc weight, with no bias."""

    def __init__(self, in_dim: int, num_classes: int, nt: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.nt = nt
        self.compute_dtype = dtype
        self.norm = LayerNorm(in_dim, dtype=dtype)
        self.head = nn.Linear(in_dim, num_classes)

    def forward(self, x: torch.Tensor, pre_logits: bool = False) -> torch.Tensor:
        x = self.norm(x)
        w, bias = self.head.weight, self.head.bias
        if self.compute_dtype is not None:
            x, w, bias = x.to(self.compute_dtype), w.to(self.compute_dtype), bias.to(self.compute_dtype)
        if pre_logits:
            b, c = x.shape
            xs = x.reshape(b, self.nt, c // self.nt)
            ws = w.t().reshape(self.nt, c // self.nt, -1)
            return torch.einsum("btc,tcn->btn", xs, ws)
        return torch.nn.functional.linear(x, w, bias)


class MAPHead(nn.Module):
    """MAP + per-group heads (+ per-group self-distill heads) (nn/heads.py:501-611).

    Eval output: a tuple of `n_groups` logits, from the org heads, or from the
    self-distill heads in `light` mode. Training output with self-distill: a
    tuple of (org, avg) logit pairs, the org pool through `dropout` first.
    `head_fn` is "norm" (LayerNorm + Linear) or "linear" (a Linear; with
    pre_logits it returns the pool). `use_kernel` goes to the head's
    BatchNorms."""

    def __init__(self, channels: Sequence[int] = (64, 256, 512, 1024, 2048),
                 last_dim: int = 512, num_heads: int = 8, multi_scale_level: int = 3,
                 n_tokens: int = 3, n_groups: int = 4, self_distill_token: bool = True,
                 distill_tokens: int = 0, attn_drop: float = 0.05, gram: bool = False,
                 gram_group: int = 8,
                 bp_groups: int = 1, bp_dim: int = 192, gram_dim: Optional[int] = None,
                 mlp_ratio: float = 4.0, mlp_groups: int = 2, num_classes: int = 1000,
                 head_fn: str = "norm", act: Callable = relu, non_linearity: Callable = relu,
                 ca_dim: Optional[int] = None, light: bool = False, dropout: float = 0.0,
                 interactive: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if head_fn not in ("norm", "linear"):
            raise NotImplementedError(f"head_fn={head_fn!r} is not ported yet")
        self.head_fn = head_fn
        self.n_groups, self.light = n_groups, light
        self.self_distill_token = self_distill_token
        self.out_ch = last_dim * n_tokens
        self.dst_ch = last_dim * distill_tokens
        self.mmcap = MAP(multi_scale_level=multi_scale_level, channels=channels,
                         last_dim=last_dim, non_linearity=non_linearity, gram=gram,
                         gram_group=gram_group, bp_groups=bp_groups, bp_dim=bp_dim,
                         gram_dim=gram_dim, num_heads=num_heads, mlp_ratio=mlp_ratio,
                         mlp_groups=mlp_groups, n_tokens=n_tokens,
                         distill_tokens=distill_tokens, self_distill_token=self_distill_token,
                         attn_drop=attn_drop, act=act, ca_dim=ca_dim, n_groups=n_groups,
                         interactive=interactive, dtype=dtype)
        # without self-distill the org head reads the whole pool
        head_in = self.out_ch if self_distill_token else last_dim * (n_tokens + distill_tokens)
        if head_fn == "linear":
            self.heads = nn.ModuleList(
                Dense(head_in, num_classes, dtype=dtype) for _ in range(n_groups))
        else:
            self.heads = nn.ModuleList(
                NormHead(head_in, num_classes, nt=n_tokens, dtype=dtype) for _ in range(n_groups))
        self.dropout = nn.Dropout(dropout)
        if self_distill_token:
            self.self_dt_heads = nn.ModuleList(
                NormHead(last_dim, num_classes, dtype=dtype) for _ in range(n_groups))
            if distill_tokens > 0:
                self.distill_heads = nn.ModuleList(
                    NormHead(self.dst_ch, num_classes, nt=distill_tokens, dtype=dtype)
                    for _ in range(n_groups))

    def _org(self, i: int, pool: torch.Tensor, pre_logits: bool) -> torch.Tensor:
        if self.head_fn == "linear":
            return pool if pre_logits else self.heads[i](pool)
        return self.heads[i](pool, pre_logits=pre_logits)

    def forward(self, features: Sequence[torch.Tensor], pre_logits: bool = False,
                use_kernel: Optional[bool] = None):
        pools = self.mmcap(features, use_kernel=use_kernel)
        output = []
        for i, pool in enumerate(pools):
            if not self.self_distill_token:
                output.append(self._org(i, pool, pre_logits))
                continue
            org = pool[:, : self.out_ch]
            avg = pool[:, self.out_ch + self.dst_ch:]
            if self.training:  # (org, avg) pairs, (org, distill, avg) with distill tokens
                pair = [self._org(i, self.dropout(org), pre_logits), self.self_dt_heads[i](avg)]
                if self.dst_ch:
                    pair.insert(1, self.distill_heads[i](pool[:, self.out_ch: self.out_ch + self.dst_ch]))
                output.append(tuple(pair))
            elif self.light:
                output.append(self.self_dt_heads[i](avg))
            else:
                output.append(self._org(i, org, pre_logits))
        return tuple(output)

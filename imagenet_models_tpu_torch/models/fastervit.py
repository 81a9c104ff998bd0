"""FasterViT (hierarchical attention with carrier tokens) with the BN or MAP
head. Port of imagenet_models_tpu/models/fastervit.py.

A conv patch embed (two stride-2 convs, BatchNorm eps 1e-4 + ReLU), two conv
stages of residual 3x3 conv + BatchNorm blocks, two transformer stages of HAT
blocks on 7x7 windows: where a stage's map holds more than one window, each
window gets carrier tokens, pooled from the map (`TokenInitializer`: a
depthwise 3x3 conv and an overlapping average pool), which attend among
themselves and are then concatenated to their window's tokens; the last
block of such a stage adds them back, upsampled, to the windows
(`do_propagation`). Attention biases are SwinV2's log-spaced continuous
position bias (an MLP over a log-spaced coordinate table), padded with zeros
at the front for the carrier tokens; an MLP over a coordinate grid gives the
absolute position embedding (models/fastervit.py:44-406).

The coordinate tables and the bias index are constants (cached per window
size and device), not buffers: the JAX export has no
`relative_coords_table` / `relative_position_index` keys, and a reference
checkpoint's are dropped on load (`ckpt.convert`). The bias gather's
backward adds rows by one fp32 product with the one-hot index matrix, not
by the library's scatter, so that a step's gradients are the same in every
run. The TokenInitializer's conv is registered twice, as the reference's is
(`global_tokenizer.pos_embed` and `global_tokenizer.to_global_feature.pos`),
so its state_dict carries both keys. Everything is NHWC end to end, and the
attention is torch ops with the JAX roundings (scores in the compute dtype,
softmax in fp32 and cast back). `use_kernel` reaches every BatchNorm (kernels
7 and 8 in training with IMTPU_PALLAS_BN on).

Modes: a built model is in eval mode, as the JAX forward's default
`training=False`; `model.train()` gives JAX's `training=True` forward.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imagenet_models_tpu_torch.core.registry import register_default_cfg, register_model
from imagenet_models_tpu_torch.nn.heads import MAPHead
from imagenet_models_tpu_torch.nn.layers import (
    BatchNorm,
    Dense,
    DropPath,
    LayerNorm,
    Mlp,
    conv2d_nhwc,
    gelu,
    init_weights_,
    resolve_act,
)


def window_partition_tokens(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * windows, ws * ws, C) (fastervit.py:44-48)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse_tokens(x: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(-1, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def ct_dewindow(ct: torch.Tensor, size: int, ws: int) -> torch.Tensor:
    """Window-grouped carrier tokens (B, size*size, C), grouped by
    (size/ws)^2 windows of ws*ws, -> raster order (fastervit.py:57-64)."""
    b, _, c = ct.shape
    g = size // ws
    return ct.reshape(b, g, g, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, size * size, c)


def ct_window(ct: torch.Tensor, size: int, ws: int) -> torch.Tensor:
    """Raster order -> window-grouped order (fastervit.py:67-73)."""
    b, _, c = ct.shape
    g = size // ws
    return ct.reshape(b, g, ws, g, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, size * size, c)


@functools.lru_cache(maxsize=None)
def _log_cpb_tables(ws: int, device: torch.device):
    """The log-spaced coordinate table ((2ws-1)^2, 2) of the relative bias and
    the one-hot (ws^4, (2ws-1)^2) matrix of its index, fp32
    (fastervit.py:100-115). Cached: made as normal tensors even where the
    first call comes under `torch.inference_mode` (serving), so that a
    later training step can save them for its backward."""
    rng = np.arange(-(ws - 1), ws, dtype=np.float32)
    table = np.stack(np.meshgrid(rng, rng, indexing="ij"), axis=-1) / (ws - 1) * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8)
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    index = (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).reshape(-1)
    onehot = np.zeros((index.size, (2 * ws - 1) ** 2), np.float32)
    onehot[np.arange(index.size), index] = 1.0
    with torch.inference_mode(False):
        return (torch.from_numpy(table.reshape(-1, 2).astype(np.float32)).to(device),
                torch.from_numpy(index).to(device), torch.from_numpy(onehot).to(device))


@functools.lru_cache(maxsize=None)
def _grid_coords(seq: int, device: torch.device) -> torch.Tensor:
    """The (seq, 2) coordinates of a sqrt(seq) square grid, centred and
    scaled to about [-1, 1] (fastervit.py:137-141)."""
    s = int(seq ** 0.5)
    grid = np.stack(np.meshgrid(np.arange(s, dtype=np.float32), np.arange(s, dtype=np.float32),
                                indexing="ij"))
    grid = (grid - s // 2) / (s // 2)
    with torch.inference_mode(False):  # as `_log_cpb_tables`
        return torch.from_numpy(grid.reshape(2, -1).T.astype(np.float32)).to(device)


class _TakeRows(torch.autograd.Function):
    """table[index], whose backward adds the rows' gradients by one fp32
    product with the one-hot index matrix (deterministic, unlike the
    library's scatter on CUDA)."""

    @staticmethod
    def forward(ctx, table, index, onehot):
        ctx.save_for_backward(onehot)
        return table[index]

    @staticmethod
    def backward(ctx, g):
        (onehot,) = ctx.saved_tensors
        return (onehot.t() @ g.float()).to(g.dtype), None, None


def cpb_mlp(out_dim: int, dtype: Optional[torch.dtype]) -> nn.Sequential:
    """The coordinate MLP: Linear(2, 512) + ReLU + Linear(512, out, no bias)
    (fastervit.py:76-86); torch keys `.0` and `.2`."""
    return nn.Sequential(Dense(2, 512, dtype=dtype), nn.ReLU(),
                         Dense(512, out_dim, bias=False, dtype=dtype))


class PosEmbMLPSwinv2D(nn.Module):
    """Log-CPB relative bias (fastervit.py:89-124): (heads, seq, seq), the
    carrier tokens' rows and columns zero-padded at the front."""

    def __init__(self, window_size: int, num_heads: int, seq_length: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.window_size, self.seq_length = window_size, seq_length
        self.cpb_mlp = cpb_mlp(num_heads, dtype)

    def forward(self) -> torch.Tensor:
        ws = self.window_size
        table, index, onehot = _log_cpb_tables(ws, self.cpb_mlp[0].weight.device)
        bias = _TakeRows.apply(self.cpb_mlp(table), index, onehot)
        bias = 16.0 * torch.sigmoid(bias.reshape(ws * ws, ws * ws, -1).permute(2, 0, 1))
        pad = self.seq_length - ws * ws
        return F.pad(bias, (pad, 0, pad, 0)) if pad > 0 else bias


class PosEmbMLPSwinv1D(nn.Module):
    """MLP absolute position embedding over a sqrt(seq) square grid, added to
    the tokens (fastervit.py:127-143)."""

    def __init__(self, dim: int, seq_length: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.seq_length = seq_length
        self.cpb_mlp = cpb_mlp(dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pos = self.cpb_mlp(_grid_coords(self.seq_length, x.device))
        return x + pos[None].to(x.dtype)


class WindowAttention(nn.Module):
    """Multi-head self-attention with the log-CPB bias (fastervit.py:146-180):
    scores scaled after the product, in the compute dtype."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, resolution: int = 0,
                 seq_length: int = 0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.pos_emb_funct = PosEmbMLPSwinv2D(resolution, num_heads, seq_length, dtype=dtype)
        self.attn_drop = nn.Dropout(attn_drop)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        d = c // h
        qkv = self.qkv(x)
        q, k, v = (qkv[..., i * self.dim:(i + 1) * self.dim].reshape(b, n, h, d)
                   for i in range(3))
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k)
        attn = attn * torch.tensor(d ** -0.5, dtype=attn.dtype)
        attn = attn + self.pos_emb_funct()[None].to(attn.dtype)
        attn = F.softmax(attn.float(), dim=-1).to(attn.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", self.attn_drop(attn), v).reshape(b, n, c)
        return self.proj_drop(self.proj(out))


class ConvBlock(nn.Module):
    """conv3x3 + BN + GELU + conv3x3 + BN, residual (fastervit.py:183-206)."""

    def __init__(self, dim: int, drop_path: float = 0.0, layer_scale: Optional[float] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.norm1 = BatchNorm(dim, dtype=dtype)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1)
        self.norm2 = BatchNorm(dim, dtype=dtype)
        self.layer_scale = layer_scale
        if layer_scale is not None:
            self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale)))
        self.drop_path = DropPath(drop_path)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.compute_dtype
        h = conv2d_nhwc(x, self.conv1.weight, self.conv1.bias, padding=1, dtype=dt)
        h = resolve_act(gelu, not self.training)(self.norm1(h, use_kernel=use_kernel))
        h = conv2d_nhwc(h, self.conv2.weight, self.conv2.bias, padding=1, dtype=dt)
        h = self.norm2(h, use_kernel=use_kernel)
        if self.layer_scale is not None:
            h = h * self.gamma.to(h.dtype)
        return x + self.drop_path(h, generator)


def _scaled(gamma: Optional[torch.Tensor], a: torch.Tensor) -> torch.Tensor:
    return a if gamma is None else gamma.to(a.dtype) * a


class HAT(nn.Module):
    """Hierarchical attention block (fastervit.py:209-287): with `sr_ratio`
    > 1 the carrier tokens attend among themselves (`hat_*`) and are then
    prepended to their windows' tokens; the last block of a stage with
    `do_propagation` adds them back to the windows, upsampled (nearest)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0,
                 sr_ratio: int = 1, window_size: int = 7, last: bool = False,
                 layer_scale: Optional[float] = None, ct_size: int = 1,
                 do_propagation: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim, self.sr_ratio, self.window_size = dim, sr_ratio, window_size
        self.ct_size, self.last, self.do_propagation = ct_size, last, do_propagation
        hidden = int(dim * mlp_ratio)
        n_win = window_size * window_size

        def gamma():
            if layer_scale is None:
                return None
            return nn.Parameter(torch.full((dim,), float(layer_scale)))

        self.pos_embed = PosEmbMLPSwinv1D(dim, n_win, dtype=dtype)
        if sr_ratio > 1:
            span = ct_size * sr_ratio
            self.hat_pos_embed = PosEmbMLPSwinv1D(dim, span * span, dtype=dtype)
            self.hat_norm1 = LayerNorm(dim, eps=1e-5, dtype=dtype)
            self.hat_attn = WindowAttention(dim, num_heads, qkv_bias, attn_drop, drop,
                                            resolution=span, seq_length=span * span, dtype=dtype)
            self.gamma1 = gamma()
            self.hat_norm2 = LayerNorm(dim, eps=1e-5, dtype=dtype)
            self.hat_mlp = Mlp(dim, hidden, act=gelu, drop=drop, dtype=dtype)
            self.gamma2 = gamma()
        self.norm1 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.attn = WindowAttention(
            dim, num_heads, qkv_bias, attn_drop, drop, resolution=window_size,
            seq_length=n_win + (ct_size ** 2 if sr_ratio > 1 else 0), dtype=dtype)
        self.gamma3 = gamma()
        self.norm2 = LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.mlp = Mlp(dim, hidden, act=gelu, drop=drop, dtype=dtype)
        self.gamma4 = gamma()
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, ct: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        ws, dim = self.window_size, self.dim
        n_win = ws * ws
        dp = lambda t: self.drop_path(t, generator)
        x = self.pos_embed(x)
        if self.sr_ratio > 1:
            span = self.ct_size * self.sr_ratio
            ct_shape = ct.shape
            ct = self.hat_pos_embed(ct_dewindow(ct, span, self.ct_size))
            ct = ct + dp(_scaled(self.gamma1, self.hat_attn(self.hat_norm1(ct))))
            ct = ct + dp(_scaled(self.gamma2, self.hat_mlp(self.hat_norm2(ct))))
            ct = ct_window(ct, span, self.ct_size).reshape(x.shape[0], -1, dim)
            x = torch.cat([ct, x], dim=1)
        x = x + dp(_scaled(self.gamma3, self.attn(self.norm1(x))))
        x = x + dp(_scaled(self.gamma4, self.mlp(self.norm2(x))))
        if self.sr_ratio > 1:
            ctr, x = x[:, :-n_win], x[:, -n_win:]
            ct = ctr.reshape(ct_shape)
            if self.last and self.do_propagation:
                # the carrier tokens upsampled (nearest) into their windows
                cs = self.ct_size
                rep = ws // cs + (1 if ws % cs else 0)
                ci = ctr.reshape(-1, cs, cs, dim).float()
                ci = ci.repeat_interleave(rep, 1).repeat_interleave(rep, 2)[:, :ws, :ws]
                ci = ci.reshape(-1, n_win, dim).to(x.dtype)
                x = x + (ci if self.gamma1 is None else self.gamma1.to(x.dtype) * ci)
        return x, ct


class TokenInitializer(nn.Module):
    """Carrier tokens pooled per window: a depthwise 3x3 conv, then an average
    pool whose windows overlap (5x5, stride 3 on a 14x14 map)
    (fastervit.py:290-313). The conv is also `to_global_feature.pos`, as in
    the reference."""

    def __init__(self, dim: int, input_resolution: int, window_size: int, ct_size: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        out_size = int(ct_size * input_resolution / window_size)
        stride = input_resolution // out_size
        kernel = input_resolution - (out_size - 1) * stride
        self.out_size, self.ct_size, self.compute_dtype = out_size, ct_size, dtype
        self.pos_embed = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)
        self.to_global_feature = nn.Sequential(OrderedDict(
            pos=self.pos_embed, pool=nn.AvgPool2d(kernel_size=kernel, stride=stride)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        h = conv2d_nhwc(x, self.pos_embed.weight, self.pos_embed.bias, padding=1, groups=c,
                        dtype=self.compute_dtype)
        h = self.to_global_feature.pool(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        b, o, cs = h.shape[0], self.out_size, self.ct_size
        ct = h.reshape(b, o // cs, cs, o // cs, cs, c).permute(0, 1, 3, 2, 4, 5)
        return ct.reshape(b, o * o, c)


class PatchEmbed(nn.Module):
    """Two 3x3 stride-2 convs without bias, each with BatchNorm (eps 1e-4) and
    ReLU (fastervit.py:342-352); torch keys `conv_down.{0,1,3,4}`."""

    def __init__(self, in_chans: int, in_dim: int, dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_down = nn.Sequential(
            nn.Conv2d(in_chans, in_dim, 3, stride=2, padding=1, bias=False),
            BatchNorm(in_dim, eps=1e-4, dtype=dtype), nn.ReLU(),
            nn.Conv2d(in_dim, dim, 3, stride=2, padding=1, bias=False),
            BatchNorm(dim, eps=1e-4, dtype=dtype), nn.ReLU())
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None) -> torch.Tensor:
        for conv, bn in ((self.conv_down[0], self.conv_down[1]),
                         (self.conv_down[3], self.conv_down[4])):
            x = conv2d_nhwc(x, conv.weight, None, stride=2, padding=1, dtype=self.compute_dtype)
            x = F.relu(bn(x, use_kernel=use_kernel))
        return x


class Downsample(nn.Module):
    """LayerNorm, then a 3x3 stride-2 conv without bias that doubles the
    channels (fastervit.py:386-390)."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm = LayerNorm(dim, dtype=dtype)
        self.reduction = nn.Sequential(nn.Conv2d(dim, 2 * dim, 3, stride=2, padding=1, bias=False))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(self.norm(x), self.reduction[0].weight, None, stride=2, padding=1,
                           dtype=self.compute_dtype)


class FasterViTLayer(nn.Module):
    """One stage: conv blocks or HAT blocks (with a TokenInitializer where the
    map holds more than one window), then the downsample of stages 0-2."""

    def __init__(self, blocks: Sequence[nn.Module], conv: bool, window_size: int,
                 global_tokenizer: Optional[TokenInitializer], downsample: Optional[Downsample]):
        super().__init__()
        self.conv, self.window_size = conv, window_size
        self.blocks = nn.ModuleList(blocks)
        if global_tokenizer is not None:
            self.global_tokenizer = global_tokenizer
        if downsample is not None:
            self.downsample = downsample

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.conv:
            for blk in self.blocks:
                x = blk(x, use_kernel=use_kernel, generator=generator)
        else:
            ct = self.global_tokenizer(x) if hasattr(self, "global_tokenizer") else None
            b, h, w, _ = x.shape
            t = window_partition_tokens(x, self.window_size)
            for blk in self.blocks:
                t, ct = blk(t, ct, generator=generator)
            x = window_reverse_tokens(t, self.window_size, h, w)
        return self.downsample(x) if hasattr(self, "downsample") else x


class FasterViT(nn.Module):
    """fastervit.py:316-406: stages 0 and 1 of conv blocks, 2 and 3 of HAT
    blocks; the MAP head (`use_map`: multi_scale_level 3 over [embed, s0, s1,
    s2, s3], `head_fn="linear"`, interactive class attention, `fc_drop` =
    `drop_rate`) or BatchNorm + global average pool + Linear."""

    def __init__(self, dim: int = 128, in_dim: int = 64, depths: Sequence[int] = (3, 3, 12, 5),
                 window_size: Sequence[int] = (7, 7, 7, 7), ct_size: int = 2,
                 mlp_ratio: float = 4.0, num_heads: Sequence[int] = (2, 4, 8, 16),
                 resolution: int = 224, drop_path_rate: float = 0.2, num_classes: int = 1000,
                 qkv_bias: bool = True, drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 layer_scale: Optional[float] = None, layer_scale_conv: Optional[float] = None,
                 hat: Sequence[bool] = (False, False, True, False), do_propagation: bool = False,
                 use_map: bool = False, dtype: Optional[torch.dtype] = None, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.resolution, self.use_map = resolution, use_map
        self.patch_embed = PatchEmbed(in_chans, in_dim, dim, dtype=dtype)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        offs = np.concatenate([[0], np.cumsum(depths)])
        self.levels = nn.ModuleList()
        for i, depth in enumerate(depths):
            dim_i, res, ws = int(dim * 2 ** i), resolution // (4 * 2 ** i), window_size[i]
            conv_stage = i in (0, 1)
            tokenizer = None
            if conv_stage:
                blocks = [ConvBlock(dim_i, drop_path=float(dpr[offs[i] + j]),
                                    layer_scale=layer_scale_conv, dtype=dtype)
                          for j in range(depth)]
            else:
                sr_ratio = res // ws if hat[i] else 1
                if hat[i] and res // ws > 1:
                    tokenizer = TokenInitializer(dim_i, res, ws, ct_size=ct_size, dtype=dtype)
                blocks = [HAT(dim_i, num_heads[i], mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                              drop=drop_rate, attn_drop=attn_drop_rate,
                              drop_path=float(dpr[offs[i] + j]), sr_ratio=sr_ratio,
                              window_size=ws, last=j == depth - 1, layer_scale=layer_scale,
                              ct_size=ct_size, do_propagation=do_propagation, dtype=dtype)
                          for j in range(depth)]
            self.levels.append(FasterViTLayer(blocks, conv_stage, ws, tokenizer,
                                              Downsample(dim_i, dtype=dtype) if i < 3 else None))
        if use_map:
            self.head = MAPHead(
                multi_scale_level=3, channels=[dim, dim * 2, dim * 4, dim * 8, dim * 8],
                last_dim=384, n_tokens=3, n_groups=5, self_distill_token=True,
                non_linearity=gelu, gram=True, bp_dim=384, bp_groups=1, gram_group=32,
                gram_dim=384, num_heads=32, ca_dim=384, mlp_ratio=4, mlp_groups=2,
                interactive=True, head_fn="linear", fc_drop=drop_rate,
                num_classes=num_classes, dtype=dtype)
        else:
            self.norm = BatchNorm(dim * 8, dtype=dtype)
            self.head = Dense(dim * 8, num_classes, dtype=dtype)
        init_weights_(self, generator)
        with torch.no_grad():  # the layer scales start at their constant
            for name, p in self.named_parameters():
                if name.rsplit(".", 1)[-1] in ("gamma", "gamma1", "gamma2", "gamma3", "gamma4"):
                    p.fill_(float(layer_scale_conv if name.endswith(".gamma") else layer_scale))
        self.eval()

    def forward(self, x: torch.Tensor, pre_logits: bool = False,
                use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None):
        """x: NHWC float images of `resolution` px. Eval output: a tuple of
        per-group logits for the MAP head, a logits tensor for the BN head;
        in training the MAP head gives (org, avg) pairs. `use_kernel` is the
        BatchNorms' dispatch (with IMTPU_PALLAS_BN on; None: the kernels for
        CUDA tensors); `generator` (on x's device) draws the
        stochastic-depth masks."""
        if tuple(x.shape[1:3]) != (self.resolution, self.resolution):
            raise ValueError(f"this FasterViT's windows and carrier tokens are laid out for "
                             f"{self.resolution} px input, got {tuple(x.shape[1:3])}")
        x = self.patch_embed(x, use_kernel=use_kernel)
        features = [x]
        for level in self.levels:
            x = level(x, use_kernel=use_kernel, generator=generator)
            features.append(x)
        if self.use_map:
            return self.head(features, pre_logits=pre_logits, use_kernel=use_kernel)
        x = self.norm(x, use_kernel=use_kernel)
        return self.head(x.mean(dim=(1, 2)))


def _faster_vit_3(use_map: bool, **kwargs) -> FasterViT:
    kwargs.pop("drop", None)
    kwargs.setdefault("drop_path_rate", 0.3)
    return FasterViT(dim=128, in_dim=64, depths=(3, 3, 12, 5), num_heads=(2, 4, 8, 16),
                     window_size=(7, 7, 7, 7), ct_size=2, mlp_ratio=4, layer_scale=1e-5,
                     do_propagation=True, use_map=use_map, **kwargs)


@register_model
def faster_vit_3_224(**kwargs):
    """fastervit.py:448-456."""
    return _faster_vit_3(False, **kwargs)


@register_model
def map_faster_vit_3_224(**kwargs):
    """fastervit.py:459-467."""
    return _faster_vit_3(True, **kwargs)


# crop_pct 1.0, center crop (fastervit.py:470-475); the MAP variant resolves
# the same cfg
for _n in ("faster_vit_3_224", "map_faster_vit_3_224"):
    register_default_cfg(_n, {"crop_pct": 1.0, "crop_mode": "center",
                              "interpolation": "bicubic"})

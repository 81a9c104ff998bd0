"""MaxViT (the TF-style tiny-to-xlarge family) with the avg or MAP head.
Port of imagenet_models_tpu/models/maxvit.py.

TF specifics as there: BatchNorm eps 1e-3 in the conv blocks but 1e-5 in the
shortcut's, SAME padding (asymmetric on the stride-2 depthwise 3x3), LayerNorm
eps 1e-5 in the attention blocks, head_first=False qkv order, zero-init TF
rel-pos tables, windows and grid of input/32. Attribute names and parameter
shapes are the reference's torch ones (`stem.conv1`, `stages.0.blocks.0.conv.
norm1`, `...attn_block.attn.rel_pos.relative_position_bias_table`,
`head.mmcap...`), so the state_dict from `ckpt.convert` loads with
`strict=True`. Everything is NHWC end to end.

The attention blocks take the window / grid attention kernels in training and
the partition -> AttentionCl -> reverse composition at eval, by the gate
`ops.window_attention.use_fused_partition_attn`; with IMTPU_FLASH_ATTN at "1"
the composition's attention is kernel 13 (`ops.flash_attention`), and with
IMTPU_TLNMLP at "1" each norm2 + MLP pair is kernels 1 and 2
(`ops.convnext_block.ln_mlp_apply`). Both switches default to "0", as in
JAX. The rel-pos tables are sized for `img_size` at construction (JAX sizes
them from the init input), so a model runs at that input size only.

Modes: a built model is in eval mode, as the JAX forward's default
`training=False`; `model.train()` gives JAX's `training=True` forward (batch
statistics, the fast GELU, stochastic depth, the partition-attention route).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imagenet_models_tpu_torch.core.registry import register_default_cfg, register_model
from imagenet_models_tpu_torch.nn.ga_head import SEModule, make_divisible
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
    silu,
    trunc_normal_,
)
from imagenet_models_tpu_torch.ops import window_attention as wa
from imagenet_models_tpu_torch.ops.convnext_block import ln_mlp_apply, use_transformer_lnmlp

BN_EPS_TF = 1e-3
LN_EPS_TF = 1e-5


class BNAct(BatchNorm):
    """BatchNorm (eps 1e-3) then GELU, exact at eval and fast in training
    (maxvit.py:59-71); the parameters sit on the module itself, as the
    reference's `norm1.weight`. `use_kernel` goes to the BatchNorm."""

    def __init__(self, dim: int, apply_act: bool = True, eps: float = BN_EPS_TF,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dim, eps=eps, dtype=dtype)
        self.apply_act = apply_act

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None) -> torch.Tensor:
        x = super().forward(x, use_kernel=use_kernel)
        return resolve_act(gelu, not self.training)(x) if self.apply_act else x


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool with stride 2 on NHWC, VALID (maxvit.py:55-56)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class Downsample2d(nn.Module):
    """The stride-2 MBConv shortcut: 2x2 average pool, then a 1x1 conv with
    bias only where the channels change (maxvit.py:90-96)."""

    def __init__(self, in_chs: int, out_chs: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if in_chs != out_chs:
            self.expand = nn.Conv2d(in_chs, out_chs, 1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = avg_pool2(x)
        if hasattr(self, "expand"):
            x = conv2d_nhwc(x, self.expand.weight, self.expand.bias, dtype=self.compute_dtype)
        return x


class MbConvBlock(nn.Module):
    """Pre-norm MBConv, tf cfg: stride in the depthwise conv, SE (SiLU) after
    norm2, BN eps 1e-3, SAME padding (maxvit.py:74-118)."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 1, drop_path: float = 0.0,
                 expand_ratio: float = 4.0, attn_ratio: float = 0.25,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        mid = make_divisible(int(out_chs * expand_ratio))
        self.stride, self.compute_dtype = stride, dtype
        if stride == 2:
            self.shortcut = Downsample2d(in_chs, out_chs, dtype=dtype)
        elif in_chs != out_chs:
            # the shortcut's BN keeps the default eps 1e-5 (maxvit.py:100)
            self.shortcut = nn.Sequential(nn.Conv2d(in_chs, out_chs, 1, bias=False),
                                          BatchNorm(out_chs, dtype=dtype))
        else:
            self.shortcut = None
        self.pre_norm = BNAct(in_chs, apply_act=False, dtype=dtype)
        self.conv1_1x1 = nn.Conv2d(in_chs, mid, 1, bias=False)
        self.norm1 = BNAct(mid, dtype=dtype)
        self.conv2_kxk = nn.Conv2d(mid, mid, 3, stride=stride, groups=mid, bias=False)
        self.norm2 = BNAct(mid, dtype=dtype)
        self.se = SEModule(mid, int(attn_ratio * out_chs), act=silu, dtype=dtype)
        self.conv3_1x1 = nn.Conv2d(mid, out_chs, 1)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                use_kernel: Optional[bool] = None) -> torch.Tensor:
        dt, kw = self.compute_dtype, dict(use_kernel=use_kernel)
        if self.shortcut is None:
            shortcut = x
        elif isinstance(self.shortcut, Downsample2d):
            shortcut = self.shortcut(x)
        else:
            conv, bn = self.shortcut
            shortcut = bn(conv2d_nhwc(x, conv.weight, None, dtype=dt), **kw)
        h = conv2d_nhwc(self.pre_norm(x, **kw), self.conv1_1x1.weight, None, dtype=dt)
        h = conv2d_nhwc(self.norm1(h, **kw), self.conv2_kxk.weight, None, stride=self.stride,
                        groups=self.conv2_kxk.groups, dtype=dt)
        h = self.se(self.norm2(h, **kw))
        h = conv2d_nhwc(h, self.conv3_1x1.weight, self.conv3_1x1.bias, dtype=dt)
        return self.drop_path(h, generator) + shortcut


class PartitionAttention(nn.Module):
    """Block-window or grid attention, then the MLP, each pre-norm with a
    residual; one DropPath draws a mask for each (maxvit.py:121-188). The
    norm2 + MLP pair runs as modules, or with IMTPU_TLNMLP at "1" (where
    `use_transformer_lnmlp` allows it) as one `ln_mlp_apply` on the same
    parameters (kernels 1 and 2 on the card). `use_kernel` reaches the
    attention and the LN+MLP."""

    def __init__(self, dim: int, partition_type: str = "block",
                 partition_size: Tuple[int, int] = (7, 7), dim_head: int = 32,
                 expand_ratio: float = 4.0, rel_pos_type: str = "bias_tf",
                 attn_drop: float = 0.0, proj_drop: float = 0.0, drop_path: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.partition_type = partition_type
        self.partition_size = tuple(partition_size)
        self.attn_drop_rate = attn_drop
        self.norm1 = LayerNorm(dim, eps=LN_EPS_TF, dtype=dtype)
        self.attn = wa.AttentionCl(dim, dim, dim_head=dim_head, rel_pos_type=rel_pos_type,
                                   window_size=self.partition_size, attn_drop=attn_drop,
                                   proj_drop=proj_drop, dtype=dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=LN_EPS_TF, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * expand_ratio), act=gelu, drop=proj_drop, dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ps, kind = self.partition_size, self.partition_type
        n1 = self.norm1(x)
        if wa.use_fused_partition_attn(n1.shape, ps, kind, self.attn_drop_rate,
                                       not self.training):
            a = self.attn(n1, partition=(kind, ps), use_kernel=use_kernel)
        elif kind == "block":
            a = wa.window_reverse(self.attn(wa.window_partition(n1, ps), use_kernel=use_kernel),
                                  ps, n1.shape[1:3])
        else:
            a = wa.grid_reverse(self.attn(wa.grid_partition(n1, ps), use_kernel=use_kernel),
                                ps, n1.shape[1:3])
        x = x + self.drop_path(a, generator)
        if use_transformer_lnmlp(self.mlp.drop.p, not self.training):
            xc = x if self.compute_dtype is None else x.to(self.compute_dtype)
            m = ln_mlp_apply(xc, self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
                             self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias,
                             eps=LN_EPS_TF, training=self.training,
                             use_kernel=use_kernel).to(x.dtype)
        else:
            m = self.mlp(self.norm2(x))
        return x + self.drop_path(m, generator)


class MaxxVitBlock(nn.Module):
    """MBConv -> block-window attention -> grid attention (maxvit.py:191-212)."""

    def __init__(self, dim: int, dim_out: int, stride: int = 1,
                 partition_size: Tuple[int, int] = (7, 7), drop_path: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = MbConvBlock(dim, dim_out, stride=stride, drop_path=drop_path, dtype=dtype)
        self.attn_block = PartitionAttention(dim_out, "block", partition_size,
                                             drop_path=drop_path, dtype=dtype)
        self.attn_grid = PartitionAttention(dim_out, "grid", partition_size,
                                            drop_path=drop_path, dtype=dtype)

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.conv(x, generator, use_kernel=use_kernel)
        x = self.attn_block(x, use_kernel=use_kernel, generator=generator)
        return self.attn_grid(x, use_kernel=use_kernel, generator=generator)


class Stem(nn.Module):
    """3x3 stride-2 conv, BN + GELU, 3x3 conv, both convs with bias and SAME
    padding (maxvit.py:246-252)."""

    def __init__(self, in_chans: int, width: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chans, width, 3, stride=2)
        self.norm1 = BNAct(width, dtype=dtype)
        self.conv2 = nn.Conv2d(width, width, 3)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None) -> torch.Tensor:
        dt = self.compute_dtype
        x = self.norm1(conv2d_nhwc(x, self.conv1.weight, self.conv1.bias, stride=2, dtype=dt),
                       use_kernel=use_kernel)
        return conv2d_nhwc(x, self.conv2.weight, self.conv2.bias, dtype=dt)


class MaxxVitStage(nn.Module):
    def __init__(self, blocks: Sequence[MaxxVitBlock]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class NormMlpClassifierHead(nn.Module):
    """timm NormMlpClassifierHead: global average pool, LayerNorm (eps 1e-5),
    Dense + tanh, dropout, Dense (maxvit.py:280-288)."""

    def __init__(self, in_features: int, hidden_size: int, num_classes: int,
                 drop_rate: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm = LayerNorm(in_features, eps=LN_EPS_TF, dtype=dtype)
        self.pre_logits = nn.Module()
        self.pre_logits.fc = Dense(in_features, hidden_size, dtype=dtype)
        self.drop = nn.Dropout(drop_rate)
        self.fc = Dense(hidden_size, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.tanh(self.pre_logits.fc(self.norm(x.mean(dim=(1, 2)))))
        return self.fc(self.drop(x))


class MaxxVit(nn.Module):
    """MaxViT, tf cfgs, with the avg or the MAP ("mmcap") head (maxvit.py:215-288)."""

    def __init__(self, embed_dim: Sequence[int] = (64, 128, 256, 512),
                 depths: Sequence[int] = (2, 2, 5, 2), stem_width: int = 64,
                 num_classes: int = 1000, drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 head_hidden_size: int = 512, partition_ratio: int = 32,
                 global_pool: str = "avg", last_dim: Optional[int] = 384, n_groups: int = 4,
                 n_tokens: int = 2, bp_dim: int = 384, bp_groups: int = 1, gram_group: int = 24,
                 gram_dim: Optional[int] = 384, ca_dim: int = 384, num_heads: int = 12,
                 split_norm: bool = False, grad_checkpointing: bool = False,
                 dtype: Optional[torch.dtype] = None, in_chans: int = 3,
                 img_size: int | Tuple[int, int] = 224,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hw = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        self.img_size = hw
        self.partition_size = (hw[0] // partition_ratio, hw[1] // partition_ratio)
        self.global_pool = global_pool
        self.grad_checkpointing = grad_checkpointing
        self.stem = Stem(in_chans, stem_width, dtype=dtype)
        rates = np.split(np.linspace(0, drop_path_rate, sum(depths)), np.cumsum(depths)[:-1])
        self.stages = nn.ModuleList()
        dim = stem_width
        for i, (depth, out) in enumerate(zip(depths, embed_dim)):
            blocks = []
            for j in range(depth):
                blocks.append(MaxxVitBlock(dim, out, stride=2 if j == 0 else 1,
                                           partition_size=self.partition_size,
                                           drop_path=float(rates[i][j]), dtype=dtype))
                dim = out
            self.stages.append(MaxxVitStage(blocks))
        if global_pool == "mmcap":
            if drop_rate or split_norm:
                raise NotImplementedError("the MAP head's fc dropout and split-norm heads are "
                                          "not ported yet")
            self.head = MAPHead(
                multi_scale_level=3, channels=[stem_width] + list(embed_dim),
                last_dim=last_dim or embed_dim[-1], n_tokens=n_tokens, n_groups=n_groups,
                self_distill_token=True, mlp_ratio=4, mlp_groups=2, head_fn="norm",
                num_classes=num_classes, non_linearity=gelu, gram=True, bp_dim=bp_dim,
                bp_groups=bp_groups, gram_group=gram_group, gram_dim=gram_dim, ca_dim=ca_dim,
                num_heads=num_heads, dtype=dtype)
        elif global_pool == "avg":
            self.head = NormMlpClassifierHead(embed_dim[-1], head_hidden_size, num_classes,
                                              drop_rate, dtype=dtype)
        else:
            raise ValueError(f"unknown global_pool {global_pool!r}")
        init_weights_(self, generator)
        with torch.no_grad():  # RelPosBias tables are trunc-normal; the TF ones stay zero
            for m in self.modules():
                if isinstance(m, wa.RelPosBias):
                    trunc_normal_(m.relative_position_bias_table, generator=generator)
        self.eval()

    def forward(self, x: torch.Tensor, pre_logits: bool = False,
                use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None):
        """x: NHWC float images of `img_size`. Eval output: a tuple of
        per-group logits for the mmcap head, a logits tensor for the avg head;
        in training the mmcap head gives (org, avg) pairs. `use_kernel` is the
        dispatch of the partition attention and of the BatchNorms (with
        IMTPU_PALLAS_BN on; None: the kernels for CUDA tensors);
        `generator` (on x's device) draws the stochastic-depth masks."""
        if tuple(x.shape[1:3]) != self.img_size:
            raise ValueError(f"this MaxViT's rel-pos tables are sized for {self.img_size} "
                             f"input, got {tuple(x.shape[1:3])}")
        if self.grad_checkpointing and self.training:
            # torch.utils.checkpoint would redraw the DropPath masks from an
            # explicit generator in its recompute, unlike the first pass
            raise NotImplementedError("grad_checkpointing is not ported yet")
        x = self.stem(x, use_kernel=use_kernel)
        features = [x]
        for stage in self.stages:
            for blk in stage.blocks:
                x = blk(x, use_kernel=use_kernel, generator=generator)
            features.append(x)
        if self.global_pool == "mmcap":
            return self.head(features, pre_logits=pre_logits, use_kernel=use_kernel)
        return self.head(x)


# tf-family architecture table (maxvit.py:329-335): name -> (embed_dim,
# depths, stem_width, head_hidden_size)
_TF_CFGS = {
    "tiny": ((64, 128, 256, 512), (2, 2, 5, 2), 64, 512),
    "small": ((96, 192, 384, 768), (2, 2, 5, 2), 64, 768),
    "base": ((96, 192, 384, 768), (2, 6, 14, 2), 64, 768),
    "large": ((128, 256, 512, 1024), (2, 6, 14, 2), 128, 1024),
    "xlarge": ((192, 384, 768, 1536), (2, 6, 14, 2), 192, 1536),
}


def _maxvit_tf(size: str, res: int = 224, **kwargs) -> MaxxVit:
    embed_dim, depths, stem_width, head_hidden = _TF_CFGS[size]
    kwargs.pop("drop", None)
    kwargs.setdefault("img_size", res)
    return MaxxVit(embed_dim=embed_dim, depths=depths, stem_width=stem_width,
                   head_hidden_size=head_hidden, **kwargs)


def _tf_data_cfg(size: str, res: int) -> dict:
    """Data config of the tf family (maxvit.py:368-385): 224 px rows use the
    ImageNet mean/std with crop_pct 0.95 (xlarge: its in21k row), 384 and 512
    px rows the 0.5 mean/std with crop_pct 1.0 and squash crops."""
    if res == 224:
        cfg = {"crop_pct": 0.95, "interpolation": "bicubic"}
        if size == "xlarge":
            cfg.update(mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), num_classes=21843)
        else:
            cfg.update(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))
        return cfg
    return {"crop_pct": 1.0, "crop_mode": "squash", "interpolation": "bicubic",
            "input_size": (res, res, 3), "mean": (0.5, 0.5, 0.5), "std": (0.5, 0.5, 0.5)}


def _register_tf(size: str, res: int) -> None:
    name = f"maxvit_{size}_tf_{res}"

    def factory(**kwargs):
        return _maxvit_tf(size, res, **kwargs)

    factory.__name__ = name
    factory.__doc__ = f"maxvit_{size}_tf at {res} px (maxvit.py:338-406)."
    register_model(factory)
    register_default_cfg(name, _tf_data_cfg(size, res))


for _size in _TF_CFGS:
    for _res in (224, 384, 512):
        _register_tf(_size, _res)


@register_model
def map_maxvit_tiny_tf_224(**kwargs):
    """MaxViT-T with the MAP head (maxvit.py:409-419)."""
    kwargs.pop("drop", None)
    kwargs.setdefault("img_size", 224)
    return MaxxVit(embed_dim=(64, 128, 256, 512), depths=(2, 2, 5, 2), stem_width=64,
                   global_pool="mmcap", last_dim=384, n_groups=4, n_tokens=2, bp_dim=384,
                   bp_groups=1, gram_dim=384, gram_group=24, ca_dim=384, num_heads=12, **kwargs)


# the MAP variant resolves the backbone's cfg (maxvit.py:422-427)
register_default_cfg("map_maxvit_tiny_tf_224", _tf_data_cfg("tiny", 224))

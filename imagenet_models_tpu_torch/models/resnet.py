"""MAP-ResNet50: a from-scratch SE-ResNet50 (deep stem, GELU ConvNormActs,
stochastic depth) with the MAP head. Port of imagenet_models_tpu/models/resnet.py.

As there: every ConvNormAct of the stem and the bottlenecks is GELU (exact
at eval, fast in training), but the residual join is a ReLU; SE after conv3;
the deep stem of three 3x3 ConvNormActs; map_resnet50's channels (64, 128,
256, 256), so stage 4 is 1024 channels wide; the drop-path rate of block i
(of all blocks, in order) is rate * i / num_blocks; `pool_type="map"` routes
the MAP head (ca_dim 384, 12 heads). Attribute names are the reference's
torch ones (`stem.0.0`, `layer1.0.conv1.1`, `layer1.0.se.1.0`, `head.mmcap...`),
so the state_dict from `ckpt.convert` loads with `strict=True`. Everything is
NHWC end to end.

Every train-mode BatchNorm that passes `ops.batch_norm.use_fused_bn` takes
kernels 7 and 8 with IMTPU_PALLAS_BN on; eval uses the running statistics
and launches no kernel. A built model is in eval mode, as the JAX forward's
default `training=False`; `model.train()` gives JAX's `training=True`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from imagenet_models_tpu_torch.core.registry import register_default_cfg, register_model
from imagenet_models_tpu_torch.nn.heads import MAPHead
from imagenet_models_tpu_torch.nn.layers import (
    ConvNormAct,
    Dense,
    DropPath,
    SEUnit,
    gelu,
    init_weights_,
)


class BottleNeck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 ConvNormActs, SE after conv3, a 1x1
    ConvNormAct downsample where the shape changes, drop path, ReLU join
    (resnet.py:37-64)."""

    def __init__(self, in_ch: int, channels: int, stride: int = 1,
                 has_downsample: bool = False, drop_path: float = 0.0, se: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        out_ch = channels * 4
        self.conv1 = ConvNormAct(in_ch, channels, 1, act=gelu, dtype=dtype)
        self.conv2 = ConvNormAct(channels, channels, 3, stride=stride, padding=1, act=gelu,
                                 dtype=dtype)
        self.conv3 = ConvNormAct(channels, out_ch, 1, act=None, dtype=dtype)
        if se:
            self.se = SEUnit(out_ch, act=gelu, dtype=dtype)
        if has_downsample:
            self.downsample = ConvNormAct(in_ch, out_ch, 1, stride=stride, act=None, dtype=dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        kw = dict(use_kernel=use_kernel)
        h = self.conv3(self.conv2(self.conv1(x, **kw), **kw), **kw)
        if hasattr(self, "se"):
            h = self.se(h, **kw)
        residual = self.downsample(x, **kw) if hasattr(self, "downsample") else x
        return F.relu(residual + self.drop_path(h, generator))


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool, stride 2, padding 1 on NHWC (resnet.py:67-68): the
    padding is -inf, as flax's, so an edge window takes its inner values."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)


class MAP_ResNet(nn.Module):
    """The ResNet backbone with the MAP head or GAP + fc (resnet.py:71-140)."""

    def __init__(self, nblock: Sequence[int] = (3, 4, 6, 3),
                 channels: Sequence[int] = (64, 128, 256, 512),
                 strides: Sequence[int] = (1, 2, 2, 2), num_classes: int = 1000,
                 drop_path_rate: float = 0.0, se: bool = False, stem_type: str = "normal",
                 dropout: float = 0.0, pool_type: str = "map", last_dim: int = 384,
                 n_groups: int = 4, n_tokens: int = 3, gram_group: int = 24,
                 token_distill: bool = True, multi_scale_level: int = 3, light: bool = False,
                 split_norm: bool = False, dtype: Optional[torch.dtype] = None,
                 in_chans: int = 3, generator: Optional[torch.Generator] = None):
        super().__init__()
        if split_norm:
            raise NotImplementedError("split_norm (the SplitNormHead) is not ported yet")
        self.pool_type = pool_type
        if stem_type == "deep":
            self.stem = nn.ModuleList([
                ConvNormAct(in_chans, 64, 3, stride=2, padding=1, act=gelu, dtype=dtype),
                ConvNormAct(64, 64, 3, padding=1, act=gelu, dtype=dtype),
                ConvNormAct(64, channels[0], 3, padding=1, act=gelu, dtype=dtype)])
        else:
            self.stem = nn.ModuleList([
                ConvNormAct(in_chans, channels[0], 7, stride=2, padding=3, act=gelu,
                            dtype=dtype)])
        num_block, cur, in_ch = sum(nblock), 0, channels[0]
        for i, (nb, ch, stride) in enumerate(zip(nblock, channels, strides)):
            blocks = []
            for j in range(nb):
                s = stride if j == 0 else 1
                blocks.append(BottleNeck(in_ch, ch, stride=s,
                                         has_downsample=j == 0 and (in_ch != ch * 4 or s != 1),
                                         drop_path=drop_path_rate * (cur / num_block), se=se,
                                         dtype=dtype))
                cur += 1
                in_ch = ch * 4
            self.add_module(f"layer{i + 1}", nn.ModuleList(blocks))
        self.num_stages = len(nblock)
        if pool_type in ("map", "mmcap"):
            self.head = MAPHead(
                multi_scale_level=multi_scale_level,
                channels=[channels[0]] + [c * 4 for c in channels], last_dim=last_dim,
                n_tokens=n_tokens, n_groups=n_groups, self_distill_token=token_distill,
                mlp_ratio=4, mlp_groups=2, head_fn="norm", num_classes=num_classes,
                non_linearity=gelu, gram=True, bp_dim=last_dim, bp_groups=1,
                gram_group=gram_group, gram_dim=last_dim, ca_dim=384, num_heads=12,
                light=light, dropout=dropout, interactive=True, dtype=dtype)
        else:
            # GAP + fc (the reference's Linear(channels[0], ...) cannot run; the
            # JAX package wires the width of the last stage)
            self.head = Dense(in_ch, num_classes, dtype=dtype)
        init_weights_(self, generator)
        self.eval()

    def forward(self, x: torch.Tensor, pre_logits: bool = False,
                use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None):
        """x: NHWC float images. Eval output: a tuple of per-group logits for
        the MAP head, a logits tensor for GAP + fc; in training the MAP head
        gives (org, avg) pairs. `use_kernel` is the BatchNorms' dispatch
        (with IMTPU_PALLAS_BN on; None: the kernels for CUDA tensors);
        `generator` (on x's device) draws the stochastic-depth masks."""
        for stem in self.stem:
            x = stem(x, use_kernel=use_kernel)
        features = [x]
        x = max_pool_3x3_s2(x)
        for i in range(self.num_stages):
            for blk in getattr(self, f"layer{i + 1}"):
                x = blk(x, use_kernel=use_kernel, generator=generator)
            features.append(x)
        if self.pool_type in ("map", "mmcap"):
            return self.head(features, pre_logits=pre_logits, use_kernel=use_kernel)
        return self.head(x.mean(dim=(1, 2)))


@register_model
def map_resnet50(**kwargs):
    """resnet.py:160-170 (channels[3] = 256: a 1024-channel stage 4)."""
    cfg = dict(nblock=(3, 4, 6, 3), channels=(64, 128, 256, 256), pool_type="map",
               last_dim=384, n_groups=4, n_tokens=4, gram_group=32, se=True,
               stem_type="deep", token_distill=True)
    cfg["drop_path_rate"] = kwargs.pop("drop_path_rate", 0.0)
    cfg["dropout"] = kwargs.pop("drop", kwargs.pop("drop_rate", 0.0))
    cfg["num_classes"] = kwargs.pop("num_classes", 1000)
    cfg.update(kwargs)
    return MAP_ResNet(**cfg)


@register_model
def resnet50(**kwargs):
    """The SE-less ResNet50 with GAP + fc (resnet.py:173-181)."""
    cfg = dict(nblock=(3, 4, 6, 3), channels=(64, 128, 256, 512), pool_type="avg")
    cfg["drop_path_rate"] = kwargs.pop("drop_path_rate", 0.0)
    cfg["num_classes"] = kwargs.pop("num_classes", 1000)
    kwargs.pop("drop", None), kwargs.pop("drop_rate", None)
    cfg.update(kwargs)
    return MAP_ResNet(**cfg)


register_default_cfg("map_resnet50", {"crop_pct": 0.95, "interpolation": "bicubic"})
register_default_cfg("resnet50", {"crop_pct": 0.95, "interpolation": "bicubic"})

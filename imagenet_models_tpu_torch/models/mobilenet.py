"""MobileNetV1, with GAP + fc or the MAP head. Port of
imagenet_models_tpu/models/mobilenet.py.

Depthwise-separable conv stacks in five feature stages; map_mobilenet_v1 puts
the MAP head on the last stage only (multi_scale_level=-1: the 1x1
`channel_convertor` ConvNormAct from 1024 to 192 channels) with one group of
four gram-seeded tokens, no self-distill token and a linear classifier.
Attribute names are the reference's torch ones (`layers.3.2.0` the
depthwise conv, `.1` its BatchNorm, `.3` the pointwise conv, `.4` its
BatchNorm; `fc.mmcap...`), so the state_dict from `ckpt.convert` loads with
`strict=True`. Everything is NHWC end to end.

Every train-mode BatchNorm that passes `ops.batch_norm.use_fused_bn` takes
kernels 7 and 8 with IMTPU_PALLAS_BN on; eval uses the running statistics.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from imagenet_models_tpu_torch.core.registry import register_default_cfg, register_model
from imagenet_models_tpu_torch.nn.heads import MAPHead
from imagenet_models_tpu_torch.nn.layers import BatchNorm, Dense, conv2d_nhwc, gelu, init_weights_


class ConvBN(nn.Sequential):
    """3x3 conv (stride) + BatchNorm + ReLU (mobilenet.py:25-38)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(nn.Conv2d(in_ch, features, 3, stride=stride, padding=1, bias=False),
                         BatchNorm(features, dtype=dtype), nn.ReLU())
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None) -> torch.Tensor:
        x = conv2d_nhwc(x, self[0].weight, None, stride=self[0].stride[0], padding=1,
                        dtype=self.compute_dtype)
        return F.relu(self[1](x, use_kernel=use_kernel))


class ConvDW(nn.Sequential):
    """Depthwise 3x3 (stride) + BatchNorm + ReLU, then pointwise 1x1 +
    BatchNorm + ReLU (mobilenet.py:41-60)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(
            nn.Conv2d(in_ch, in_ch, 3, stride=stride, padding=1, groups=in_ch, bias=False),
            BatchNorm(in_ch, dtype=dtype), nn.ReLU(),
            nn.Conv2d(in_ch, features, 1, bias=False), BatchNorm(features, dtype=dtype),
            nn.ReLU())
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None) -> torch.Tensor:
        dt, dw = self.compute_dtype, self[0]
        x = conv2d_nhwc(x, dw.weight, None, stride=dw.stride[0], padding=1, groups=dw.groups,
                        dtype=dt)
        x = F.relu(self[1](x, use_kernel=use_kernel))
        x = conv2d_nhwc(x, self[3].weight, None, dtype=dt)
        return F.relu(self[4](x, use_kernel=use_kernel))


# (block type, out_channels, stride) per stage (mobilenet.py:63-70)
_STAGES = [
    [(ConvBN, 32, 2), (ConvDW, 64, 1)],
    [(ConvDW, 128, 2), (ConvDW, 128, 1)],
    [(ConvDW, 256, 2), (ConvDW, 256, 1)],
    [(ConvDW, 512, 2)] + [(ConvDW, 512, 1)] * 5,
    [(ConvDW, 1024, 2), (ConvDW, 1024, 1)],
]


class MobileNetV1(nn.Module):
    """mobilenet.py:73-98."""

    def __init__(self, num_classes: int = 1000, use_map: bool = False,
                 dtype: Optional[torch.dtype] = None, in_chans: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_map = use_map
        self.layers = nn.ModuleList()
        in_ch = in_chans
        for stage in _STAGES:
            blocks = nn.ModuleList()
            for blk, ch, stride in stage:
                blocks.append(blk(in_ch, ch, stride=stride, dtype=dtype))
                in_ch = ch
            self.layers.append(blocks)
        if use_map:
            dim = 192
            self.fc = MAPHead(
                multi_scale_level=-1, channels=[64, 128, 256, 512, 1024], last_dim=dim,
                n_tokens=4, n_groups=1, self_distill_token=False, non_linearity=gelu,
                gram=True, bp_dim=dim, bp_groups=1, gram_group=32, gram_dim=dim,
                num_heads=dim // 32, ca_dim=dim, mlp_ratio=1, mlp_groups=1, interactive=True,
                head_fn="linear", num_classes=num_classes, dtype=dtype)
        else:
            # the reference's Sequential(avgpool, flatten, linear): key `fc.2`
            self.fc = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                                    Dense(in_ch, num_classes, dtype=dtype))
        init_weights_(self, generator)
        self.eval()

    def forward(self, x: torch.Tensor, pre_logits: bool = False,
                use_kernel: Optional[bool] = None,
                generator: Optional[torch.Generator] = None):
        """x: NHWC float images. Output: a tuple of one group's logits with
        the MAP head (in both modes: no self-distill token), a logits tensor
        for GAP + fc. `use_kernel` is the BatchNorms' dispatch (with
        IMTPU_PALLAS_BN on); `generator` is unused (no stochastic depth)."""
        features = []
        for stage in self.layers:
            for blk in stage:
                x = blk(x, use_kernel=use_kernel)
            features.append(x)
        if self.use_map:
            return self.fc(features, pre_logits=pre_logits, use_kernel=use_kernel)
        return self.fc[2](x.mean(dim=(1, 2)))


def _pop_drops(kwargs):
    for k in ("drop", "drop_rate", "drop_path_rate"):
        kwargs.pop(k, None)


@register_model
def mobilenet_v1(**kwargs):
    _pop_drops(kwargs)
    return MobileNetV1(num_classes=kwargs.pop("num_classes", 1000), **kwargs)


@register_model
def map_mobilenet_v1(**kwargs):
    """mobilenet.py:118-122."""
    _pop_drops(kwargs)
    return MobileNetV1(num_classes=kwargs.pop("num_classes", 1000), use_map=True, **kwargs)


for _n in ("mobilenet_v1", "map_mobilenet_v1"):
    register_default_cfg(_n, {"crop_pct": 0.95, "interpolation": "bicubic",
                              "input_size": (224, 224, 3)})

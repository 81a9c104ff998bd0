"""Common NN building blocks on channels-last (NHWC) tensors.

Port of imagenet_models_tpu/nn/layers.py, the parts the ConvNeXt, MaxViT,
ResNet, MobileNet and MAP-head paths use, in eval and in training
(`module.train()` is JAX's `training=True`: batch statistics, dropout,
stochastic depth, fast GELU).
Parameters keep the reference's torch layouts (Conv2d (O, I/g, kh, kw),
Linear (O, I)), so a state_dict exported from the JAX package loads with
`strict=True`. Activations stay NHWC as in the JAX package: a contiguous
(B, H, W, C) tensor viewed as (B, C, H, W) is `channels_last`, which is what
`F.conv2d` is given.

Compute-dtype policy (the JAX `dtype=` attribute): parameters are fp32 and are
cast to `dtype` at use. With `dtype=None` a layer computes in the promotion of
its input and parameter dtypes, as flax does.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from imagenet_models_tpu_torch.nn import checkpoint as checkpointing
from imagenet_models_tpu_torch.ops import batch_norm as bn_ops
from imagenet_models_tpu_torch.parallel import mesh
from imagenet_models_tpu_torch.ops.convnext_block import FastGelu, check_gelu_env


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU (torch nn.GELU's default; nn/layers.py:27)."""
    return F.gelu(x)


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """GELU with the single-segment minimax erf fit of the LN+MLP kernels,
    z*P8((z/2.75)^2) clamped at |z| = 2.75 (total error <= 1.3e-4), in fp32
    and cast back (nn/layers.py:43-51): the training GELU of the head. The
    same autograd function as the blocks' plain path, so one backward serves
    both."""
    return FastGelu.apply(x.float()).to(x.dtype)


# IMTPU_XLA_GELU (nn/layers.py:36-40), read once at import: "exact" or "fast"
# forces that GELU on the heads' and the transformer MLPs' plain activations
# for both modes; "" = the fast fit in training, exact erf at eval.
_XLA_GELU_ENV = os.environ.get("IMTPU_XLA_GELU", "")


def resolve_act(act: Callable, deterministic: bool) -> Callable:
    """The activation for a mode (nn/layers.py:54-61): the exact GELU becomes
    `gelu_fast` in training (deterministic=False), or what IMTPU_XLA_GELU
    (`_XLA_GELU_ENV`) forces for both modes; any other activation is returned
    as is."""
    if act is not gelu:
        return act
    impl = check_gelu_env("IMTPU_XLA_GELU", _XLA_GELU_ENV) or (
        "exact" if deterministic else "fast")
    return gelu_fast if impl == "fast" else gelu


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def _promote(x: torch.Tensor, p: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype or torch.promote_types(x.dtype, p.dtype)


def trunc_normal_(t: torch.Tensor, std: float = 0.02,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """timm trunc_normal_(std=.02), cut at +-2 (nn/layers.py:64)."""
    return nn.init.trunc_normal_(t, std=std, a=-2.0, b=2.0, generator=generator)


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                stride: int = 1, padding="same", groups: int = 1,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax nn.Conv on NHWC `x` with a torch-layout (O, I/g, kh, kw) weight.

    `padding="same"` is flax's default SAME rule (low side gets the smaller
    half); an int pads symmetrically. The NCHW view handed to cuDNN is
    channels_last, so the result permutes back to a contiguous NHWC tensor.
    """
    dt = _promote(x, weight, dtype)
    xn = x.to(dt).permute(0, 3, 1, 2)
    if padding == "same":
        kh, kw = weight.shape[-2:]
        pads = []
        for size, k in ((xn.shape[3], kw), (xn.shape[2], kh)):
            total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            xn = F.pad(xn, pads)
        padding = 0
    b = None if bias is None else bias.to(dt)
    if xn.is_cuda and dt == torch.float32:
        y = _Fp32Conv.apply(xn, weight.to(dt), b, stride, padding, groups)
    else:
        y = F.conv2d(xn, weight.to(dt), b, stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


class _Fp32Conv(torch.autograd.Function):
    """`F.conv2d` of fp32 CUDA tensors whose backward runs with cuDNN's
    deterministic algorithms (the convolution's own backward,
    `aten.convolution_backward`, under `cudnn.flags(deterministic=True)`).
    cuDNN's default fp32 weight-gradient algorithms add by atomics, so two
    fp32 train steps from one state gave weight gradients up to 3e-7 of
    their largest value apart (the stem and downsample convs and the head's
    1x1 convs of map_convnext_tiny; bf16 steps repeat bit for bit), where
    JAX's step repeats. The other dtypes keep `F.conv2d` under autograd."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride: int, padding: int, groups: int):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, groups, bias is not None)
        return F.conv2d(x, weight, bias, stride=stride, padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, padding, groups, has_bias = ctx.conf
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=True, benchmark=cudnn.benchmark, deterministic=True,
                         allow_tf32=cudnn.allow_tf32):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, weight, [weight.shape[0]] if has_bias else None, [stride] * 2,
                [padding] * 2, [1, 1], False, [0, 0], groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                 has_bias and ctx.needs_input_grad[2]])
        return gx, gw, gb, None, None, None


class Dense(nn.Linear):
    """nn.Linear computing in `dtype` (flax nn.Dense's dtype semantics)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _promote(x, self.weight, self.compute_dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing (channel) axis, eps 1e-6, fp32 statistics.

    flax nn.LayerNorm semantics: statistics and the affine in fp32, then a
    cast to `dtype` (or to the promotion of the input with fp32 when None).
    """

    def __init__(self, dim: int, eps: float = 1e-6, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.compute_dtype or torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(out)


_SPLIT_FALLBACK_WARNED: set = set()


def _warn_split_fallback(batch: int, splits: int) -> None:
    """Warn once per geometry that --split-bn falls back to whole-batch
    statistics because the batch does not divide into the splits (an
    unexpected tail batch); nn/layers.py:136-148."""
    if (batch, splits) not in _SPLIT_FALLBACK_WARNED:
        _SPLIT_FALLBACK_WARNED.add((batch, splits))
        import logging

        logging.getLogger(__name__).warning(
            "--split-bn: batch %d not divisible by %d aug-splits; BatchNorm "
            "falls back to whole-batch statistics for this shape (timm "
            "convert_splitbn_model would have rejected the layout).",
            batch, splits)


class _Group:
    """A process group held by a module: a deep copy of the module shares it
    (a ProcessGroup cannot be copied)."""

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self


class BatchNorm(nn.Module):
    """BatchNorm over every axis but the last (nn/layers.py:BatchNorm).

    eps 1e-5; `(x - mean) * rsqrt(var + eps) * scale + bias` in fp32, then a
    cast to `dtype` (or the input dtype). Eval uses the running statistics.
    Training uses the batch's fp32 mean and E[x^2] (var = E[x^2] - mean^2,
    clamped at 0) and updates the running statistics with momentum 0.9 and
    the unbiased variance (:226-247). With IMTPU_PALLAS_BN on, a training
    input that passes `ops.batch_norm.use_fused_bn` takes
    `ops.batch_norm.bn_train` (kernels 7 and 8 on CUDA tensors; `use_kernel`
    as there), as JAX's does (:211-225); otherwise `plain_bn_train`, with
    autograd's gradient. The parameter and buffer names are torch
    BatchNorm's; `num_batches_tracked` is not kept, as the JAX export has no
    such leaf.

    Two training branches on plain ops, as JAX keeps them, set per model:
    - split-BN (`set_bn_splits`, --split-bn with --aug-splits, :110-121,
      :186-210): rows interleaved sample-major, split j = rows j mod s, each
      split normalised by its own statistics, the affine shared (JAX's
      documented deviation from timm's aux BNs), and only split 0 feeding
      the running statistics; a batch that does not divide falls back to
      whole-batch statistics with a warning;
    - synchronised statistics (`set_bn_sync`, JAX's `axis_name`, :194-201,
      :231-238): the fp32 mean and E[x^2] are mean-all-reduced over the
      group (`parallel.mesh.AllReduceMean`, whose backward averages the
      statistics' cotangents over the ranks) and the unbiased count is n
      times the world. The split branch takes the group too.
    Eval ignores both. In the recompute of a checkpointed block
    (`nn.checkpoint.checkpoint_call`) the running statistics are left as the
    forward set them, as under JAX's remat.
    """

    momentum = 0.9

    def __init__(self, dim: int, eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.eps = eps
        self.compute_dtype = dtype
        self.splits = 1
        self.sync = _Group(None)

    def _stats(self, xf: torch.Tensor, axes, group):
        """fp32 (mean, E[x^2]) over `axes`, averaged over `group`'s ranks."""
        mean, mean2 = xf.mean(dim=axes), xf.square().mean(dim=axes)
        if group is not None:
            mean, mean2 = mesh.AllReduceMean.apply(torch.stack([mean, mean2]), group).unbind(0)
        return mean, mean2

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None) -> torch.Tensor:
        out = self.compute_dtype or x.dtype
        if not self.training:
            mean, var = self.running_mean.float(), self.running_var.float()
            inv = torch.rsqrt(var + self.eps) * self.weight.float()
            return ((x.float() - mean) * inv + self.bias.float()).to(out)
        group, splits = self.sync.group, self.splits
        if splits > 1 and x.shape[0] % splits:
            _warn_split_fallback(x.shape[0], splits)
            splits = 1
        n_ranks = mesh.world(group) if group is not None else 1
        if splits > 1:
            xf = x.float()
            xr = xf.reshape(x.shape[0] // splits, splits, *x.shape[1:])
            axes = (0,) + tuple(range(2, xr.dim() - 1))
            mean, mean2 = self._stats(xr, axes, group)  # (s, C)
            var = torch.clamp(mean2 - mean.square(), min=0.0)
            bshape = (1, splits) + (1,) * (xr.dim() - 3) + (x.shape[-1],)
            inv = torch.rsqrt(var + self.eps) * self.weight.float()
            y = ((xr - mean.reshape(bshape)) * inv.reshape(bshape) + self.bias.float())
            y = y.reshape(x.shape).to(out)
            mean, var = mean[0], var[0]  # only the clean split feeds the running statistics
            n = math.prod(xr.shape[i] for i in axes) * n_ranks
        elif group is not None:
            xf = x.float()
            mean, mean2 = self._stats(xf, tuple(range(x.dim() - 1)), group)
            var = torch.clamp(mean2 - mean.square(), min=0.0)
            inv = torch.rsqrt(var + self.eps) * self.weight.float()
            y = ((xf - mean) * inv + self.bias.float()).to(out)
            n = x.numel() // x.shape[-1] * n_ranks
        else:
            if bn_ops.use_fused_bn(x):
                y, mean, var = bn_ops.bn_train(x, self.weight, self.bias, self.eps, out,
                                               use_kernel=use_kernel)
            else:
                y, mean, var = bn_ops.plain_bn_train(x, self.weight, self.bias, self.eps, out)
            n = x.numel() // x.shape[-1]
        if checkpointing.recomputing():
            return y  # the forward of a checkpointed block has updated them
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * (var * (n / max(n - 1, 1))))
        return y


def set_bn_splits(module: nn.Module, splits: int) -> None:
    """Split-BN for every BatchNorm of `module`: `splits` interleaved splits
    in training (1: off); the per-model form of JAX's global set_bn_splits."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.splits = max(int(splits), 1)


def bn_splits(module: nn.Module) -> int:
    """The split count of `module`'s BatchNorms (1 where it has none)."""
    return next((m.splits for m in module.modules() if isinstance(m, BatchNorm)), 1)


def set_bn_sync(module: nn.Module, group) -> None:
    """Synchronise the training statistics of every BatchNorm of `module`
    over the process group `group` (None: each process its own)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.sync = _Group(group)


class DropPath(nn.Module):
    """Stochastic depth per sample (nn/layers.py:82-101): in training each
    sample's branch is kept with probability 1 - rate and scaled by
    1/(1 - rate), from `generator` (on x's device) when given."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax nn.Dropout in training: each element kept with probability
    1 - rate and scaled by 1/(1 - rate), the mask drawn from `generator` (on
    x's device) when given. Callers apply it in training only."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def grouped_weights(module: nn.Module) -> Dict[str, int]:
    """{parameter name: group count} of the `GroupedDense` weights under
    `module`: their JAX leaf is (g, I/g, O/g), not the torch (O, I/g, 1, 1)."""
    return {f"{name}.weight" if name else "weight": m.groups
            for name, m in module.named_modules() if isinstance(m, GroupedDense)}


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Channel shuffle on the trailing axis (nn/layers.py:273-284)."""
    *lead, c = x.shape
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    return x.reshape(*lead, c // groups, groups).transpose(-1, -2).reshape(*lead, c)


class GroupedDense(nn.Module):
    """Grouped pointwise projection == torch grouped 1x1 Conv2d.

    The parameter keeps the torch grouped-conv layout (O, I/g, 1, 1)
    (nn/layers.py:287-315 holds it as (g, I/g, O/g)); input (..., I), group g
    of the input maps to group g of the output.
    """

    def __init__(self, in_features: int, features: int, groups: int = 1,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if in_features % groups or features % groups:
            raise ValueError(f"({in_features}, {features}) do not split into {groups} groups")
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(features, in_features // groups, 1, 1))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.groups
        out_f, in_g = self.weight.shape[:2]
        dt = self.compute_dtype or x.dtype
        lead = x.shape[:-1]
        xg = x.to(dt).reshape(*lead, g, in_g)
        w = self.weight.to(dt).reshape(g, out_f // g, in_g)
        y = torch.einsum("...gi,goi->...go", xg, w).reshape(*lead, out_f)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class GroupConvMlp(nn.Module):
    """Grouped MLP with a channel shuffle between the layers, dropout after
    the activation (nn/layers.py:318-344)."""

    def __init__(self, in_features: int, hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None, act: Callable = relu,
                 drop: float = 0.0, groups: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        hidden = hidden_features or in_features
        out = out_features or in_features
        self.fc1 = GroupedDense(in_features, hidden, groups=groups, dtype=dtype)
        self.fc2 = GroupedDense(hidden, out, groups=groups, dtype=dtype)
        self.act = act
        self.drop = nn.Dropout(drop)
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(resolve_act(self.act, not self.training)(self.fc1(x)))
        return self.fc2(channel_shuffle(x, self.groups))


class Mlp(nn.Module):
    """Token MLP: fc1 -> activation -> dropout -> fc2 -> dropout, the exact
    GELU becoming the fast one in training (nn/layers.py:250-270)."""

    def __init__(self, in_features: int, hidden_features: Optional[int] = None,
                 out_features: Optional[int] = None, act: Callable = gelu, drop: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features or in_features, dtype=dtype)
        self.fc2 = Dense(hidden_features or in_features, out_features or in_features, dtype=dtype)
        self.act = act
        self.drop = nn.Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(resolve_act(self.act, not self.training)(self.fc1(x)))
        return self.drop(self.fc2(x))


class ConvNormAct(nn.Sequential):
    """Conv (no bias) + BatchNorm + activation; torch keys `.0` conv, `.1` bn
    (nn/layers.py:347-380). `use_kernel` goes to the BatchNorm."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 act: Optional[Callable] = relu, dtype: Optional[torch.dtype] = None):
        super().__init__(
            nn.Conv2d(in_features, features, kernel_size, stride=stride,
                      padding=padding, groups=groups, bias=False),
            BatchNorm(features, dtype=dtype))
        self.act = act
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None) -> torch.Tensor:
        conv = self[0]
        x = conv2d_nhwc(x, conv.weight, None, stride=conv.stride[0],
                        padding=conv.padding[0], groups=conv.groups,
                        dtype=self.compute_dtype)
        x = self[1](x, use_kernel=use_kernel)
        return x if self.act is None else resolve_act(self.act, not self.training)(x)


class SEUnit(nn.Sequential):
    """Squeeze-excitation: global average pool -> 1x1 ConvNormAct -> 1x1
    conv with bias -> sigmoid -> scale (nn/layers.py:383-399); torch keys
    `.1.0`, `.1.1` and `.2` as the reference's Sequential. The squeezed
    (B, 1, 1, C/r) map is far below the BatchNorm kernels' gate."""

    def __init__(self, channels: int, reduction: int = 16, act: Callable = gelu,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(
            nn.AdaptiveAvgPool2d(1),
            ConvNormAct(channels, channels // reduction, 1, act=act, dtype=dtype),
            nn.Conv2d(channels // reduction, channels, 1))
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, use_kernel: Optional[bool] = None) -> torch.Tensor:
        s = self[0](x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        s = self[1](s, use_kernel=use_kernel)
        s = conv2d_nhwc(s, self[2].weight, self[2].bias, dtype=self.compute_dtype)
        return x * torch.sigmoid(s)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=None)
def _resample_matrix(mode: str, n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """The (n_out, n_in) fp32 weights of one axis of the library's resample:
    "area" is adaptive average pooling (bin i covers [floor(i*in/out),
    ceil((i+1)*in/out))), "bilinear" is half-pixel centers with the source
    clamped at 0, as F.interpolate with align_corners=False."""
    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    for i in range(n_out):
        if mode == "area":
            lo, hi = (i * n_in) // n_out, -(-((i + 1) * n_in) // n_out)
            m[i, lo:hi] = 1.0 / (hi - lo)
        else:
            src = max((i + 0.5) * n_in / n_out - 0.5, 0.0)
            i0 = int(src)
            frac = src - i0
            m[i, i0] += 1.0 - frac
            m[i, min(i0 + 1, n_in - 1)] += frac
    return m.to(device, torch.float32)


class _Resample(torch.autograd.Function):
    """A resample of NHWC maps: the forward is the library's (F.interpolate
    or F.adaptive_avg_pool2d); the backward is its transpose, two fp32
    products with the per-axis weights, cast once. The library's CUDA
    backwards add into the input gradient by atomics, so a train step's
    gradients came out different in every run."""

    @staticmethod
    def forward(ctx, x, mode: str, out_hw: Tuple[int, int]):
        ctx.mode, ctx.in_hw = mode, tuple(x.shape[1:3])
        if mode == "area":
            y = F.adaptive_avg_pool2d(_nchw(x), out_hw)
        else:
            y = F.interpolate(_nchw(x), size=out_hw, mode="bilinear", align_corners=False,
                              antialias=False)
        return y.permute(0, 2, 3, 1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (h, w), (oh, ow) = ctx.in_hw, g.shape[1:3]
        mh = _resample_matrix(ctx.mode, h, oh, g.device)
        mw = _resample_matrix(ctx.mode, w, ow, g.device)
        gx = torch.einsum("oh,bopc->bhpc", mh, g.float())
        return torch.einsum("pw,bhpc->bhwc", mw, gx).to(g.dtype), None, None


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """F.adaptive_avg_pool2d on NHWC (nn/layers.py:402-429), with a
    deterministic backward (`_Resample`)."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    return _Resample.apply(x, "area", tuple(out_hw))


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize, half-pixel centers, no antialias (nn/layers.py:432-440),
    with a deterministic backward (`_Resample`)."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    return _Resample.apply(x, "bilinear", tuple(out_hw))


def scale_features(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """MultiScale resize rule (nn/layers.py:443-456): features smaller than
    the target are upsampled by adaptive-avg duplication, larger ones are
    downsampled bilinearly. Load-bearing for checkpoint parity."""
    h = x.shape[1]
    if h < out_hw[0]:
        return adaptive_avg_pool(x, out_hw)
    if h > out_hw[0]:
        return resize_bilinear(x, out_hw)
    return x


def init_weights_(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """The JAX package's init scheme: trunc-normal(0.02) for every conv and
    dense kernel, zeros for biases, ones for norm scales, BN running mean 0 and
    var 1. Modules are visited in registration order, so a seeded generator
    gives the same weights on every machine."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear, GroupedDense)):
                trunc_normal_(m.weight, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (LayerNorm, BatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, BatchNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)

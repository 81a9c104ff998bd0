"""The ConvNeXt block's depthwise 7x7 convolution, with a hand-written CUDA
weight gradient.

Port of imagenet_models_tpu/ops/dw_conv.py. The forward and dx stay with the
framework (cuDNN's depthwise conv, as they are XLA's in JAX). The weight
gradient dL/dw of the stride-1 SAME 7x7 depthwise conv is kernel 9,
`csrc/dw7_wgrad.cu` (wrapper `fused_dw7_wgrad`), beside its plain-PyTorch
twin `plain_dw7_wgrad`, which has the kernel's numerics. The autograd
function `DwConv7Function` joins them as JAX's custom VJP `dw_conv7_opt`
does (:107-134): the forward is `dw_conv7`; dx is the framework's data
gradient of that conv (the correlation of the cotangent with the spatially
flipped kernel; the very call autograd makes for `F.conv2d`, so dx has the
same bits under either setting of the switch); dw is kernel 9 for CUDA tensors
and the twin for CPU tensors; db is the fp32 sum of the cotangent, a PyTorch
reduction (the kernel computes dw only, as the TPU kernel does).

The switch is the JAX package's: the environment variable IMTPU_DW_WGRAD,
read once into `_DW_WGRAD` when this module is imported. "1": the ConvNeXt
block's dw conv takes `DwConv7Function` (ops/convnext_block.py:557-566);
"0" (the default, as in JAX): it stays `F.conv2d` under autograd, whose
weight gradient is cuDNN's. Tests and chip_smoke.py switch arms by setting
`_DW_WGRAD`.

Layouts: x and the cotangent are NHWC (B, H, W, C); the weight is the torch
depthwise layout (C, 1, 7, 7), tap (ky, kx) at [c, 0, ky, kx], which is JAX's
(7, 7, 1, C) HWIO kernel transposed.

Dispatch rule (as the other kernels'): a CPU tensor goes to the twin; a CUDA
tensor goes to the kernel, or raises. There is no fallback from a kernel to
a twin.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

K = 7  # kernel extent (dw 7x7)
PAD = K // 2
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # the kernel's operand type codes

# IMTPU_DW_WGRAD: "1" = kernel 9 for the ConvNeXt block's dw weight gradient;
# "0" = F.conv2d under autograd: the default, as in the JAX package.
_DW_WGRAD = os.environ.get("IMTPU_DW_WGRAD", "0")


def dw_conv7(x: torch.Tensor, dw_w: torch.Tensor, dw_b: torch.Tensor) -> torch.Tensor:
    """Depthwise 7x7 conv on NHWC `x`, weight (C, 1, 7, 7), in x.dtype
    (ops/convnext_block.py:242-251). The NCHW view is channels_last, so the
    result permutes back to a contiguous NHWC tensor."""
    y = F.conv2d(x.permute(0, 3, 1, 2), dw_w.to(x.dtype), dw_b.to(x.dtype),
                 padding=PAD, groups=x.shape[-1])
    return y.permute(0, 2, 3, 1)


def plain_dw7_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dL/dw of a stride-1 SAME depthwise 7x7 conv, in plain PyTorch: the twin
    of kernel 9 and of the TPU kernel `_wgrad_kernel` (dw_conv.py:41-58).

    x, dy (B, H, W, C). For each of the 49 taps, the products of the
    zero-padded x window and dy, each rounded to bf16 when both operands are
    bf16 (the products of fp32 copies are exact, so the rounding is the TPU
    kernel's bf16 multiply), summed in fp32. Returns (C, 1, 7, 7) fp32.
    """
    if x.dim() != 4 or dy.shape != x.shape:
        raise ValueError(f"x and dy must be (B, H, W, C) maps of one shape, got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}")
    b, h, w, c = x.shape
    round_bf16 = x.dtype == torch.bfloat16 and dy.dtype == torch.bfloat16
    xp = F.pad(x.float(), (0, 0, PAD, PAD, PAD, PAD))
    dyf = dy.float()
    taps = []
    for ky in range(K):
        for kx in range(K):
            prod = xp[:, ky:ky + h, kx:kx + w, :] * dyf
            if round_bf16:
                prod = prod.to(torch.bfloat16).float()
            taps.append(prod.sum(dim=(0, 1, 2)))
    return torch.stack(taps, dim=1).reshape(c, 1, K, K)


def fused_dw7_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Kernel 9, the CUDA depthwise 7x7 weight gradient, on contiguous
    (B, H, W, C) NHWC CUDA maps x and dy of one dtype, bf16 or fp32, with
    C % 8 == 0. Returns (C, 1, 7, 7) fp32, the same bits on every run.

    Replaces `dw7_wgrad` (ops/dw_conv.py:72). Raises on anything the kernel
    does not take, CPU tensors included. `fused_dw7_wgrad.launches` counts
    launches."""
    if not (x.is_cuda and dy.is_cuda) or x.device != dy.device:
        raise ValueError("fused_dw7_wgrad needs CUDA tensors on one device; CPU tensors go "
                         "to the twin")
    if x.dim() != 4 or dy.shape != x.shape or x.dtype != dy.dtype or x.dtype not in _DTYPES:
        raise ValueError(f"fused_dw7_wgrad takes x and dy as (B, H, W, C) maps of one shape "
                         f"and one dtype, bf16 or fp32, got {tuple(x.shape)} {x.dtype}, "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if not (x.is_contiguous() and dy.is_contiguous()) or x.data_ptr() % 16 or dy.data_ptr() % 16:
        raise ValueError("fused_dw7_wgrad takes contiguous NHWC maps with 16-byte aligned starts")
    b, h, w, c = x.shape
    from imagenet_models_tpu_torch.ops._kernels import dw7_wgrad_library

    lib = dw7_wgrad_library()
    with torch.cuda.device(x.device):  # the plan reads the device's SM count
        slabs = lib.imt_dw7_wgrad_slabs(b, h, w, c)
        if slabs <= 0:
            raise ValueError(f"fused_dw7_wgrad does not take (B, H, W, C) = {tuple(x.shape)}: "
                             f"it needs a non-empty map with C % 8 == 0")
        partials = torch.empty(slabs, K * K, c, dtype=torch.float32, device=x.device)
        dw = torch.empty(c, 1, K, K, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.imt_dw7_wgrad(x.data_ptr(), dy.data_ptr(), _DTYPES[x.dtype], b, h, w, c,
                                partials.data_ptr(), dw.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dw7_wgrad launch failed: {lib.imt_cuda_error_string(err).decode()}")
    fused_dw7_wgrad.launches += 1
    return dw


fused_dw7_wgrad.launches = 0


def dw7_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The dw weight gradient by the dispatch rule: kernel 9 for CUDA
    tensors, the twin for CPU tensors."""
    if x.is_cuda:
        return fused_dw7_wgrad(x.contiguous(), dy.contiguous())
    return plain_dw7_wgrad(x, dy)


class DwConv7Function(torch.autograd.Function):
    """Depthwise 7x7 SAME conv whose weight gradient is kernel 9: the
    counterpart of JAX's `dw_conv7_opt` custom VJP (dw_conv.py:107-134).

    Forward `dw_conv7` (cuDNN); backward dx = the conv's data gradient
    (`aten.convolution_backward` for the input alone, the call autograd makes
    for `F.conv2d`: cuDNN's correlation of the cotangent with the flipped
    kernel), dw = `dw7_wgrad` in the weight's dtype, db = the fp32 sum of the
    cotangent in the bias's dtype."""

    @staticmethod
    def forward(ctx, x, dw_w, dw_b):
        ctx.save_for_backward(x, dw_w)
        ctx.bias_dtype = dw_b.dtype
        return dw_conv7(x, dw_w, dw_b)

    @staticmethod
    def backward(ctx, g):
        x, dw_w = ctx.saved_tensors
        dx = torch.ops.aten.convolution_backward(
            g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), dw_w.to(x.dtype), None, [1, 1],
            [PAD, PAD], [1, 1], False, [0, 0], x.shape[-1], [True, False, False])[0]
        dx = dx.permute(0, 2, 3, 1)
        dw = dw7_wgrad(x, g).to(dw_w.dtype)
        db = g.sum(dim=(0, 1, 2), dtype=torch.float32).to(ctx.bias_dtype)
        return dx, dw, db

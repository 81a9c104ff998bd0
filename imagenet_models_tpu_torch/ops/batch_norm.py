"""Per-channel BatchNorm statistics for training, forward and backward.

Port of imagenet_models_tpu/ops/batch_norm.py. A train-mode BatchNorm needs
two per-channel reductions of its (..., C) input: the forward's sum x and
sum x^2 (mean and biased variance), and the backward's sum dy and sum dy*x
(dbias, dscale and the two reductions of dx). Two hand-written CUDA kernels
compute them on the card in one pass over the rows each: kernel 7,
`csrc/bn_moments.cu` (wrapper `fused_channel_moments`), and kernel 8,
`csrc/bn_dot_sums.cu` (wrapper `fused_channel_dot_sums`). Beside them are
their plain-PyTorch twins `plain_channel_moments` and
`plain_channel_dot_sums`, the plain forward `plain_bn_train` and the
backward formula `plain_bn_train_bwd`; the autograd function
`BNTrainFunction` joins forward and backward as JAX's custom VJP
`fused_bn_train` does (:181-235).

The switch is the JAX package's: the environment variable IMTPU_PALLAS_BN,
read once into `_PALLAS_BN_MODE` when this module is imported (:178).
"1"/"full": kernel 7 gives the forward statistics and kernel 8 the backward
sums; "bwd": plain reductions in the forward, kernel 8 in the backward; "0"
(the default): no kernel, and BatchNorm keeps its plain code, whose gradient
is autograd's. Tests switch arms by setting `_PALLAS_BN_MODE`.

The TPU kernels read the rows in (h, w, b) order (`_tokens`, a bitcast of
XLA's batch-minor conv layouts). Channel sums do not depend on the order of
the rows, and the port's NHWC activations are contiguous (N, C) views, so
the port reads them as they lie.

Dispatch rule (as the other kernels'): a CPU tensor goes to the twins; a
CUDA tensor goes to the kernels, or raises. There is no fallback from a
kernel to a twin. `use_kernel=False` takes the twins on any device.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Tuple

import torch

from imagenet_models_tpu_torch.ops._kernels import bn_dot_sums_library, bn_moments_library

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # the kernels' operand type codes
_MODES = ("0", "1", "full", "bwd")

# IMTPU_PALLAS_BN mode: "1"/"full" = kernel 7 forward statistics and kernel 8
# backward sums; "bwd" = plain forward statistics, kernel 8 backward sums;
# "0" = no kernel: the default, as in the JAX package.
_PALLAS_BN_MODE = os.environ.get("IMTPU_PALLAS_BN", "0")


def _n_rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1] if x.dim() else 1


def plain_channel_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (sum(x), sum(x^2)) over every axis but the last: the twin of
    kernel 7 (`channel_moments`, batch_norm.py:115)."""
    xf = x.float().reshape(-1, x.shape[-1])
    return xf.sum(0), (xf * xf).sum(0)


def plain_channel_dot_sums(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (sum(a), sum(a*b)) over every axis but the last: the twin of
    kernel 8 (`channel_dot_sums`, batch_norm.py:133)."""
    af = a.float().reshape(-1, a.shape[-1])
    return af.sum(0), (af * b.float().reshape(-1, b.shape[-1])).sum(0)


def plain_bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
                   out_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, var[biased]) with the batch's statistics (batch_norm.py:158-170):
    fp32 mean and E[x^2] - mean^2 clamped at 0, the fp32 normalisation, one
    cast to `out_dtype` (default x's dtype). BatchNorm's training branch with
    the switch off; its gradient is autograd's."""
    xf = x.float()
    axes = tuple(range(x.dim() - 1))
    mean = xf.mean(dim=axes)
    var = torch.clamp(xf.square().mean(dim=axes) - mean.square(), min=0.0)
    inv = torch.rsqrt(var + eps) * scale.float()
    y = (xf - mean) * inv + bias.float()
    return y.to(out_dtype or x.dtype), mean, var


def plain_bn_train_bwd(x: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
                       inv: torch.Tensor, gy: torch.Tensor, gmean: Optional[torch.Tensor],
                       gvar: Optional[torch.Tensor], sums: Tuple[torch.Tensor, torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of the batch-statistics BatchNorm (`_fused_bwd`,
    batch_norm.py:210-232), from s1 = sum(gy) and s2 = sum(gy*x) (`sums`):

      dx = inv*scale * (gy - s1/n - xhat * sum(gy*xhat)/n)
           + gmean/n + gvar * 2(x - mean)/n
      dscale = sum(gy*xhat) = inv * (s2 - mean*s1),  dbias = s1

    gmean and gvar are the cotangents of the returned statistics (None where
    nothing reads them, which adds nothing). Returns (dx in x's dtype,
    dscale and dbias in scale's dtype)."""
    n = _n_rows(x)
    s1, s2 = sums
    sum_gy_xhat = inv * (s2 - mean * s1)
    xf = x.float()
    xhat = (xf - mean) * inv
    dx = (inv * scale.float()) * (gy.float() - s1 / n - xhat * sum_gy_xhat / n)
    if gmean is not None:
        dx = dx + gmean / n
    if gvar is not None:
        dx = dx + gvar * (2.0 / n) * (xf - mean)
    return dx.to(x.dtype), sum_gy_xhat.to(scale.dtype), s1.to(scale.dtype)


def _row_stride(t: torch.Tensor) -> Optional[int]:
    """The row stride of `t` seen as (n, C) rows of contiguous channels,
    evenly spaced and not overlapping, without a copy; None for any other
    layout."""
    c = t.shape[-1]
    if t.is_contiguous():
        return c
    try:
        rows = t.view(-1, c)
    except RuntimeError:
        return None
    if c > 1 and rows.stride(1) != 1:
        return None
    ld = rows.stride(0) if rows.shape[0] > 1 else c
    return ld if ld >= c else None


def _rows(name: str, t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """`t` and the stride of its (n, C) rows; raises for a layout or dtype
    the kernels do not take."""
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name} takes bf16 or fp32 tensors, got {t.dtype}")
    if t.dim() < 1 or t.shape[-1] == 0:
        raise ValueError(f"{name} needs a (..., C) tensor with C > 0, got {tuple(t.shape)}")
    ld = _row_stride(t)
    if ld is None:
        raise ValueError(f"{name} takes (..., C) tensors whose rows are evenly spaced with "
                         f"contiguous channels, got shape {tuple(t.shape)} strides {t.stride()}")
    return t, ld


# (library, n, C) -> the call's workspace: fp32 values and ticket counters
# (imt_bn_plan), asked once per shape
_PLANS: Dict[Tuple[str, int, int], Tuple[int, int]] = {}
# (device index, stream) -> the kernels' ticket counters, zeroed once: every
# call leaves them at zero, and calls on one stream run one after another.
# Process-wide, as the streams are: two callers on one stream share a
# buffer that neither can find in use.
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _launch(name: str, lib, fn, operands, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of kernel 7 or 8 on `operands` ([(tensor, row stride)]):
    one allocation, the workspace whose first 2C values are the sums. The
    kernel picks its loads' width from the operands' types and alignment."""
    t = operands[0][0]
    dev = t.device
    if dev.index != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return _launch(name, lib, fn, operands, c)
    n = t.numel() // c
    sizes = _PLANS.get((name, n, c))
    if sizes is None:
        if n == 0:
            raise ValueError(f"{name} needs at least one row")
        out = (ctypes.c_longlong * 2)()
        if lib.imt_bn_plan(n, c, out) != 0:
            raise ValueError(f"{name} does not take n={n}, C={c}")
        sizes = _PLANS[(name, n, c)] = (out[0], out[1])
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    tickets = _TICKETS.get((dev.index, stream))
    if tickets is None or tickets.numel() < sizes[1]:
        tickets = _TICKETS[(dev.index, stream)] = torch.zeros(max(sizes[1], 4096),
                                                              dtype=torch.int32, device=dev)
    work = torch.empty(sizes[0], dtype=torch.float32, device=dev)
    args = []
    for op, ld in operands:
        args += [op.data_ptr(), ld, _DTYPES[op.dtype]]
    err = fn(*args, n, c, work.data_ptr(), tickets.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.imt_cuda_error_string(err).decode()}")
    return work[:c], work[c:2 * c]


def fused_channel_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 7, the CUDA per-channel moments: fp32 (sum(x), sum(x^2)) of a
    bf16 or fp32 (..., C) CUDA tensor whose rows are evenly spaced with
    contiguous channels (a contiguous NHWC map, for one).

    Replaces `channel_moments` (ops/batch_norm.py:115). Raises on anything
    the kernel does not take, CPU tensors included.
    `fused_channel_moments.launches` counts launches."""
    if not x.is_cuda:
        raise ValueError("fused_channel_moments needs a CUDA tensor; CPU tensors go to the twin")
    return _moments(*_rows("fused_channel_moments", x))


def _moments(x: torch.Tensor, ld: int) -> Tuple[torch.Tensor, torch.Tensor]:
    lib = bn_moments_library()
    sums = _launch("bn_moments", lib, lib.imt_bn_moments, [(x, ld)], x.shape[-1])
    fused_channel_moments.launches += 1
    return sums


fused_channel_moments.launches = 0


def fused_channel_dot_sums(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 8, the CUDA per-channel dot sums: fp32 (sum(a), sum(a*b)) of two
    CUDA tensors of one (..., C) shape, each bf16 or fp32, each with evenly
    spaced rows of contiguous channels.

    Replaces `channel_dot_sums` (ops/batch_norm.py:133). Raises on anything
    the kernel does not take, CPU tensors included.
    `fused_channel_dot_sums.launches` counts launches."""
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError("fused_channel_dot_sums needs CUDA tensors on one device; CPU tensors "
                         "go to the twin")
    if a.shape != b.shape:
        raise ValueError(f"fused_channel_dot_sums: shapes {tuple(a.shape)} and {tuple(b.shape)} "
                         f"differ")
    return _dot_sums(_rows("fused_channel_dot_sums", a), _rows("fused_channel_dot_sums", b))


def _dot_sums(ra, rb) -> Tuple[torch.Tensor, torch.Tensor]:
    lib = bn_dot_sums_library()
    sums = _launch("bn_dot_sums", lib, lib.imt_bn_dot_sums, [ra, rb], ra[0].shape[-1])
    fused_channel_dot_sums.launches += 1
    return sums


fused_channel_dot_sums.launches = 0


def row_view(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when the kernels can read it in place (evenly spaced rows
    of contiguous channels); otherwise a contiguous copy."""
    return t if t.dim() and _row_stride(t) is not None else t.contiguous()


def _row_view(name: str, t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """`row_view(t)` and its row stride, the stride found once; raises for a
    dtype or shape the kernels do not take."""
    ld = _row_stride(t) if t.dim() else None
    if ld is None or t.dtype not in _DTYPES or t.shape[-1] == 0:
        return _rows(name, t if ld is not None else t.contiguous())
    return t, ld


def channel_moments(x: torch.Tensor, use_kernel: Optional[bool] = None):
    """fp32 (sum(x), sum(x^2)) per channel: kernel 7 for CUDA tensors, the
    twin for CPU tensors; `use_kernel` forces one."""
    if use_kernel is None:
        use_kernel = x.is_cuda
    if not use_kernel:
        return plain_channel_moments(x)
    if not x.is_cuda:
        raise ValueError("fused_channel_moments needs a CUDA tensor; CPU tensors go to the twin")
    return _moments(*_row_view("fused_channel_moments", x))


def channel_dot_sums(a: torch.Tensor, b: torch.Tensor, use_kernel: Optional[bool] = None):
    """fp32 (sum(a), sum(a*b)) per channel: kernel 8 for CUDA tensors, the
    twin for CPU tensors; `use_kernel` forces one."""
    if use_kernel is None:
        use_kernel = a.is_cuda
    if not use_kernel:
        return plain_channel_dot_sums(a, b)
    if not (a.is_cuda and b.is_cuda) or a.device != b.device or a.shape != b.shape:
        return fused_channel_dot_sums(a, b)  # raises, with the reason
    return _dot_sums(_row_view("fused_channel_dot_sums", a),
                     _row_view("fused_channel_dot_sums", b))


class BNTrainFunction(torch.autograd.Function):
    """The batch-statistics BatchNorm with the switch on (`fused_bn_train`,
    batch_norm.py:181-235): (y, mean, var[biased]). The forward statistics
    come from kernel 7 in mode "1"/"full" and from its twin in mode "bwd"
    (plain fp32 reductions on any device); the backward is
    `plain_bn_train_bwd` on kernel 8's sums in both. `use_kernel=False`
    takes the twins for both sums. Saves x, scale, mean and inv, as JAX's
    custom VJP does."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype, use_kernel):
        n = _n_rows(x)
        if _PALLAS_BN_MODE in ("1", "full"):
            s1, s2 = channel_moments(x, use_kernel)
        else:  # "bwd"
            s1, s2 = plain_channel_moments(x)
        mean = s1 / n
        var = torch.clamp(s2 / n - mean.square(), min=0.0)
        inv = torch.rsqrt(var + eps)
        y = ((x.float() - mean) * (inv * scale.float()) + bias.float()).to(out_dtype or x.dtype)
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.use_kernel = use_kernel
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, scale, mean, inv = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(x)
        sums = channel_dot_sums(gy, x, ctx.use_kernel)
        dx, dscale, dbias = plain_bn_train_bwd(x, scale, mean, inv, gy, gmean, gvar, sums)
        return dx, dscale, dbias, None, None, None


def bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
             out_dtype: Optional[torch.dtype] = None, use_kernel: Optional[bool] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, var[biased]) through `BNTrainFunction`: the kernels for CUDA
    tensors, the twins for CPU tensors; `use_kernel` forces one. For inputs
    that pass `use_fused_bn`."""
    return BNTrainFunction.apply(x, scale, bias, eps, out_dtype, use_kernel)


def use_fused_bn(x: torch.Tensor) -> bool:
    """Whether a train-mode BatchNorm takes `bn_train` (the JAX gate's
    semantic conditions, batch_norm.py:238-251): the switch on, a 4-D bf16 or
    fp32 activation, and n*C >= 2**18 (below that the launches cost more than
    the reduction). Raises on an unknown mode. The JAX gate's other tests (a
    row tile of at least 64 that divides n, and a 48 MiB bound on one tile's
    VMEM working set, :252-261) are the TPU kernel's tiling and have no
    counterpart here: the CUDA kernels take any n."""
    if _PALLAS_BN_MODE not in _MODES:
        raise ValueError(f"IMTPU_PALLAS_BN={_PALLAS_BN_MODE!r}: expected 0 (off, default), "
                         f"1/full (kernel forward statistics and backward sums) or bwd "
                         f"(backward sums only)")
    if _PALLAS_BN_MODE == "0" or x.dim() != 4 or x.dtype not in _DTYPES:
        return False
    return x.numel() >= (1 << 18)

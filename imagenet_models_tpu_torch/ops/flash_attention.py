"""Fused window attention: softmax(q k^T [+ bias]) v over many small windows
(CSWin's stripes, MaxViT's block and grid windows), the forward in one CUDA
kernel per call.

Port of imagenet_models_tpu/ops/flash_attention.py, the route the JAX
package takes with IMTPU_FLASH_ATTN=1 (read once at import into
`_FLASH_ATTN`; tests and chip_smoke.py set that attribute). Two hand-written
CUDA kernels compute the forward:

- kernel 12, `fused_window_attention` (`csrc/window_attn_fwd.cu`): q, k, v
  (BW, N, D), q pre-scaled, with an optional (BW, N, N) bias;
- kernel 13, `fused_window_attention_heads` (`csrc/window_attn_heads_fwd.cu`):
  q, k, v (BW, H, N, D) with one (H, N, N) bias shared by every window, never
  broadcast to the windows in device memory.

Beside them are their plain-PyTorch twins `plain_fused_window_attention` and
`plain_fused_window_attention_heads`, which have the kernels' numerics
(`_attn_body`, flash_attention.py:37-52): exact products of the input-dtype
operands with fp32 sums, the bias added in fp32, an fp32 softmax, p rounded
to the input dtype, p v with fp32 sums, one cast at the output.

There is no backward kernel, in JAX or here. As JAX's custom VJPs
(flash_attention.py:177-192, :211-228), the autograd functions
`WindowAttentionFunction` and `WindowAttentionHeadsFunction` save the inputs
and pull the cotangent back through autograd of a recompute. JAX recomputes
its composition; here the recompute is the kernel's own twin, so the
pullback is the derivative of the function the kernel computed. In fp32
the two are one function. In bf16 the composition rounds the scores to bf16
before the softmax and the score gradient before its products: through it,
a ga_cswin_tiny train step's gradients came out up to 1.241 times as far
from fp32 as the plain route's in one (stage, parameter) group, through the
twin 1.097 (H100). Kernel 13's pullback gives the bias its gradient, so the
rel-pos tables train.

The JAX kernels' padding of N to a multiple of 8 and D to 128, their -1e30
key mask and their window groups (`IMTPU_FLASH_GROUP`) are TPU tile
geometry; the CUDA kernels mask the ragged key chunk themselves.

Dispatch rule (as the partition attention's): a CPU tensor goes to the twin,
and autograd through it gives the gradient (JAX's CPU path is autodiff of
the composition, which in fp32 is the twin's function); a CUDA tensor goes to
the kernel, or raises. There is no fallback from a kernel to a twin.
`use_kernel=False` runs the twin on any device, to compare against.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional, Sequence, Tuple

import torch

# builds and loads nothing at import: each library is built at its first call
from imagenet_models_tpu_torch.ops import _kernels

# IMTPU_FLASH_ATTN: "1" = MaxViT's AttentionCl (where it is not given a
# partition) and CSWin's LePEAttention take kernels 12 and 13; "0" = their
# other routes: the default, as in the JAX package.
_FLASH_ATTN = os.environ.get("IMTPU_FLASH_ATTN", "0")

MAX_TOKENS = 256    # the kernels' largest window
MAX_HEAD_DIM = 128  # and widest head (a multiple of 8)
_DTYPES = (torch.bfloat16, torch.float32)


def plain_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX's composition (flash_attention.py:202-208): q, k, v (BW, N, D),
    q pre-scaled; scores out of the product in the input dtype, the bias
    added in fp32, softmax in fp32 cast to q's dtype, p v in the input
    dtype."""
    s = torch.einsum("bnd,bmd->bnm", q, k).float()
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bnm,bmd->bnd", p, v)


def plain_window_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 bias: torch.Tensor) -> torch.Tensor:
    """JAX's composition with a per-head shared bias (flash_attention.py:
    170-174): q, k, v (BW, H, N, D), bias (H, N, N)."""
    s = torch.einsum("bhnd,bhmd->bhnm", q, k).float() + bias.float()[None]
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", p, v)


def plain_fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 12's function in plain PyTorch, with its numerics: q, k, v
    (..., N, D), q pre-scaled, an optional bias that broadcasts to
    (..., N, N); returns (..., N, D) in q's dtype. The products run on fp32
    copies of the input-dtype operands, so they are exact with fp32 sums
    (TF32 must be off on a GPU). In fp32 this is `plain_window_attention`."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    return torch.matmul(p, v.float()).to(q.dtype)


def plain_fused_window_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                       bias: torch.Tensor) -> torch.Tensor:
    """Kernel 13's function in plain PyTorch: q, k, v (BW, H, N, D), bias
    (H, N, N) shared by every window; the numerics of
    `plain_fused_window_attention`."""
    return plain_fused_window_attention(q, k, v, bias[None])


def _check_operands(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    ndim: int) -> Tuple[int, Tuple[int, int, int], Tuple[int, ...]]:
    """Raises on q, k, v that no kernel build takes; returns their device's
    index, their data pointers and q's shape. Each check reads each
    attribute once: this runs on every launch, whose device time at a
    model's shapes is of the order of the host's."""
    if not q.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors; CPU tensors go to the plain twin")
    _check_shapes(name, q, k, v, ndim)
    dtype, shape = q.dtype, q.shape
    dev = q.get_device()
    if k.dtype != dtype or v.dtype != dtype or k.get_device() != dev or v.get_device() != dev:
        raise ValueError(f"{name}: q, k and v must share a dtype and a device")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if (not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous())
            or (ptrs[0] | ptrs[1] | ptrs[2]) % 16):
        raise ValueError(f"{name} takes contiguous, 16-byte aligned q, k, v")
    return dev, ptrs, tuple(shape)


def _check_shapes(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  ndim: int) -> None:
    """The checks of `_check_operands` that read no data (a fake function's)."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes bf16 or fp32 q, k, v, got {q.dtype}")
    if q.dim() != ndim or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name} takes q, k, v of one {ndim}-d shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")


def _check_window(name: str, supported: Callable[[int, int], int], n: int, d: int) -> None:
    """Raises unless the kernel's own check takes windows of n tokens and
    heads of d channels."""
    if not supported(n, d):
        raise ValueError(f"{name} takes windows of 1..{MAX_TOKENS} tokens and heads of 8.."
                         f"{MAX_HEAD_DIM} channels in steps of 8, got N={n}, D={d}")


def _check_bias(name: str, bias: torch.Tensor, shape: Tuple[int, ...],
                q: torch.Tensor) -> torch.Tensor:
    if tuple(bias.shape) != shape or bias.device != q.device:
        raise ValueError(f"{name}: bias must be {shape} on q's device, got "
                         f"{tuple(bias.shape)} on {bias.device}")
    return bias.float().contiguous()


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.imt_cuda_error_string(err).decode()}")


@functools.lru_cache(maxsize=None)
def _window_supported(n: int, d: int) -> int:
    """Kernel 12's own check of a window shape (`imt_window_attn_fwd_supported`),
    a function of the shape alone, asked once a shape."""
    return _kernels.window_attn_fwd_library().imt_window_attn_fwd_supported(n, d)


@torch.library.custom_op("imtpu::window_attn_fwd", mutates_args=())
def _window_attn_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The op `imtpu::window_attn_fwd`: kernel 12's checks, launch and count
    (`fused_window_attention.launches`). Raises on CPU tensors: there is no
    CPU registration, the caller picks the twin for those."""
    name = "fused_window_attention"
    dev, (pq, pk, pv), (bw, n, d) = _check_operands(name, q, k, v, 3)
    lib = _kernels.window_attn_fwd_library()
    _check_window(name, _window_supported, n, d)
    if bias is not None:
        bias = _check_bias(name, bias, (bw, n, n), q)
    out = torch.empty_like(q)
    if bw == 0:
        return out
    err = _kernels.launch(lib.imt_window_attn_fwd, dev, pq, pk, pv,
                          None if bias is None else bias.data_ptr(), out.data_ptr(), bw, n, d,
                          int(q.dtype == torch.bfloat16))
    _raise_on(lib, err, "window_attn_fwd")
    fused_window_attention.launches += 1
    return out


@_window_attn_fwd_op.register_fake
def _window_attn_fwd_fake(q, k, v, bias):
    """What kernel 12 writes, from shapes alone: contiguous (BW, N, D) of
    q's dtype."""
    _check_shapes("fused_window_attention", q, k, v, 3)
    return q.new_empty(q.shape)


_WINDOW_ATTN_FWD = torch.ops.imtpu.window_attn_fwd.default


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 12, the CUDA fused window attention, on contiguous bf16 or fp32
    (BW, N, D) q, k, v (q pre-scaled) and an optional (BW, N, N) bias (used in
    fp32); returns (BW, N, D) in q's dtype. Called through the custom op
    `imtpu::window_attn_fwd`, which `torch.export` traces by its fake
    function.

    Replaces `fused_window_attention` (ops/flash_attention.py:64). In bf16
    its products run on the tensor cores, whose fp32 sums take another order
    than the twin's, so the two may round p or the output to neighbouring
    bf16 values (fp32 keeps the twin's arithmetic). Raises on anything the
    kernel does not take, CPU tensors included.
    `fused_window_attention.launches` counts launches."""
    return _WINDOW_ATTN_FWD(q, k, v, bias)


fused_window_attention.launches = 0


@torch.library.custom_op("imtpu::window_attn_heads_fwd", mutates_args=())
def _window_attn_heads_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """The op `imtpu::window_attn_heads_fwd`: kernel 13's checks, launch and
    count (`fused_window_attention_heads.launches`). Raises on CPU tensors:
    there is no CPU registration, the caller picks the twin for those."""
    name = "fused_window_attention_heads"
    dev, (pq, pk, pv), (bw, heads, n, d) = _check_operands(name, q, k, v, 4)
    lib = _kernels.window_attn_heads_fwd_library()
    _check_window(name, lib.imt_window_attn_heads_fwd_supported, n, d)
    bias = _check_bias(name, bias, (heads, n, n), q)
    out = torch.empty_like(q)
    if bw == 0 or heads == 0:
        return out
    err = _kernels.launch(lib.imt_window_attn_heads_fwd, dev, pq, pk, pv, bias.data_ptr(),
                          out.data_ptr(), bw, heads, n, d, int(q.dtype == torch.bfloat16))
    _raise_on(lib, err, "window_attn_heads_fwd")
    fused_window_attention_heads.launches += 1
    return out


@_window_attn_heads_fwd_op.register_fake
def _window_attn_heads_fwd_fake(q, k, v, bias):
    """What kernel 13 writes, from shapes alone: contiguous (BW, H, N, D) of
    q's dtype."""
    _check_shapes("fused_window_attention_heads", q, k, v, 4)
    return q.new_empty(q.shape)


_WINDOW_ATTN_HEADS_FWD = torch.ops.imtpu.window_attn_heads_fwd.default


def fused_window_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 bias: torch.Tensor) -> torch.Tensor:
    """Kernel 13, the CUDA fused window attention with a per-head shared bias,
    on contiguous bf16 or fp32 (BW, H, N, D) q, k, v (q pre-scaled) and an
    (H, N, N) bias (used in fp32); returns (BW, H, N, D) in q's dtype. Called
    through the custom op `imtpu::window_attn_heads_fwd`, which
    `torch.export` traces by its fake function.

    Replaces `fused_window_attention_heads` (ops/flash_attention.py:134).
    In bf16 its products run on the tensor cores, whose fp32 sums take
    another order than the twin's, so the two may round p or the output to
    neighbouring bf16 values (fp32 keeps the twin's arithmetic). Raises on
    anything the kernel does not take, CPU tensors included.
    `fused_window_attention_heads.launches` counts launches."""
    return _WINDOW_ATTN_HEADS_FWD(q, k, v, bias)


fused_window_attention_heads.launches = 0


def _pullback(fn: Callable, inputs: Sequence[Optional[torch.Tensor]], g: torch.Tensor,
              needs: Sequence[bool]) -> Tuple[Optional[torch.Tensor], ...]:
    """The vector-Jacobian product of `fn` at `inputs` with `g`, by autograd
    of a recompute: a gradient for each input that needs one, else None."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(bool(need))
                  for t, need in zip(inputs, needs)]
        wrt = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(fn(*leaves), wrt, g) if wrt else ())
    return tuple(next(grads) if t is not None and t.requires_grad else None for t in leaves)


class WindowAttentionFunction(torch.autograd.Function):
    """Window attention on CUDA: kernel 12 forward; the backward is autograd
    of its twin `plain_fused_window_attention` recomputed from the saved
    inputs (JAX's `_fused_diff_bwd`, flash_attention.py:219-225, recomputes
    the composition)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return fused_window_attention(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        return _pullback(plain_fused_window_attention, ctx.saved_tensors, g,
                         ctx.needs_input_grad)


class WindowAttentionHeadsFunction(torch.autograd.Function):
    """Window attention with a per-head bias on CUDA: kernel 13 forward; the
    backward is autograd of its twin `plain_fused_window_attention_heads`
    recomputed from the saved inputs (dbias summed over the windows; JAX's
    `_fused_heads_bwd`, flash_attention.py:185-189, recomputes the
    composition)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return fused_window_attention_heads(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        return _pullback(plain_fused_window_attention_heads, ctx.saved_tensors, g,
                         ctx.needs_input_grad)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """softmax(q k^T [+ bias]) v over (BW, N, D) windows, q pre-scaled, with an
    optional (BW, N, N) bias (flash_attention.py:231-246): kernel 12 for CUDA
    tensors, the twin for CPU tensors; `use_kernel` forces one.
    Differentiable either way."""
    if use_kernel is None:
        use_kernel = q.is_cuda
    if not use_kernel:
        return plain_fused_window_attention(q, k, v, bias)
    return WindowAttentionFunction.apply(q.contiguous(), k.contiguous(), v.contiguous(), bias)


def window_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, use_kernel: Optional[bool] = None) -> torch.Tensor:
    """softmax(q k^T + bias[h]) v over (BW, H, N, D) windows, q pre-scaled,
    with an (H, N, N) bias shared by the windows (flash_attention.py:195-199):
    kernel 13 for CUDA tensors, the twin for CPU tensors; `use_kernel` forces
    one. Differentiable either way."""
    if use_kernel is None:
        use_kernel = q.is_cuda
    if not use_kernel:
        return plain_fused_window_attention_heads(q, k, v, bias)
    return WindowAttentionHeadsFunction.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                              bias)

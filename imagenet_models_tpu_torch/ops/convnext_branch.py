"""The fully fused ConvNeXt branch: depthwise 7x7 -> LayerNorm -> Linear(4C)
-> exact GELU -> Linear(C) -> layer scale, forward and backward each in one
hand-written CUDA kernel.

Port of imagenet_models_tpu/ops/convnext_branch.py. The JAX package keeps that
module as an experiment that no model calls (its docstring, :1-18): its
public entry `convnext_branch_apply` is the route, and this module's is its
counterpart. No model of the port calls it either.

- kernel 10, `fused_convnext_branch` (`csrc/convnext_branch_fwd.cu`): the
  branch's forward on a (B, H, W, C) NHWC map of bf16 or fp32; in bf16 a
  conv + LayerNorm prologue (`csrc/convnext_branch_ring.cuh`) and kernel 1's
  two wgmma + TMA GEMM stages;
- kernel 11, `fused_convnext_branch_bwd` (`csrc/convnext_branch_bwd.cu`): the
  forward recomputed, then dx and every parameter's gradient; in bf16 the
  same prologue, kernel 2's GEMM stages and a conv-backward stage.

Beside them are their plain-PyTorch twins `plain_convnext_branch` and
`plain_convnext_branch_bwd`, which have the kernels' numerics (the TPU
kernels' `_fwd_kernel` and `_bwd_kernel`, :74-191): the conv in fp32 from the
upcast x (so h is never rounded to x's type), LayerNorm in fp32, the tokens,
the GELU output and the two pre-activation gradients cast to the compute type
(x's; the cotangent's in the backward) before each product, every product on
fp32 copies of those operands (exact, with fp32 sums), the exact GELU with the
A&S erf (`_erf_poly`, `gelu_grad`), and the tap and bias gradients as fp32
sums of fp32 products of x and dh (not kernel 9's bf16-rounded products).
`ConvNeXtBranchFunction` joins the kernels as JAX's custom VJP does
(:290-306): it saves only x and the parameters, and the backward recomputes.

`convnext_branch_apply` dispatches as JAX's (:312-337): `use_kernel=False`,
or a CPU tensor, takes the plain composition (`dw_conv7` + `plain_ln_mlp`
with the exact GELU under autograd, the port's copy of JAX's
`plain_convnext_block`, which JAX's CPU branch runs); a CUDA tensor takes
`ConvNeXtBranchFunction` or raises. There is no fallback from a kernel to a
twin.

Layouts are the port's, as `convnext_block_apply` takes them: x NHWC, the
depthwise weight (C, 1, 7, 7) (tap (ky, kx) at [c, 0, ky, kx], JAX's (7, 7,
1, C) transposed), Linear weights (out, in), so a `ConvNeXtBlock`'s own
parameters feed it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from imagenet_models_tpu_torch.ops.convnext_block import _erf_poly, _workspace, gelu_grad, plain_ln_mlp
from imagenet_models_tpu_torch.ops.dw_conv import dw_conv7

K = 7  # kernel extent (dw 7x7)
PAD = K // 2
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # the kernels' operand type codes
GRAD_NAMES = ("dx", "ddw_w", "ddw_b", "dln_s", "dln_b", "dw1", "db1", "dw2", "db2", "dgamma")


def _taps(dw_w: torch.Tensor) -> torch.Tensor:
    """The (C, 1, 7, 7) depthwise weight as (49, C) fp32 taps, tap ky * 7 + kx:
    the TPU kernel's `dww` (C last)."""
    c = dw_w.shape[0]
    return dw_w.reshape(c, K * K).t().float().contiguous()


def _dw_fp32(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernels' depthwise conv: fp32 from the upcast x, the bias first and
    then the 49 taps in row-major order (`_dw_taps_ref`, :47-63)."""
    b, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, PAD, PAD, PAD, PAD))
    acc = bias.float().expand(b, h, w, c).clone()
    for ky in range(K):
        for kx in range(K):
            acc += xp[:, ky:ky + h, kx:kx + w, :] * taps[ky * K + kx]
    return acc


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU with the A&S erf (:88), in fp32."""
    return 0.5 * x * (1.0 + _erf_poly(x * 2.0 ** -0.5))


def _ln(hf: torch.Tensor, eps: float):
    """LayerNorm statistics of (N, C) fp32 rows (`_ln_fwd`, :66-71): (xhat, rstd)."""
    mu = hf.mean(dim=-1, keepdim=True)
    var = (hf - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (hf - mu) * rstd, rstd


def _conv_bwd(x: torch.Tensor, dh: torch.Tensor, taps: torch.Tensor):
    """The conv's gradients from the fp32 cotangent dh of h (:168-191): dx, the
    fp32 correlation of dh with the flipped taps (dx[y] = sum over taps of
    dh[y + 3 - ky] * w[ky]), and the (C, 1, 7, 7) tap gradient, fp32 sums of
    the fp32 products x[y + ky - 3] * dh[y]."""
    b, h, w, c = x.shape
    dhp = F.pad(dh, (0, 0, PAD, PAD, PAD, PAD))
    xp = F.pad(x.float(), (0, 0, PAD, PAD, PAD, PAD))
    dx = torch.zeros_like(dh)
    tap_grads = []
    for ky in range(K):
        for kx in range(K):
            dx += dhp[:, 2 * PAD - ky:2 * PAD - ky + h, 2 * PAD - kx:2 * PAD - kx + w, :] \
                * taps[ky * K + kx]
            tap_grads.append((xp[:, ky:ky + h, kx:kx + w, :] * dh).sum(dim=(0, 1, 2)))
    return dx, torch.stack(tap_grads, dim=1).reshape(c, 1, K, K)


def plain_convnext_branch(x: torch.Tensor, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma,
                          eps: float = 1e-6) -> torch.Tensor:
    """The branch's forward in plain PyTorch: the twin of kernel 10 and of the
    TPU kernel `_fwd_kernel` (:74-92). x (B, H, W, C) NHWC; returns x's dtype.

    The conv in fp32; LayerNorm in fp32; the tokens cast to x's type; Dense(4C)
    on fp32 copies of x-type operands (exact products, fp32 sums; TF32 must be
    off on a GPU) + b1; the exact GELU in fp32, cast; Dense(C) likewise + b2;
    * gamma in fp32; one final cast."""
    dt = x.dtype
    b, h, w, c = x.shape
    hf = _dw_fp32(x, _taps(dw_w), dw_b).reshape(-1, c)
    xhat, _ = _ln(hf, eps)
    tokens = (xhat * ln_s.float() + ln_b.float()).to(dt).float()
    pre1 = F.linear(tokens, w1.to(dt).float(), b1.float())
    hmid = _gelu(pre1).to(dt).float()
    out = F.linear(hmid, w2.to(dt).float(), b2.float())
    return (out * gamma.float()).to(dt).reshape(b, h, w, c)


def plain_convnext_branch_bwd(x: torch.Tensor, g: torch.Tensor, dw_w, dw_b, ln_s, ln_b, w1, b1,
                              w2, b2, gamma, eps: float = 1e-6) -> Tuple[torch.Tensor, ...]:
    """The branch's backward in plain PyTorch: the twin of kernel 11 and of the
    TPU kernel `_bwd_kernel` (:95-191).

    Recomputes the forward from x, pulls the cotangent g (x's shape) back
    through gamma, the MLP (:127-136), LayerNorm (:138-144) and the conv
    (:168-191). `tokens`, `hmid_c`, `dpre2` and `dpre1` are cast to g's dtype
    before each product, as the TPU kernel casts them (:114, :120, :131-136);
    dgamma sums g * pre2 with pre2 = hmid_c W2^T + b2 in fp32; dx is the fp32
    correlation of dh with the flipped taps, cast to x's dtype; the tap and
    bias gradients are fp32 sums of fp32 products. Returns GRAD_NAMES' ten
    gradients, each in its input's dtype, in the port's layouts."""
    dt, cdt = x.dtype, g.dtype
    b, h, w, c = x.shape
    taps = _taps(dw_w)
    hf = _dw_fp32(x, taps, dw_b).reshape(-1, c)
    xhat, rstd = _ln(hf, eps)
    s = ln_s.float()
    tokens = (xhat * s + ln_b.float()).to(cdt).float()
    w1f = w1.to(dt).float()
    w2f = w2.to(dt).float()
    pre1 = F.linear(tokens, w1f, b1.float())
    hmid_c = _gelu(pre1).to(cdt).float()
    pre2 = F.linear(hmid_c, w2f, b2.float())

    gf = g.reshape(-1, c).float()
    dgamma = (gf * pre2).sum(0)
    dpre2 = gf * gamma.float()
    db2 = dpre2.sum(0)
    dpre2_c = dpre2.to(cdt).float()
    dw2 = dpre2_c.t() @ hmid_c
    dpre1 = (dpre2_c @ w2f) * gelu_grad(pre1)
    db1 = dpre1.sum(0)
    dpre1_c = dpre1.to(cdt).float()
    dw1 = dpre1_c.t() @ tokens
    dln = dpre1_c @ w1f
    dln_s = (dln * xhat).sum(0)
    dln_b = dln.sum(0)
    dxhat = dln * s
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dh = (rstd * (dxhat - m1 - xhat * m2)).reshape(b, h, w, c)

    dx, ddw_w = _conv_bwd(x, dh, taps)
    grads = (ddw_w, dh.sum(dim=(0, 1, 2)), dln_s, dln_b, dw1, db1, dw2, db2, dgamma)
    params = (dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma)
    return (dx.to(dt),) + tuple(d.to(p.dtype) for d, p in zip(grads, params))


def _operands(name: str, x: torch.Tensor, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """Checks x and the parameters against what the kernels take, and returns
    the (49, C) fp32 taps, the weights in x's dtype and the vectors in fp32,
    all contiguous."""
    if not x.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors; CPU tensors go to the plain twin")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes bf16 or fp32 maps, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} takes a contiguous (B, H, W, C) NHWC map with a 16-byte "
                         f"aligned start, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    hidden = w1.shape[0]
    if dw_w.shape != (c, 1, K, K) or w1.shape != (hidden, c) or w2.shape != (c, hidden):
        raise ValueError(f"weights {tuple(dw_w.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)} do "
                         f"not fit C={c}")
    params = (dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma)
    if any(p.device != x.device for p in params):
        raise ValueError(f"{name}: all tensors must be on one device")
    vecs = [v.float().contiguous() for v in (dw_b, ln_s, ln_b, b1, b2, gamma)]
    for v, size in zip(vecs, (c, c, c, hidden, c, c)):
        if v.numel() != size:
            raise ValueError(f"vector of {v.numel()} values where {size} are needed")
    return _taps(dw_w), w1.to(x.dtype).contiguous(), w2.to(x.dtype).contiguous(), vecs


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.imt_cuda_error_string(err).decode()}")


# kernel 10's stages in bf16, as imt_convnext_branch_fwd numbers them (its
# fp32 instance is one launch)
FWD_STAGES = ("conv_ln", "hidden", "output")


def _fwd_call(x: torch.Tensor, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma, eps: float):
    """One call of kernel 10, checked and prepared: (out, run), where
    run(first, last) launches stages [first, last) of FWD_STAGES (bf16; a
    stage run alone reads what the stages before it left in the workspace)
    or, in fp32, the one launch."""
    taps, w1, w2, (dwb, s, lb, bb1, bb2, gm) = _operands(
        "fused_convnext_branch", x, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma)
    from imagenet_models_tpu_torch.ops._kernels import convnext_branch_fwd_library

    lib = convnext_branch_fwd_library()
    b, h, w, c = x.shape
    hidden = w1.shape[0]
    code = _DTYPES[x.dtype]
    nbytes = lib.imt_convnext_branch_fwd_workspace_bytes(b, h, w, c, hidden, code) if x.numel() else 1
    if nbytes <= 0 or not lib.imt_convnext_branch_fwd_supported(c, hidden, code):
        raise ValueError(f"fused_convnext_branch does not take C={c}, hidden={hidden} in "
                         f"{x.dtype}")
    out = torch.empty_like(x)
    workspace = _workspace(nbytes, x.device)
    args = (x.data_ptr(), taps.data_ptr(), dwb.data_ptr(), s.data_ptr(), lb.data_ptr(),
            w1.data_ptr(), bb1.data_ptr(), w2.data_ptr(), bb2.data_ptr(), gm.data_ptr(),
            out.data_ptr(), workspace.data_ptr(), code, b, h, w, c, hidden, float(eps))
    keep = (taps, w1, w2, dwb, s, lb, bb1, bb2, gm, workspace)  # alive as long as `run`

    def run(first: int = 0, last: int = len(FWD_STAGES)) -> None:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.imt_convnext_branch_fwd(*args, first, last, stream)
        _raise_on(lib, err, "convnext_branch_fwd")

    run.keep = keep
    return out, run


def convnext_branch_fwd_pipeline(x: torch.Tensor, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma,
                                 eps: float = 1e-6):
    """Kernel 10 run once through all its stages; returns its `run(first,
    last)`, so that each stage can be launched again on its own: for timing
    the bf16 pipeline stage by stage. Not counted in
    `fused_convnext_branch.launches`."""
    _, run = _fwd_call(x, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma, eps)
    run()
    return run


def fused_convnext_branch(x: torch.Tensor, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma,
                          eps: float = 1e-6) -> torch.Tensor:
    """Kernel 10, the CUDA branch forward, on a contiguous (B, H, W, C) NHWC
    CUDA map of bf16 or fp32 with C a multiple of 16 up to 1024; returns x's
    dtype.

    Replaces `_branch_fwd_pallas` (ops/convnext_branch.py:213). Weights in the
    port's layout, cast to x's dtype here as JAX casts them; vectors fp32.
    bf16 is a pipeline (FWD_STAGES, csrc/convnext_branch_fwd.cu): the conv
    and LayerNorm, then kernel 1's two GEMM stages, over a workspace from the
    caching allocator; fp32 is one launch. Raises on anything the kernel does
    not take, CPU tensors included. `fused_convnext_branch.launches` counts
    calls that launched it."""
    out, run = _fwd_call(x, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma, eps)
    if out.numel() == 0:
        return out
    run()
    fused_convnext_branch.launches += 1
    return out


fused_convnext_branch.launches = 0


# kernel 11's stages in bf16, as imt_convnext_branch_bwd numbers them (its
# fp32 instance runs them all in one call)
BWD_STAGES = ("conv_ln", "hidden", "dln", "wgrad", "conv_bwd")


def _bwd_call(x: torch.Tensor, g: torch.Tensor, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma,
              eps: float):
    """One call of kernel 11, checked and prepared: (gradients, run), where
    run(first, last) launches stages [first, last) of BWD_STAGES (bf16; a
    stage run alone reads what the stages before it left in the workspace)
    or, in fp32, the whole backward. The gradients are GRAD_NAMES' ten as
    the kernel writes them (dx in x's dtype, the others fp32), filled by a
    run of every stage."""
    taps, w1c, w2c, (dwb, s, lb, bb1, bb2, gm) = _operands(
        "fused_convnext_branch_bwd", x, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("fused_convnext_branch_bwd takes a contiguous cotangent with a 16-byte "
                         "aligned start")
    from imagenet_models_tpu_torch.ops._kernels import convnext_branch_bwd_library

    lib = convnext_branch_bwd_library()
    b, h, w, c = x.shape
    hidden = w1c.shape[0]
    code = _DTYPES[x.dtype]
    dev = x.device
    with torch.cuda.device(dev):  # the bf16 plan follows the card's SM count
        nbytes = lib.imt_convnext_branch_bwd_workspace_bytes(b, h, w, c, hidden, code)
    if nbytes <= 0 or not lib.imt_convnext_branch_bwd_supported(c, hidden, code):
        raise ValueError(f"fused_convnext_branch_bwd does not take (B, H, W, C) = "
                         f"{tuple(x.shape)}, hidden={hidden} in {x.dtype}")
    workspace = _workspace(nbytes, dev)
    dx = torch.empty_like(x)
    ddw = torch.empty(c, 1, K, K, dtype=torch.float32, device=dev)
    dw1 = torch.empty(hidden, c, dtype=torch.float32, device=dev)
    dw2 = torch.empty(c, hidden, dtype=torch.float32, device=dev)
    vecs = torch.empty(hidden + 5 * c, dtype=torch.float32, device=dev)
    args = (x.data_ptr(), g.data_ptr(), taps.data_ptr(), dwb.data_ptr(), s.data_ptr(),
            lb.data_ptr(), w1c.data_ptr(), bb1.data_ptr(), w2c.data_ptr(), bb2.data_ptr(),
            gm.data_ptr(), dx.data_ptr(), ddw.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
            vecs.data_ptr(), workspace.data_ptr(), code, b, h, w, c, hidden, float(eps))
    keep = (taps, w1c, w2c, dwb, s, lb, bb1, bb2, gm, workspace)  # alive as long as `run`

    def run(first: int = 0, last: int = len(BWD_STAGES)) -> None:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.imt_convnext_branch_bwd(*args, first, last, stream)
        _raise_on(lib, err, "convnext_branch_bwd")

    run.keep = keep
    db1, db2, dgamma, dln_s, dln_b, ddw_b = torch.split(vecs, [hidden, c, c, c, c, c])
    return (dx, ddw, ddw_b, dln_s, dln_b, dw1, db1, dw2, db2, dgamma), run


def convnext_branch_bwd_pipeline(x: torch.Tensor, g: torch.Tensor, dw_w, dw_b, ln_s, ln_b, w1,
                                 b1, w2, b2, gamma, eps: float = 1e-6):
    """Kernel 11 run once through all its stages; returns its `run(first,
    last)`, so that each stage can be launched again on its own: for timing
    the bf16 pipeline stage by stage. Not counted in
    `fused_convnext_branch_bwd.launches`."""
    _, run = _bwd_call(x, g, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma, eps)
    run()
    return run


def fused_convnext_branch_bwd(x: torch.Tensor, g: torch.Tensor, dw_w, dw_b, ln_s, ln_b, w1, b1,
                              w2, b2, gamma, eps: float = 1e-6) -> Tuple[torch.Tensor, ...]:
    """Kernel 11, the CUDA branch backward, on x and the cotangent g: contiguous
    (B, H, W, C) NHWC CUDA maps of one dtype, bf16 or fp32. Returns
    GRAD_NAMES' ten gradients as `plain_convnext_branch_bwd` does: dx in x's
    dtype, the others in their parameter's (the kernel sums in fp32), the tap
    and weight gradients the same bits on every run.

    Replaces `_branch_bwd_pallas` (ops/convnext_branch.py:242). bf16 is a
    pipeline (BWD_STAGES, csrc/convnext_branch_bwd.cu): the conv and
    LayerNorm, kernel 2's GEMM stages and the conv's backward, over a
    workspace from the caching allocator. Raises on anything the kernel does
    not take. `fused_convnext_branch_bwd.launches` counts calls that
    launched it."""
    grads, run = _bwd_call(x, g, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma, eps)
    run()
    fused_convnext_branch_bwd.launches += 1
    params = (dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma)
    return grads[:1] + tuple(d.to(p.dtype) for d, p in zip(grads[1:], params))


fused_convnext_branch_bwd.launches = 0


class ConvNeXtBranchFunction(torch.autograd.Function):
    """The branch on CUDA: kernel 10 forward, kernel 11 as its backward.

    Saves only x and the parameters, as JAX's custom VJP does
    (ops/convnext_branch.py:300-306); the backward recomputes the forward, so
    nothing of the (N, 4C) hidden is kept between the two."""

    @staticmethod
    def forward(ctx, x, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma, eps):
        ctx.save_for_backward(x, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma)
        ctx.eps = eps
        return fused_convnext_branch(x, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma, eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        return fused_convnext_branch_bwd(saved[0], g.contiguous(), *saved[1:], ctx.eps) + (None,)


def plain_branch(x: torch.Tensor, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma,
                 eps: float = 1e-6) -> torch.Tensor:
    """The plain composition, JAX's `plain_convnext_block` (ops/convnext_block.py:
    549-554) in the port: `dw_conv7` then `plain_ln_mlp` with the exact GELU,
    under autograd."""
    return plain_ln_mlp(dw_conv7(x, dw_w, dw_b), ln_s, ln_b, w1, b1, w2, b2, gamma, eps,
                        gelu_impl="exact")


def convnext_branch_apply(x: torch.Tensor, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2,
                          gamma: Optional[torch.Tensor], eps: float = 1e-6,
                          use_kernel: Optional[bool] = None) -> torch.Tensor:
    """The pre-residual ConvNeXt branch on NHWC `x` (ops/convnext_branch.py:
    312-337): kernels 10 and 11 (`ConvNeXtBranchFunction`) for a CUDA tensor,
    the plain composition for a CPU tensor or with `use_kernel=False`.
    `gamma=None` means ones. Weights in the port's layout: dw_w (C, 1, 7, 7),
    w1 (4C, C), w2 (C, 4C)."""
    if gamma is None:
        gamma = torch.ones(x.shape[-1], device=x.device)
    if use_kernel is None:
        use_kernel = x.is_cuda
    if not use_kernel:
        return plain_branch(x, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma, eps)
    return ConvNeXtBranchFunction.apply(x.contiguous(), dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2,
                                        gamma, eps)

"""ConvNeXt block compute: depthwise 7x7 conv, then the fused LayerNorm ->
Dense(4C) -> GELU -> Dense(C) -> layer-scale, forward and backward.

Port of imagenet_models_tpu/ops/convnext_block.py. The depthwise conv stays
with the framework (`F.conv2d`, as it is XLA's in JAX); with IMTPU_DW_WGRAD
at "1" its weight gradient is kernel 9 (`ops/dw_conv.py`). The LN+MLP is two
hand-written CUDA kernels, each a pipeline of a row-wise stage and GEMM-shaped
stages on Hopper's wgmma and TMA: the forward, kernel 1 (`csrc/ln_mlp_fwd.cu`,
wrapper `fused_ln_mlp`, stage by stage `ln_mlp_fwd_pipeline`) and the
backward, kernel 2 (`csrc/ln_mlp_bwd.cu`, wrapper `fused_ln_mlp_bwd`, stage by
stage `ln_mlp_bwd_pipeline`), joined by the autograd function
`LnMlpFunction`. Beside them are their plain-PyTorch twins `plain_ln_mlp` and
`plain_ln_mlp_bwd`, which have the kernels' numerics.

GELU: "exact" (erf) at eval, "fast" (the single-segment minimax fit of erf,
and of the GELU derivative in the backward) in training, as
`resolve_gelu_impl` picks it; IMTPU_GELU forces one of the two for both.

The transformer blocks' norm2 + MLP pair takes the same kernels with a unit
layer scale through `ln_mlp_apply`, where `use_transformer_lnmlp` allows it
(IMTPU_TLNMLP at "1", read once at import into `_TLNMLP`).

Dispatch rule: a CPU tensor goes to the twin, with autograd through it (JAX's
CPU path is autodiff of its plain ops); a CUDA tensor goes to the kernels, or
raises. There is no fallback from a kernel to a twin. `use_kernel=False` runs
the twin on any device, to compare against. The kernels take bf16 tokens and,
for fp32 models, fp32 tokens: each has an fp32 instance (`csrc/ln_mlp_f32.cuh`)
with no cast to bf16, as the TPU kernels run an fp32 map.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from imagenet_models_tpu_torch.nn.checkpoint import checkpoint_call
from imagenet_models_tpu_torch.ops import dw_conv as dw_ops
from imagenet_models_tpu_torch.ops.dw_conv import DwConv7Function, dw_conv7

GELU_IMPLS = ("exact", "fast")

# IMTPU_TLNMLP: "1" = a transformer block's norm2 + MLP pair (MaxViT's
# PartitionAttention, CSWinBlock) takes the LN+MLP kernels 1 and 2 with a unit
# layer scale, through `ln_mlp_apply`; "0" = LayerNorm and Mlp modules: the
# default, as in the JAX package.
_TLNMLP = os.environ.get("IMTPU_TLNMLP", "0")

# The three switches of the JAX block (ops/convnext_block.py:533-541,
# :590-602, :621-630), read once at import with JAX's defaults:
# IMTPU_FUSED_BWD "0" = the LN+MLP backward is the plain VJP (autograd of
# `plain_ln_mlp`) by the user's choice, kernel 2 otherwise; IMTPU_PALLAS_MIN_C
# = blocks with fewer channels take the plain path (0: none);
# IMTPU_BLOCK_REMAT non-"0" = the plain path's block is recomputed in the
# backward (a memory knob, `convnext_block_apply`'s `remat`).
_FUSED_BWD = os.environ.get("IMTPU_FUSED_BWD", "1") != "0"
_PALLAS_MIN_C = int(os.environ.get("IMTPU_PALLAS_MIN_C", "0"))
_REMAT = os.environ.get("IMTPU_BLOCK_REMAT", "0") != "0"
# IMTPU_GELU (ops/convnext_block.py:141-146), read once at import: "exact" or
# "fast" forces that GELU for both modes, in training too (JAX's
# scripts/convergence_gelu_ab.sh sets "exact"); "" = JAX's default, the fast
# fit in training and exact erf at eval. `resolve_gelu_impl` reads it.
_GELU_ENV = os.environ.get("IMTPU_GELU", "")


def _horner(t: torch.Tensor, coefs) -> torch.Tensor:
    r = torch.full_like(t, coefs[-1])
    for c in coefs[-2::-1]:
        r = r * t + c
    return r


# Single-segment odd minimax fits (ops/convnext_block.py:111-129):
#   erf(z) ~ z*P8((z/2.75)^2) on |z| <= 2.75, clamped beyond (max err 1.3e-4);
#   gelu'(x) - 0.5 ~ x*Q10((x/5)^2) on |x| <= 5, clamped (max err 1.9e-4).
_ERF_F8 = (1.128179019700242, -2.833873458377666, 6.288517611119356,
           -10.440794928636649, 12.424005344159935, -9.860067339137903,
           4.602827094685715, -0.9452048310751889)
_GG_F10 = (0.7970334043621504, -6.5780944269226085, 35.6419098348847,
           -127.98971343596055, 315.66741178811344, -535.3888724157551,
           610.367501707186, -444.740199037125, 186.4500761464462,
           -34.12709029923767)


def erf_fast(z: torch.Tensor) -> torch.Tensor:
    a = torch.clamp(z.abs(), max=2.75)
    return torch.sign(z) * (a * _horner(torch.square(a * (1.0 / 2.75)), _ERF_F8))


def gelu_grad_fast(x: torch.Tensor) -> torch.Tensor:
    a = torch.clamp(x.abs(), max=5.0)
    return 0.5 + torch.sign(x) * (a * _horner(torch.square(a * (1.0 / 5.0)), _GG_F10))


def _erf_poly(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 erf, |err| < 1.5e-7 (ops/convnext_block.py:31-39)."""
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-a * a))


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the exact-erf GELU, with the A&S erf (ops/convnext_block.py:365-369)."""
    return (0.5 * (1.0 + _erf_poly(x * 2.0 ** -0.5))
            + x * 0.3989422804014327 * torch.exp(-0.5 * x * x))


def resolve_gelu_impl(training: bool) -> str:
    """The kernels' GELU (ops/convnext_block.py:141-146): IMTPU_GELU
    (`_GELU_ENV`), when set, for both modes; else the fast fit in training
    and exact erf at eval. It covers kernels 1 and 2 (`gelu_fast` 0 is their
    exact instance) and the blocks' plain path alike."""
    return check_gelu_env("IMTPU_GELU", _GELU_ENV) or ("fast" if training else "exact")


def check_gelu_env(name: str, value: str) -> str:
    """`value` of the GELU switch `name` when it is one the port takes ("",
    or one of GELU_IMPLS); raises on JAX's other values."""
    if value and value not in GELU_IMPLS:
        raise ValueError(f"{name}={value!r} is not ported: the port takes {GELU_IMPLS} "
                         f"(JAX's 'poly' is a slower fit and 'relu' a timing probe with "
                         f"wrong numerics)")
    return value


class FastGelu(torch.autograd.Function):
    """0.5 * x * (1 + erf_fast(x / sqrt 2)), whose backward is the derivative
    of the same polynomial computed from x alone: autograd of the Horner chain
    would keep a dozen (N, 4C) fp32 temporaries per block, more than the
    card holds for the plain path's train step at B=128."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return 0.5 * x * (1.0 + erf_fast(x * 2.0 ** -0.5))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        z = x * 2.0 ** -0.5
        a = torch.clamp(z.abs(), max=2.75)
        u = torch.square(a * (1.0 / 2.75))
        p = _horner(u, _ERF_F8)
        dp = _horner(u, _ERF_F8_DERIV)
        erf = torch.sign(z) * (a * p)
        derf = torch.where(z.abs() <= 2.75, p + 2.0 * u * dp, torch.zeros_like(p))
        return g * (0.5 * (1.0 + erf) + 0.5 * x * derf * 2.0 ** -0.5)


_ERF_F8_DERIV = tuple(k * c for k, c in enumerate(_ERF_F8))[1:]


def _gelu(x: torch.Tensor, impl: str) -> torch.Tensor:
    if impl == "exact":
        return F.gelu(x)
    return FastGelu.apply(x)


def _gelu_grad(x: torch.Tensor, impl: str) -> torch.Tensor:
    return gelu_grad(x) if impl == "exact" else gelu_grad_fast(x)


def _check_gelu(impl: str) -> None:
    if impl not in GELU_IMPLS:
        raise ValueError(f"gelu_impl must be one of {GELU_IMPLS}, got {impl!r}")


def plain_ln_mlp(h: torch.Tensor, ln_s, ln_b, w1, b1, w2, b2, gamma,
                 eps: float = 1e-6, gelu_impl: str = "exact") -> torch.Tensor:
    """LN -> MLP -> layer-scale in plain PyTorch, with the kernel's numerics.

    h (..., C); w1 (4C, C) and w2 (C, 4C) in torch Linear layout; vectors fp32.
    LN statistics in fp32, the LN'd tokens cast to h.dtype; both products on
    fp32 copies of h.dtype operands, so products are exact and sums fp32 (TF32
    must be off on a GPU); b1 and the GELU in fp32, a cast to h.dtype; b2
    and gamma in fp32, one final cast. In fp32 the casts vanish and this is
    JAX's `plain_ln_mlp` (ops/convnext_block.py:254-268).
    """
    _check_gelu(gelu_impl)
    dt = h.dtype
    hf = h.float()
    mu = hf.mean(dim=-1, keepdim=True)
    var = (hf - mu).square().mean(dim=-1, keepdim=True)
    t = ((hf - mu) * torch.rsqrt(var + eps) * ln_s.float() + ln_b.float()).to(dt)
    pre = F.linear(t.float(), w1.to(dt).float(), b1.float())
    hid = _gelu(pre, gelu_impl).to(dt)
    out = F.linear(hid.float(), w2.to(dt).float(), b2.float())
    return (out * gamma.float()).to(dt)


def plain_ln_mlp_bwd(h: torch.Tensor, g: torch.Tensor, ln_s, ln_b, w1, b1, w2, b2, gamma,
                     eps: float = 1e-6, gelu_impl: str = "exact") -> Tuple[torch.Tensor, ...]:
    """The LN+MLP backward in plain PyTorch: the twin of the TPU kernel's
    `_bwd_kernel` (ops/convnext_block.py:372-453) and of `csrc/ln_mlp_bwd.cu`.

    Recomputes the forward from `h`, pulls the cotangent `g` back through
    layer-scale, Dense(C), GELU, Dense(4C) and LN. Returns (dx, dln_s, dln_b,
    dw1, db1, dw2, db2, dgamma), weights in torch Linear layout. The tokens,
    the GELU output and both pre-activation gradients are rounded to h.dtype
    as the kernel rounds them; every product runs on fp32 copies, so it is
    exact with fp32 sums; the GELU derivative is the fit's (`gelu_grad`,
    `gelu_grad_fast`), not autograd of the forward polynomial. The CUDA kernel
    takes dw2 as gamma * (g^T hmid_c), which differs from dpre2_c^T hmid_c
    here by the bf16 rounding of dpre2, and dgamma from that same product.
    """
    _check_gelu(gelu_impl)
    dt = h.dtype
    shape = h.shape
    hf = h.reshape(-1, shape[-1]).float()
    gf = g.reshape(-1, shape[-1]).float()
    s = ln_s.float()
    mu = hf.mean(dim=-1, keepdim=True)
    var = (hf - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (hf - mu) * rstd
    tokens = (xhat * s + ln_b.float()).to(dt).float()
    w1f = w1.to(dt).float()
    w2f = w2.to(dt).float()
    pre1 = F.linear(tokens, w1f, b1.float())
    hmid_c = _gelu(pre1, gelu_impl).to(dt).float()
    pre2 = F.linear(hmid_c, w2f, b2.float())

    dgamma = (gf * pre2).sum(0)
    dpre2 = gf * gamma.float()
    db2 = dpre2.sum(0)
    dpre2_c = dpre2.to(dt).float()
    dw2 = dpre2_c.t() @ hmid_c
    dpre1 = (dpre2_c @ w2f) * _gelu_grad(pre1, gelu_impl)
    db1 = dpre1.sum(0)
    dpre1_c = dpre1.to(dt).float()
    dw1 = dpre1_c.t() @ tokens
    dln = dpre1_c @ w1f
    dln_s = (dln * xhat).sum(0)
    dln_b = dln.sum(0)
    dxhat = dln * s
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (dxhat - m1 - xhat * m2)).to(dt).reshape(shape)
    return (dx, dln_s.to(ln_s.dtype), dln_b.to(ln_b.dtype), dw1.to(w1.dtype),
            db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype), dgamma.to(gamma.dtype))


# the tokens' dtypes the kernels take: each has an instance of its own
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _check_tokens(name: str, h: torch.Tensor) -> None:
    if not h.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors; CPU tensors go to the plain twin")
    if h.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} takes bf16 or fp32 tokens, got {h.dtype}")
    if h.dim() != 2 or not h.is_contiguous():
        raise ValueError(f"{name} takes contiguous (N, C) tokens, got {tuple(h.shape)}")


def _kernel_operands(name: str, h: torch.Tensor, ln_s, ln_b, w1, b1, w2, b2, gamma):
    """Weights in h's dtype (JAX casts them to h.dtype) and vectors in fp32,
    contiguous, checked against h."""
    c = h.shape[1]
    hidden = w1.shape[0]
    if w1.shape != (hidden, c) or w2.shape != (c, hidden):
        raise ValueError(f"weights {tuple(w1.shape)}, {tuple(w2.shape)} do not fit C={c}")
    if any(t.device != h.device for t in (ln_s, ln_b, w1, b1, w2, b2, gamma)):
        raise ValueError(f"{name}: all tensors must be on one device")
    w1 = w1.to(h.dtype).contiguous()
    w2 = w2.to(h.dtype).contiguous()
    vecs = [v.float().contiguous() for v in (ln_s, ln_b, b1, b2, gamma)]
    for v, size in zip(vecs, (c, c, hidden, c, c)):
        if v.numel() != size:
            raise ValueError(f"vector of {v.numel()} values where {size} are needed")
    return w1, w2, vecs


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.imt_cuda_error_string(err).decode()}")


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _workspace(nbytes: int, device) -> torch.Tensor:
    """`nbytes` of scratch from the caching allocator, 1024-byte aligned, as
    the kernels' workspaces must be."""
    raw = torch.empty(nbytes + 1024, dtype=torch.uint8, device=device)
    skip = -raw.data_ptr() % 1024
    return raw[skip:skip + nbytes]


# kernel 1's stages, as imt_ln_mlp_fwd_bf16 numbers them
FWD_STAGES = ("prologue", "hidden", "output")


class _Fwd:
    """One call of kernel 1: its checked operands, output and workspace.
    `run(first, last)` launches stages [first, last) of FWD_STAGES; a stage
    run alone reads what the stages before it left in the workspace."""

    def __init__(self, h, ln_s, ln_b, w1, b1, w2, b2, gamma, eps, gelu_impl):
        _check_gelu(gelu_impl)
        _check_tokens("fused_ln_mlp", h)
        w1, w2, vecs = _kernel_operands("fused_ln_mlp", h, ln_s, ln_b, w1, b1, w2, b2, gamma)
        from imagenet_models_tpu_torch.ops._kernels import ln_mlp_fwd_library

        self.lib = lib = ln_mlp_fwd_library()
        n, c = h.shape
        hidden = w1.shape[0]
        if not lib.imt_ln_mlp_fwd_supported(c, hidden):
            raise ValueError(f"fused_ln_mlp does not take C={c}, hidden={hidden}")
        self.out = torch.empty_like(h)
        if not _aligned(h, w1, w2, self.out):
            raise ValueError("fused_ln_mlp needs 16-byte aligned tokens and weights")
        self.n = n
        if n == 0:
            return
        if h.dtype == torch.float32:
            self.entry = lib.imt_ln_mlp_fwd_f32
            size = lib.imt_ln_mlp_fwd_f32_workspace_bytes(n, c, hidden)
        else:
            self.entry = lib.imt_ln_mlp_fwd_bf16
            size = lib.imt_ln_mlp_fwd_workspace_bytes(n, c, hidden)
        self.workspace = _workspace(size, h.device)
        self.args = (h.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), w1.data_ptr(),
                     vecs[2].data_ptr(), w2.data_ptr(), vecs[3].data_ptr(), vecs[4].data_ptr(),
                     self.out.data_ptr(), self.workspace.data_ptr(), n, c, hidden, float(eps),
                     int(gelu_impl == "fast"))
        self.keep = (w1, w2, vecs)  # the converted operands live as long as the call
        self.device = h.device

    def run(self, first: int = 0, last: int = len(FWD_STAGES)) -> None:
        if self.n == 0:
            return
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = self.entry(*self.args, first, last, stream)
        _raise_on(self.lib, err, "ln_mlp_fwd")


def ln_mlp_fwd_pipeline(h: torch.Tensor, ln_s, ln_b, w1, b1, w2, b2, gamma,
                        eps: float = 1e-6, gelu_impl: str = "exact") -> _Fwd:
    """Kernel 1 run once through all its stages, kept so that each stage can
    be launched again on its own (`.run(k, k + 1)`): for timing the pipeline
    stage by stage. Not counted in `fused_ln_mlp.launches`."""
    call = _Fwd(h, ln_s, ln_b, w1, b1, w2, b2, gamma, eps, gelu_impl)
    call.run()
    return call


@torch.library.custom_op("imtpu::ln_mlp_fwd", mutates_args=())
def _ln_mlp_fwd_op(h: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor, w1: torch.Tensor,
                   b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, gamma: torch.Tensor,
                   eps: float, gelu_impl: str) -> torch.Tensor:
    """The op `imtpu::ln_mlp_fwd`: kernel 1's checks, workspace, launch and
    count (`fused_ln_mlp.launches`). Raises on CPU tensors: there is no CPU
    registration, the caller picks the twin for those."""
    call = _Fwd(h, ln_s, ln_b, w1, b1, w2, b2, gamma, eps, gelu_impl)
    if call.n == 0:
        return call.out
    call.run()
    fused_ln_mlp.launches += 1
    return call.out


@_ln_mlp_fwd_op.register_fake
def _ln_mlp_fwd_fake(h, ln_s, ln_b, w1, b1, w2, b2, gamma, eps, gelu_impl):
    """What kernel 1 writes, from shapes alone: contiguous (N, C) tokens of
    h's dtype."""
    _check_gelu(gelu_impl)
    if h.dim() != 2 or w1.shape != (w1.shape[0], h.shape[1]):
        raise ValueError(f"imtpu::ln_mlp_fwd takes (N, C) tokens and a (hidden, C) w1, got "
                         f"{tuple(h.shape)} and {tuple(w1.shape)}")
    return h.new_empty(h.shape)


_LN_MLP_FWD = torch.ops.imtpu.ln_mlp_fwd.default


def fused_ln_mlp(h: torch.Tensor, ln_s, ln_b, w1, b1, w2, b2, gamma,
                 eps: float = 1e-6, gelu_impl: str = "exact") -> torch.Tensor:
    """Kernel 1, the CUDA LN+MLP forward, on (N, C) bf16 or fp32 tokens,
    through the custom op `imtpu::ln_mlp_fwd`, so that `torch.export`
    traces it (by its fake function) into one node of the graph.

    Replaces `_fused_ln_mlp_pallas` (ops/convnext_block.py:341). Weights in
    torch Linear layout, (4C, C) and (C, 4C), cast to h.dtype here as JAX
    casts them; vectors fp32. The kernel is a pipeline of a row-wise LN and
    two GEMM-shaped stages (FWD_STAGES, csrc/ln_mlp_fwd.cu) over a workspace
    from the caching allocator; fp32 tokens take its fp32 instance. Raises on
    anything it does not take, including CPU tensors. `fused_ln_mlp.launches`
    counts calls that launched it.
    """
    return _LN_MLP_FWD(h, ln_s, ln_b, w1, b1, w2, b2, gamma, float(eps), gelu_impl)


fused_ln_mlp.launches = 0


# kernel 2's stages, as imt_ln_mlp_bwd_bf16 numbers them
BWD_STAGES = ("prologue", "hidden", "dln", "wgrad")


class _Bwd:
    """One call of kernel 2: its checked operands, outputs and workspace.
    `run(first, last)` launches stages [first, last) of BWD_STAGES; a stage
    run alone reads what the stages before it left in the workspace."""

    def __init__(self, h, g, ln_s, ln_b, w1, b1, w2, b2, gamma, eps, gelu_impl):
        _check_gelu(gelu_impl)
        _check_tokens("fused_ln_mlp_bwd", h)
        _check_tokens("fused_ln_mlp_bwd", g)
        if g.dtype != h.dtype:
            raise TypeError(f"fused_ln_mlp_bwd takes a cotangent of the tokens' dtype (bf16 or "
                            f"fp32), got {g.dtype} for {h.dtype} tokens")
        if g.shape != h.shape or g.device != h.device:
            raise ValueError(f"cotangent {tuple(g.shape)} does not match tokens {tuple(h.shape)}")
        w1, w2, vecs = _kernel_operands("fused_ln_mlp_bwd", h, ln_s, ln_b, w1, b1, w2, b2, gamma)
        from imagenet_models_tpu_torch.ops._kernels import ln_mlp_bwd_library

        self.lib = lib = ln_mlp_bwd_library()
        n, c = h.shape
        hidden = w1.shape[0]
        if n == 0 or not lib.imt_ln_mlp_bwd_supported(c, hidden):
            raise ValueError(f"fused_ln_mlp_bwd does not take N={n}, C={c}, hidden={hidden}")
        self.dx = torch.empty_like(h)
        self.dw1 = torch.empty(hidden, c, dtype=torch.float32, device=h.device)
        self.dw2 = torch.empty(c, hidden, dtype=torch.float32, device=h.device)
        self.vecs = torch.empty(hidden + 4 * c, dtype=torch.float32, device=h.device)
        if h.dtype == torch.float32:
            self.entry = lib.imt_ln_mlp_bwd_f32
            size = lib.imt_ln_mlp_bwd_f32_workspace_bytes(n, c, hidden)
        else:
            self.entry = lib.imt_ln_mlp_bwd_bf16
            size = lib.imt_ln_mlp_bwd_workspace_bytes(n, c, hidden)
        self.workspace = _workspace(size, h.device)
        if not _aligned(h, g, w1, w2, self.dx):
            raise ValueError("fused_ln_mlp_bwd needs 16-byte aligned tokens and weights")
        self.args = (h.data_ptr(), g.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(),
                     w1.data_ptr(), vecs[2].data_ptr(), w2.data_ptr(), vecs[3].data_ptr(),
                     vecs[4].data_ptr(), self.dx.data_ptr(), self.dw1.data_ptr(),
                     self.dw2.data_ptr(), self.vecs.data_ptr(), self.workspace.data_ptr(),
                     n, c, hidden, float(eps), int(gelu_impl == "fast"))
        self.keep = (w1, w2, vecs)  # the converted operands live as long as the call
        self.device = h.device

    def run(self, first: int = 0, last: int = len(BWD_STAGES)) -> None:
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = self.entry(*self.args, first, last, stream)
        _raise_on(self.lib, err, "ln_mlp_bwd")


def ln_mlp_bwd_pipeline(h: torch.Tensor, g: torch.Tensor, ln_s, ln_b, w1, b1, w2, b2, gamma,
                        eps: float = 1e-6, gelu_impl: str = "exact") -> _Bwd:
    """Kernel 2 run once through all its stages, kept so that each stage can
    be launched again on its own (`.run(k, k + 1)`): for timing the pipeline
    stage by stage. Not counted in `fused_ln_mlp_bwd.launches`."""
    call = _Bwd(h, g, ln_s, ln_b, w1, b1, w2, b2, gamma, eps, gelu_impl)
    call.run()
    return call


def fused_ln_mlp_bwd(h: torch.Tensor, g: torch.Tensor, ln_s, ln_b, w1, b1, w2, b2, gamma,
                     eps: float = 1e-6, gelu_impl: str = "exact") -> Tuple[torch.Tensor, ...]:
    """Kernel 2, the CUDA LN+MLP backward, on (N, C) bf16 or fp32 tokens and a
    cotangent of their dtype.

    Replaces `_fused_ln_mlp_bwd_pallas` (ops/convnext_block.py:474). Returns
    (dx, dln_s, dln_b, dw1, db1, dw2, db2, dgamma) as `plain_ln_mlp_bwd` does:
    each gradient in its input's dtype (the kernel sums in fp32), weights in
    torch Linear layout. The kernel is a pipeline of GEMM-shaped stages
    (BWD_STAGES, csrc/ln_mlp_bwd.cu); fp32 tokens take its fp32 instance.
    Raises on anything it does not take.
    `fused_ln_mlp_bwd.launches` counts calls that launched it.
    """
    call = _Bwd(h, g, ln_s, ln_b, w1, b1, w2, b2, gamma, eps, gelu_impl)
    call.run()
    fused_ln_mlp_bwd.launches += 1
    c, hidden = h.shape[1], call.dw1.shape[0]
    db1, db2, dgamma, dln_s, dln_b = torch.split(call.vecs, [hidden, c, c, c, c])
    grads = (dln_s, dln_b, call.dw1, db1, call.dw2, db2, dgamma)
    params = (ln_s, ln_b, w1, b1, w2, b2, gamma)
    return (call.dx,) + tuple(d.to(p.dtype) for d, p in zip(grads, params))


fused_ln_mlp_bwd.launches = 0


class LnMlpFunction(torch.autograd.Function):
    """The LN+MLP on CUDA: forward kernel, and kernel 2 as its backward.

    Saves only the inputs, as JAX's custom VJP does (ops/convnext_block.py:
    526-529); the backward recomputes the forward, so nothing of the (N, 4C)
    hidden is kept between the two.
    """

    @staticmethod
    def forward(ctx, h, ln_s, ln_b, w1, b1, w2, b2, gamma, eps, gelu_impl):
        ctx.save_for_backward(h, ln_s, ln_b, w1, b1, w2, b2, gamma)
        ctx.eps, ctx.gelu_impl = eps, gelu_impl
        return fused_ln_mlp(h, ln_s, ln_b, w1, b1, w2, b2, gamma, eps, gelu_impl)

    @staticmethod
    def backward(ctx, g):
        return tuple(ln_mlp_backward(ctx.saved_tensors, g, ctx.eps, ctx.gelu_impl)) + (None, None)


def ln_mlp_backward(residuals, g: torch.Tensor, eps: float, gelu_impl: str) -> Tuple:
    """The LN+MLP's gradients from its inputs `residuals` (h, ln_s, ln_b, w1,
    b1, w2, b2, gamma) and the cotangent `g` (ops/convnext_block.py:536-545):
    kernel 2, or with IMTPU_FUSED_BWD at "0" (`_FUSED_BWD` False) the plain
    VJP, autograd of `plain_ln_mlp` recomputed from the inputs, on the device
    the tensors are on."""
    if _FUSED_BWD:
        return fused_ln_mlp_bwd(residuals[0], g.contiguous(), *residuals[1:], eps, gelu_impl)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in residuals]
        out = plain_ln_mlp(*leaves, eps, gelu_impl)
        return torch.autograd.grad(out, leaves, g)


def ln_mlp(h: torch.Tensor, ln_s, ln_b, w1, b1, w2, b2, gamma, eps: float = 1e-6,
           use_kernel: Optional[bool] = None, gelu_impl: str = "exact") -> torch.Tensor:
    """LN+MLP+scale on (..., C) tokens: the kernels for CUDA tensors, the twin
    for CPU tensors; `use_kernel` forces one (mirrors JAX's `use_pallas`)."""
    if use_kernel is None:
        use_kernel = h.is_cuda
    if not use_kernel:
        return plain_ln_mlp(h, ln_s, ln_b, w1, b1, w2, b2, gamma, eps, gelu_impl)
    shape = h.shape
    out = LnMlpFunction.apply(h.reshape(-1, shape[-1]).contiguous(), ln_s, ln_b, w1, b1, w2,
                              b2, gamma, eps, gelu_impl)
    return out.reshape(shape)


def _plain_block(x, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma, eps, gelu_impl):
    """The plain path's branch: `dw_conv7`, then `plain_ln_mlp`."""
    return plain_ln_mlp(dw_conv7(x, dw_w, dw_b), ln_s, ln_b, w1, b1, w2, b2, gamma, eps, gelu_impl)


def convnext_block_apply(x: torch.Tensor, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2,
                         gamma: Optional[torch.Tensor], eps: float = 1e-6,
                         use_kernel: Optional[bool] = None,
                         training: bool = False, remat: Optional[bool] = None) -> torch.Tensor:
    """The pre-residual ConvNeXt branch on NHWC `x` (ops/convnext_block.py:605-638):
    depthwise 7x7, then LN+MLP+scale by the dispatch rule of `ln_mlp`, with
    the GELU of `resolve_gelu_impl(training)`. With IMTPU_DW_WGRAD at "1"
    (`dw_conv._DW_WGRAD`) the dw conv is `DwConv7Function`, whose weight
    gradient is kernel 9 on CUDA tensors and its twin on CPU tensors
    (:557-566); at "0", and on the plain path (`use_kernel=False`, as JAX's
    `use_pallas=False` takes the plain conv), it is `F.conv2d` under
    autograd.

    The switches of JAX's dispatch (:621-638): with `use_kernel` None, a
    block of fewer channels than IMTPU_PALLAS_MIN_C (`_PALLAS_MIN_C`) takes
    the plain path; on the plain path asked for by `use_kernel=False` (or
    by that switch), `remat` (None: IMTPU_BLOCK_REMAT, `_REMAT`) recomputes
    the block in the backward instead of keeping its (N, 4C) activations
    (`nn.checkpoint.checkpoint_call`)."""
    if gamma is None:
        gamma = torch.ones(x.shape[-1], device=x.device)
    if use_kernel is None and x.shape[-1] < _PALLAS_MIN_C:
        use_kernel = False
    if use_kernel is False and (remat if remat is not None else _REMAT):
        return checkpoint_call(_plain_block, x, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma,
                               eps, resolve_gelu_impl(training))
    if dw_ops._DW_WGRAD == "1" and use_kernel is not False:
        h = DwConv7Function.apply(x, dw_w, dw_b)
    else:
        h = dw_conv7(x, dw_w, dw_b)
    return ln_mlp(h, ln_s, ln_b, w1, b1, w2, b2, gamma, eps, use_kernel=use_kernel,
                  gelu_impl=resolve_gelu_impl(training))


def use_transformer_lnmlp(drop: float, deterministic: bool) -> bool:
    """Whether a transformer block's norm2 + MLP pair takes `ln_mlp_apply`
    (ops/convnext_block.py:641-652): only with IMTPU_TLNMLP at "1", and then
    at eval or where the MLP has no dropout (the kernels draw no random
    numbers)."""
    if _TLNMLP != "1":
        return False
    return drop == 0.0 or deterministic


def ln_mlp_apply(x: torch.Tensor, ln_s, ln_b, w1, b1, w2, b2, eps: float,
                 training: bool = False, use_kernel: Optional[bool] = None) -> torch.Tensor:
    """LN -> Dense(hidden) -> GELU -> Dense(C) on (..., C) tokens of any leading
    shape, with a unit layer scale (ops/convnext_block.py:655-675): `ln_mlp`
    by its dispatch rule (kernels 1 and 2 for CUDA tensors, the twin for CPU
    tensors), with the GELU of `resolve_gelu_impl(training)`. Weights in
    torch Linear layout; returns x's dtype."""
    gamma = torch.ones(x.shape[-1], device=x.device)
    return ln_mlp(x, ln_s, ln_b, w1, b1, w2, b2, gamma, eps, use_kernel=use_kernel,
                  gelu_impl=resolve_gelu_impl(training))

"""CSWin's vertical-stripe attention with its LePE term, forward and backward.

Port of imagenet_models_tpu/ops/stripe_attention.py. The idx=0 branch of
`LePEAttention` cuts the (B, H, W, C) map into full-height stripes of width
`ws`; per stripe of T = H*ws tokens and per head it computes
softmax((q*scale) k^T) v, and adds LePE: a 3x3 depthwise conv on v plus its
bias, zero-padded at the stripe's own borders. Token (a, y) of stripe j is
pixel (a, j*ws + y). Two hand-written CUDA kernels do it on the card, reading
the stripe's tokens straight from the unpartitioned maps, so no partition or
reverse copy touches device memory: the forward (`csrc/stripe_attn_fwd.cu`,
wrapper `fused_stripe_attention`) and the backward
(`csrc/stripe_attn_bwd.cu`, wrapper `fused_stripe_attention_bwd`), joined by
the autograd function `StripeAttentionFunction`. Beside them are their
plain-PyTorch twins `plain_stripe_attention` and `plain_stripe_attention_bwd`,
which have the kernels' numerics.

The JAX kernel packs two stripes per score matrix under a -1e30
block-diagonal mask (`_stripe_mask`, `_stripe_pack`, `_sub_blocks`): that is
the TPU's tile geometry and gives the per-stripe result exactly. The port
computes per stripe.

Numerics (`_vs_fwd_kernel` and `_vs_bwd_kernel`, stripe_attention.py:134-230):
q times the scale in q's dtype (in bf16, 32**-0.5 becomes 0.1767578); scores
and softmax in fp32 from exact products of the input-dtype operands; p
rounded to the input dtype before p v; LePE in fp32 from the fp32 taps
`w9` (9, C) and bias `wb` (1, C), added to the fp32 attention output; one
cast at the output. The backward recomputes p, takes dv = p^T g + the
transposed stencil of g, dp = g v^T, ds = p (dp - rowsum(dp p)), rounds ds
for dq = (ds k) * scale (the scale in fp32) and dk = ds^T (q*scale), and sums
dw9[t] = sum of shift_t(v) * g and dwb = sum of g over every stripe, in fp32.
Tap t = 3*(dx+1) + (dy+1) reads v[a+dx, y+dy], dx along H and dy along W: the
torch `get_v.weight` (C, 1, 3, 3) is `w9.t().reshape(C, 1, 3, 3)`.

Dispatch rule (as the other kernels'): a CPU tensor goes to the forward twin,
and autograd through it gives the gradient (JAX's CPU path is autodiff of its
plain twin); a CUDA tensor goes to the kernels, or raises. There is no
fallback from a kernel to a twin. `use_kernel=False` runs the twin on any
device, to compare against. The kernels take bf16 maps and, for fp32 models,
fp32 maps: each has an fp32 instance with no rounding to bf16 (q times the
fp32 scale), as the TPU kernels run fp32 operands.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

HEAD_DIMS = (24, 32)  # the kernels' head widths (GA-CSWin-T/S: 32; -B: 24)
MAX_TOKENS = 256      # the kernels' longest stripe (H * ws)
# the maps' dtypes the kernels take, and the suffix of each instance's C entry
KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
# The gate's tallest stripe. The JAX package engages its kernel only for
# h <= 16 (its IMTPU_STRIPE_MAXH default): at ga_cswin 224 px that is the
# 14x14 stage 3, the stage-5 block and the gram layers, while the 56x56 and
# 28x28 stages take the composition. The port has no environment knobs.
MAX_STRIPE_H = 16


def _check_geometry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ws: int,
                    nh: int) -> Tuple[int, int, int, int]:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must be (B, H, W, C) maps of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, w, c = q.shape
    if c % nh:
        raise ValueError(f"{c} channels do not split into {nh} heads")
    if ws <= 0 or w % ws:
        raise ValueError(f"a map of width {w} does not split into stripes of width {ws}")
    return b, h, w, c


def _stripes(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*W/ws, H*ws, C), tokens of a stripe in (a, y) order."""
    b, h, w, c = x.shape
    return x.reshape(b, h, w // ws, ws, c).permute(0, 2, 1, 3, 4).reshape(-1, h * ws, c)


def _unstripes(rows: torch.Tensor, b: int, h: int, w: int, ws: int) -> torch.Tensor:
    c = rows.shape[-1]
    return rows.reshape(b, w // ws, h, ws, c).permute(0, 2, 1, 3, 4).reshape(b, h, w, c)


def _stripe_images(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> fp32 (B*W/ws, C, H, ws): each stripe as an NCHW image."""
    b, h, w, c = x.shape
    return x.float().reshape(b, h, w // ws, ws, c).permute(0, 2, 4, 1, 3).reshape(-1, c, h, ws)


def _heads(x: torch.Tensor, ws: int, nh: int) -> torch.Tensor:
    """(B, H, W, C) -> fp32 (B*W/ws, nh, T, d)."""
    rows = _stripes(x, ws).float()
    return rows.reshape(rows.shape[0], rows.shape[1], nh, -1).transpose(1, 2)


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q times the scale in q's dtype, as JAX's `q * scale` with a weak-typed
    Python float: in bf16 the scale itself rounds first."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def _probs(qs: torch.Tensor, kh: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """softmax(qs kh^T) in fp32, rounded to `dtype` (and back to fp32)."""
    return torch.softmax(torch.matmul(qs, kh.transpose(-1, -2)), dim=-1).to(dtype).float()


def _taps(w9: torch.Tensor) -> torch.Tensor:
    """(9, C) taps -> the depthwise conv weight (C, 1, 3, 3) in fp32."""
    return w9.float().t().reshape(-1, 1, 3, 3)


def plain_stripe_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w9: torch.Tensor,
                           wb: torch.Tensor, *, ws: int, nh: int, scale: float) -> torch.Tensor:
    """The forward in plain PyTorch, with the kernel's numerics: stripe
    partition -> per stripe and head softmax((q*scale) k^T) v -> + the fp32
    LePE of v -> reverse (stripe_attention.py:307-333). q, k, v (B, H, W, C);
    w9 (9, C), wb (1, C); returns (B, H, W, C) in q's dtype. The products run
    on fp32 copies of the input-dtype operands, so they are exact with fp32
    sums (TF32 must be off on a GPU, for matmuls and cuDNN convs)."""
    b, h, w, c = _check_geometry(q, k, v, ws, nh)
    dt = q.dtype
    p = _probs(_heads(_scaled(q, scale), ws, nh), _heads(k, ws, nh), dt)
    o = torch.matmul(p, _heads(v, ws, nh))                    # (N, nh, T, d)
    o = o.transpose(1, 2).reshape(o.shape[0], h, ws, c)
    lepe = F.conv2d(_stripe_images(v, ws), _taps(w9), padding=1, groups=c)
    out = (o + (lepe.permute(0, 2, 3, 1) + wb.float().reshape(c))).to(dt)
    return _unstripes(out.reshape(-1, h * ws, c), b, h, w, ws)


def plain_stripe_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               w9: torch.Tensor, wb: torch.Tensor, g: torch.Tensor, *, ws: int,
                               nh: int, scale: float
                               ) -> Tuple[torch.Tensor, ...]:
    """The backward in plain PyTorch: the twin of `_vs_bwd_kernel`
    (stripe_attention.py:160-230) and of `csrc/stripe_attn_bwd.cu`. Returns
    (dq, dk, dv) in q's dtype and (dw9 (9, C), dwb (1, C)) in fp32, summed
    over every stripe of the batch."""
    b, h, w, c = _check_geometry(q, k, v, ws, nh)
    dt = q.dtype
    qs, kh, vh = _heads(_scaled(q, scale), ws, nh), _heads(k, ws, nh), _heads(v, ws, nh)
    gh = _heads(g, ws, nh)
    p = _probs(qs, kh, dt)
    dv = torch.matmul(p.transpose(-1, -2), gh)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    gs, vs = _stripe_images(g, ws), _stripe_images(v, ws)
    # dv's LePE part: the transposed stencil, dv[x, y] += sum_t g[x-dx, y-dy] w9[t]
    dv_lepe = F.conv2d(gs, _taps(w9).flip(-1, -2), padding=1, groups=c).permute(0, 2, 3, 1)
    vp = F.pad(vs, (1, 1, 1, 1))
    dw9 = torch.stack([(vp[:, :, kh_:kh_ + h, kw_:kw_ + ws] * gs).sum(dim=(0, 2, 3))
                       for kh_ in range(3) for kw_ in range(3)])
    dwb = gs.sum(dim=(0, 2, 3)).reshape(1, c)

    def back(x):  # (N, nh, T, d) -> (B, H, W, C)
        return _unstripes(x.transpose(1, 2).reshape(x.shape[0], h * ws, c), b, h, w, ws)

    dv = dv.transpose(1, 2).reshape(-1, h, ws, c) + dv_lepe
    dv = _unstripes(dv.reshape(-1, h * ws, c).to(dt), b, h, w, ws)
    return back(dq).to(dt), back(dk).to(dt), dv, dw9, dwb


def _pixel_ld(t: torch.Tensor) -> Optional[int]:
    """The pixel stride of a (B, H, W, C) map whose channels are contiguous
    and whose pixels are evenly spaced (a contiguous map, or a channel slice
    of one such as `qkv[..., c:2c]`); None for any other layout."""
    b, h, w, c = t.shape
    st = t.stride()
    ld = st[2] if w > 1 else st[1] if h > 1 else st[0] if b > 1 else c
    want = (h * w * ld, w * ld, ld, 1)
    if c > 1 and st[3] != 1:
        return None
    if ld < c or any(n > 1 and s != e for n, s, e in zip(t.shape, st, want)):
        return None
    return ld


def _strided_ok(t: torch.Tensor, ld: Optional[int]) -> bool:
    """Whether the kernels read `t` in 16-byte steps: a pixel stride of whole
    16-byte units and a 16-byte aligned start."""
    return ld is not None and (ld * t.element_size()) % 16 == 0 and t.data_ptr() % 16 == 0


def pixel_rows(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when the kernels can read it in place (evenly spaced pixels
    of contiguous channels, 16-byte aligned); otherwise a contiguous copy."""
    if not _strided_ok(t, _pixel_ld(t)):
        return t.contiguous()
    return t


def _check_operand(name: str, what: str, t: torch.Tensor, shape, device, dtype) -> int:
    ld = _pixel_ld(t) if t.dim() == 4 else None
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device
            or not _strided_ok(t, ld)):
        raise ValueError(f"{name}: {what} must be a {dtype} {tuple(shape)} map on {device} with "
                         f"contiguous channels, evenly spaced pixels (a pixel stride of whole "
                         f"16-byte units) and a 16-byte aligned start, got {t.dtype} "
                         f"{tuple(t.shape)} strides {t.stride()} on {t.device}")
    return ld


def _check_kernel_operands(name: str, q, k, v, w9, wb, ws: int, nh: int):
    """Raises on anything the kernels do not take; returns the pixel strides
    of q, k, v, the taps and bias as contiguous fp32 tensors, and the
    geometry."""
    if not q.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors; CPU tensors go to the plain twin")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} takes bf16 or fp32 q, k, v maps, got {q.dtype}")
    b, h, w, c = _check_geometry(q, k, v, ws, nh)
    lds = [_check_operand(name, nm, t, q.shape, q.device, q.dtype)
           for nm, t in (("q", q), ("k", k), ("v", v))]
    d = c // nh
    if d not in HEAD_DIMS or h * ws > MAX_TOKENS:
        raise ValueError(f"{name} takes heads of width {HEAD_DIMS} and stripes of at most "
                         f"{MAX_TOKENS} tokens, got C={c} in {nh} heads and T={h * ws}")
    if tuple(w9.shape) != (9, c) or tuple(wb.shape) != (1, c) or w9.device != q.device \
            or wb.device != q.device:
        raise ValueError(f"{name}: w9 and wb must be (9, {c}) and (1, {c}) on q's device, got "
                         f"{tuple(w9.shape)} on {w9.device} and {tuple(wb.shape)} on {wb.device}")
    return lds, w9.float().contiguous(), wb.float().contiguous(), (b, h, w, c)


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.imt_cuda_error_string(err).decode()}")


@functools.lru_cache(maxsize=None)
def _scale_in(scale: float, dtype: torch.dtype) -> float:
    """The softmax scale as q's dtype holds it (`_scaled`); cached, as every
    launch asks for it."""
    return float(torch.tensor(scale, dtype=dtype))


def _bf16_scale(scale: float) -> float:
    return _scale_in(scale, torch.bfloat16)


def fused_stripe_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w9: torch.Tensor,
                           wb: torch.Tensor, ws: int, nh: int, scale: float) -> torch.Tensor:
    """Kernel 5, the CUDA stripe-attention + LePE forward, on bf16 or fp32
    (B, H, W, C) q, k, v maps (each may be a channel slice of a wider map) and
    fp32 taps w9 (9, C) and bias wb (1, C); returns the contiguous
    (B, H, W, C) map in q's dtype.

    Replaces `_vs_fwd_pallas` (ops/stripe_attention.py:264). Raises on
    anything the kernel does not take, CPU tensors included.
    `fused_stripe_attention.launches` counts launches."""
    (ldq, ldk, ldv), w9, wb, (b, h, w, c) = _check_kernel_operands(
        "fused_stripe_attention", q, k, v, w9, wb, ws, nh)
    from imagenet_models_tpu_torch.ops._kernels import stripe_attn_fwd_library

    lib = stripe_attn_fwd_library()
    out = torch.empty(b, h, w, c, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        entry = getattr(lib, f"imt_stripe_attn_fwd_{KERNEL_DTYPES[q.dtype]}")
        err = entry(q.data_ptr(), ldq, k.data_ptr(), ldk, v.data_ptr(), ldv, w9.data_ptr(),
                    wb.data_ptr(), out.data_ptr(), b, h, w, c, nh, ws, _scale_in(scale, q.dtype),
                    stream)
    _raise_on(lib, err, "stripe_attn_fwd")
    fused_stripe_attention.launches += 1
    return out


fused_stripe_attention.launches = 0


@functools.lru_cache(maxsize=None)
def _bwd_blocks(stripes: int, nh: int) -> int:
    """Kernel 6's blocks per head (`imt_stripe_attn_bwd_blocks`), a function
    of the shapes alone."""
    from imagenet_models_tpu_torch.ops._kernels import stripe_attn_bwd_library

    return stripe_attn_bwd_library().imt_stripe_attn_bwd_blocks(stripes, nh)


def fused_stripe_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               w9: torch.Tensor, wb: torch.Tensor, g: torch.Tensor, ws: int,
                               nh: int, scale: float) -> Tuple[torch.Tensor, ...]:
    """Kernel 6, the CUDA stripe-attention + LePE backward: (dq, dk, dv
    (B, H, W, C) in q's dtype, dw9 fp32 (9, C), dwb fp32 (1, C)) from the
    inputs of kernel 5 and the cotangent g of q's dtype (which may be a
    channel slice too).

    Replaces `_vs_bwd_pallas` (ops/stripe_attention.py:284). Each block sums
    the dw9 and dwb of its stripes into a partial of its own; a second pass
    adds the partials in a fixed order, so the result is the same on every
    run. `fused_stripe_attention_bwd.launches` counts calls that launched it."""
    name = "fused_stripe_attention_bwd"
    (ldq, ldk, ldv), w9, wb, (b, h, w, c) = _check_kernel_operands(name, q, k, v, w9, wb, ws, nh)
    ldg = _check_operand(name, "the cotangent", g, q.shape, q.device, q.dtype)
    from imagenet_models_tpu_torch.ops._kernels import stripe_attn_bwd_library

    lib = stripe_attn_bwd_library()
    stripes = b * (w // ws)
    if stripes == 0 or h == 0:
        raise ValueError(f"{name} needs at least one stripe")
    blocks = _bwd_blocks(stripes, nh)
    # two allocations per call (host time): dq, dk, dv, and the partials
    # with dw9 and dwb
    dq, dk, dv = torch.empty(3, b, h, w, c, dtype=q.dtype, device=q.device).unbind(0)
    n = nh * blocks * 10 * (c // nh)
    sums = torch.empty(n + 10 * c, dtype=torch.float32, device=q.device)
    partials, dw9, dwb = sums[:n], sums[n:n + 9 * c].view(9, c), sums[n + 9 * c:].view(1, c)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        entry = getattr(lib, f"imt_stripe_attn_bwd_{KERNEL_DTYPES[q.dtype]}")
        err = entry(q.data_ptr(), ldq, k.data_ptr(), ldk, v.data_ptr(), ldv, g.data_ptr(), ldg,
                    w9.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    partials.data_ptr(), dw9.data_ptr(), dwb.data_ptr(), b, h, w, c, nh, ws,
                    blocks, _scale_in(scale, q.dtype), float(scale), stream)
    _raise_on(lib, err, "stripe_attn_bwd")
    fused_stripe_attention_bwd.launches += 1
    return dq, dk, dv, dw9, dwb


fused_stripe_attention_bwd.launches = 0


class StripeAttentionFunction(torch.autograd.Function):
    """Stripe attention + LePE on CUDA: kernel 5 forward, kernel 6 as its
    backward, giving dq, dk, dv, dw9 and dwb. Saves only the inputs, as JAX's
    custom VJP does (stripe_attention.py:336-352); the backward recomputes p."""

    @staticmethod
    def forward(ctx, q, k, v, w9, wb, ws, nh, scale):
        ctx.save_for_backward(q, k, v, w9, wb)
        ctx.geometry = (ws, nh, scale)
        return fused_stripe_attention(q, k, v, w9, wb, ws, nh, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, w9, wb = ctx.saved_tensors
        dq, dk, dv, dw9, dwb = fused_stripe_attention_bwd(q, k, v, w9, wb, pixel_rows(g),
                                                          *ctx.geometry)
        return dq, dk, dv, dw9.to(w9.dtype), dwb.to(wb.dtype), None, None, None


def stripe_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w9: torch.Tensor,
                     wb: torch.Tensor, *, ws: int, num_heads: int, scale: float,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Vertical-stripe (idx=0) LePE attention over unpartitioned (B, H, W, C)
    q, k, v: attention per stripe of width `ws` plus the depthwise-3x3 LePE
    of v with taps w9 (9, C) and bias wb (1, C); returns (B, H, W, C). The
    kernels for CUDA tensors, the twin for CPU tensors; `use_kernel` forces
    one. Differentiable in q, k, v, w9 and wb either way."""
    if use_kernel is None:
        use_kernel = q.is_cuda
    if not use_kernel:
        return plain_stripe_attention(q, k, v, w9, wb, ws=ws, nh=num_heads, scale=scale)
    return StripeAttentionFunction.apply(pixel_rows(q), pixel_rows(k), pixel_rows(v), w9, wb, ws,
                                         num_heads, scale)


def use_fused_stripe_attn(x_shape, ws: int, attn_drop: float, training: bool) -> bool:
    """Whether an idx=0 `LePEAttention` takes `stripe_attention` (the JAX
    gate's shape conditions, stripe_attention.py:355-379): not while softmax
    dropout is live (the kernels draw no random numbers); not when the width
    does not split into stripes, nor for the single-window map h == w == ws
    (the idx=-1 stage); only for stripes of at most MAX_STRIPE_H rows. The
    JAX gate's last test, a 4 MB bound on one block of q, k and v, is the
    TPU's VMEM block size and has no counterpart here."""
    if attn_drop > 0 and training:
        return False
    h, w = x_shape[1], x_shape[2]
    if w % ws or (h == ws and w == ws):
        return False
    return h <= MAX_STRIPE_H

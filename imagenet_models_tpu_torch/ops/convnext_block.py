"""ConvNeXt block compute: depthwise 7x7 conv, then the fused LayerNorm ->
Dense(4C) -> GELU -> Dense(C) -> layer-scale.

Port of imagenet_models_tpu/ops/convnext_block.py, eval path. The depthwise
conv stays with the framework (`F.conv2d`, as it is XLA's in JAX). The LN+MLP
is a hand-written CUDA kernel (`csrc/ln_mlp_fwd.cu`, wrapper
`fused_ln_mlp`) beside its plain-PyTorch twin `plain_ln_mlp`, which has the
kernel's numerics.

Dispatch rule: a CPU tensor goes to the twin; a CUDA tensor goes to the
kernel, or raises. There is no fallback from the kernel to the twin.
`use_kernel=False` runs the twin on any device, to compare against.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def dw_conv7(x: torch.Tensor, dw_w: torch.Tensor, dw_b: torch.Tensor) -> torch.Tensor:
    """Depthwise 7x7 conv on NHWC `x`, weight (C, 1, 7, 7), in x.dtype
    (ops/convnext_block.py:242-251). The NCHW view is channels_last, so the
    result permutes back to a contiguous NHWC tensor."""
    y = F.conv2d(x.permute(0, 3, 1, 2), dw_w.to(x.dtype), dw_b.to(x.dtype),
                 padding=3, groups=x.shape[-1])
    return y.permute(0, 2, 3, 1)


def plain_ln_mlp(h: torch.Tensor, ln_s, ln_b, w1, b1, w2, b2, gamma,
                 eps: float = 1e-6) -> torch.Tensor:
    """LN -> MLP -> layer-scale in plain PyTorch, with the kernel's numerics.

    h (..., C); w1 (4C, C) and w2 (C, 4C) in torch Linear layout; vectors fp32.
    LN statistics in fp32, the LN'd tokens cast to h.dtype; both products on
    fp32 copies of h.dtype operands, so products are exact and sums fp32 (TF32
    must be off on a GPU); b1 and exact GELU in fp32, a cast to h.dtype; b2
    and gamma in fp32, one final cast. In fp32 the casts vanish and this is
    JAX's `plain_ln_mlp` (ops/convnext_block.py:254-268).
    """
    dt = h.dtype
    hf = h.float()
    mu = hf.mean(dim=-1, keepdim=True)
    var = (hf - mu).square().mean(dim=-1, keepdim=True)
    t = ((hf - mu) * torch.rsqrt(var + eps) * ln_s.float() + ln_b.float()).to(dt)
    pre = F.linear(t.float(), w1.to(dt).float(), b1.float())
    hid = F.gelu(pre).to(dt)
    out = F.linear(hid.float(), w2.to(dt).float(), b2.float())
    return (out * gamma.float()).to(dt)


def fused_ln_mlp(h: torch.Tensor, ln_s, ln_b, w1, b1, w2, b2, gamma,
                 eps: float = 1e-6) -> torch.Tensor:
    """The CUDA LN+MLP forward kernel on (N, C) bf16 tokens.

    Replaces `_fused_ln_mlp_pallas` (ops/convnext_block.py:341). Weights in
    torch Linear layout, (4C, C) and (C, 4C), cast to bf16 here as JAX casts
    them to h.dtype; vectors fp32. Raises on anything the kernel does not
    take, including CPU tensors and inputs that need a gradient (the backward
    kernel is not ported yet). `fused_ln_mlp.launches` counts launches.
    """
    if not h.is_cuda:
        raise ValueError("fused_ln_mlp needs CUDA tensors; CPU tensors go to plain_ln_mlp")
    if h.dtype != torch.bfloat16:
        raise TypeError(f"fused_ln_mlp takes bf16 tokens, got {h.dtype}")
    if h.dim() != 2 or not h.is_contiguous():
        raise ValueError(f"fused_ln_mlp takes contiguous (N, C) tokens, got {tuple(h.shape)}")
    n, c = h.shape
    hidden = w1.shape[0]
    if w1.shape != (hidden, c) or w2.shape != (c, hidden):
        raise ValueError(f"weights {tuple(w1.shape)}, {tuple(w2.shape)} do not fit C={c}")
    params = (ln_s, ln_b, w1, b1, w2, b2, gamma)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h,) + params):
        raise NotImplementedError(
            "the LN+MLP backward kernel is not ported yet; run under torch.no_grad()")
    if any(t.device != h.device for t in params):
        raise ValueError("fused_ln_mlp: all tensors must be on one device")
    from imagenet_models_tpu_torch.ops._kernels import ln_mlp_fwd_library

    lib = ln_mlp_fwd_library()
    if not lib.imt_ln_mlp_fwd_supported(c, hidden):
        raise ValueError(f"fused_ln_mlp does not take C={c}, hidden={hidden}")
    w1 = w1.to(torch.bfloat16).contiguous()
    w2 = w2.to(torch.bfloat16).contiguous()
    vecs = [v.float().contiguous() for v in (ln_s, ln_b, b1, b2, gamma)]
    for v, size in zip(vecs, (c, c, hidden, c, c)):
        if v.numel() != size:
            raise ValueError(f"vector of {v.numel()} values where {size} are needed")
    out = torch.empty_like(h)
    if any(t.data_ptr() % 16 for t in (h, w1, w2, out)):
        raise ValueError("fused_ln_mlp needs 16-byte aligned tokens and weights")
    if n == 0:
        return out
    s, b, bb1, bb2, g = vecs
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.imt_ln_mlp_fwd_bf16(
            h.data_ptr(), s.data_ptr(), b.data_ptr(), w1.data_ptr(), bb1.data_ptr(),
            w2.data_ptr(), bb2.data_ptr(), g.data_ptr(), out.data_ptr(),
            n, c, hidden, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"ln_mlp_fwd launch failed: {lib.imt_cuda_error_string(err).decode()}")
    fused_ln_mlp.launches += 1
    return out


fused_ln_mlp.launches = 0


def ln_mlp(h: torch.Tensor, ln_s, ln_b, w1, b1, w2, b2, gamma, eps: float = 1e-6,
           use_kernel: Optional[bool] = None) -> torch.Tensor:
    """LN+MLP+scale on (..., C) tokens: the kernel for CUDA tensors, the twin
    for CPU tensors; `use_kernel` forces one (mirrors JAX's `use_pallas`)."""
    if use_kernel is None:
        use_kernel = h.is_cuda
    if not use_kernel:
        return plain_ln_mlp(h, ln_s, ln_b, w1, b1, w2, b2, gamma, eps)
    shape = h.shape
    out = fused_ln_mlp(h.reshape(-1, shape[-1]).contiguous(), ln_s, ln_b, w1, b1, w2,
                       b2, gamma, eps)
    return out.reshape(shape)


def convnext_block_apply(x: torch.Tensor, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2,
                         gamma: Optional[torch.Tensor], eps: float = 1e-6,
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """The pre-residual ConvNeXt branch on NHWC `x` (ops/convnext_block.py:605-638):
    depthwise 7x7, then LN+MLP+scale by the dispatch rule of `ln_mlp`."""
    if gamma is None:
        gamma = torch.ones(x.shape[-1], device=x.device)
    h = dw_conv7(x, dw_w, dw_b)
    return ln_mlp(h, ln_s, ln_b, w1, b1, w2, b2, gamma, eps, use_kernel=use_kernel)

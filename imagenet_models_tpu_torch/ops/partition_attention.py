"""Window ("block") and dilated-grid ("grid") attention over an unpartitioned
(B, H, W, 3C) qkv map: MaxViT's partition attention, forward and backward.

Port of imagenet_models_tpu/ops/partition_attention.py. Per window of
T = ph*pw tokens and per head: softmax(q k^T + bias[h]) v, with q already
scaled by the caller and a (heads, T, T) relative-position bias; the output
is (B, H, W, C). Two hand-written CUDA kernels do it on the card, reading the
window's tokens straight from the unpartitioned map, so no partition or
reverse copy touches device memory: the forward (`csrc/partition_attn_fwd.cu`,
wrapper `fused_partition_attention`) and the backward
(`csrc/partition_attn_bwd.cu`, wrapper `fused_partition_attention_bwd`),
joined by the autograd function `PartitionAttentionFunction`. Beside them are
their plain-PyTorch twins `plain_partition_attention` and
`plain_partition_attention_bwd`, which have the kernels' numerics.

The JAX kernel packs two windows per score matrix under a bias with -1e30
cross-window entries (`packed_bias`, `_pack_factor`, `_slot_maps`): that is
the TPU's 128-row tile geometry, and it gives the per-window result exactly.
The port computes per window and takes the (heads, T, T) bias as it is.

Numerics (`_attend` and `_bwd_kernel`, partition_attention.py:107-115,
185-229): scores and softmax in fp32 from exact products of the input-dtype
operands; p rounded to the input dtype before p v (fp32 sums); one cast at
the output. The backward recomputes p, takes dv = p^T g, dp = g v^T,
ds = p (dp - rowsum(dp p)) from the rounded p, rounds ds for dq = ds k and
dk = ds^T q, and sums the unrounded ds over every window into an fp32 dbias.

Dispatch rule (as the LN+MLP's): a CPU tensor goes to the forward twin, and
autograd through it gives the gradient (JAX's CPU path is autodiff of its
plain twin); a CUDA tensor goes to the kernels, or raises. There is no
fallback from a kernel to a twin. `use_kernel=False` runs the twin on any
device, to compare against. The kernels take bf16 maps (kernel 4's products
on the tensor cores; kernel 3's on the CUDA cores, as fp32 FMA chains in the
order of its first design, whose bf16 bits it keeps: MaxViT's first-step
gradients move past their gate with any other order, `chip_smoke.py` phase
10) and, for fp32 models, fp32 maps: each has an fp32 instance on the CUDA
cores with no rounding to bf16, as the TPU kernels run fp32 operands.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from imagenet_models_tpu_torch.ops import _kernels

PART_TYPES = ("block", "grid")
HEAD_DIM = 32   # the kernels' head width (MaxViT's dim_head)
MAX_TOKENS = 256  # the kernels' largest window (16 x 16, the 512 px models)
# the maps' dtypes the kernels take, and the suffix of each instance's C entry
KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _check_geometry(qkv: torch.Tensor, part_type: str, ps, nh: int) -> Tuple[int, ...]:
    return _geometry(qkv.shape, part_type, ps, nh)


def _geometry(shape, part_type: str, ps, nh: int) -> Tuple[int, ...]:
    """(B, H, W, C, ph, pw) of a (B, H, W, 3C) map cut into ph x pw windows,
    or raises."""
    if part_type not in PART_TYPES:
        raise ValueError(f"part_type must be one of {PART_TYPES}, got {part_type!r}")
    if len(shape) != 4 or shape[-1] % (3 * nh):
        raise ValueError(f"qkv must be (B, H, W, 3C) with C a multiple of {nh} heads, "
                         f"got {tuple(shape)}")
    b, h, w, c3 = shape
    ph, pw = ps
    if h % ph or w % pw:
        raise ValueError(f"a {h}x{w} map does not split into {ph}x{pw} windows")
    return b, h, w, c3 // 3, ph, pw


def _windows(x: torch.Tensor, part_type: str, ps) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, T, C), tokens of each window in row-major order."""
    from imagenet_models_tpu_torch.ops.window_attention import grid_partition, window_partition

    part = window_partition(x, ps) if part_type == "block" else grid_partition(x, ps)
    return part.reshape(part.shape[0], ps[0] * ps[1], x.shape[-1])


def _unwindows(rows: torch.Tensor, part_type: str, ps, hw) -> torch.Tensor:
    from imagenet_models_tpu_torch.ops.window_attention import grid_reverse, window_reverse

    x = rows.reshape(rows.shape[0], ps[0], ps[1], rows.shape[-1])
    return window_reverse(x, ps, hw) if part_type == "block" else grid_reverse(x, ps, hw)


def _heads(rows: torch.Tensor, nh: int):
    """(N, T, 3C) -> fp32 q, k, v (N, nh, T, d): channel order [q | k | v],
    each [head, d] (partition_attention.py:118-126)."""
    n, t, c3 = rows.shape
    qkv = rows.float().reshape(n, t, 3, nh, c3 // (3 * nh)).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def _probs(q, k, bias, dtype) -> torch.Tensor:
    """softmax(q k^T + bias) in fp32, rounded to `dtype` (and back to fp32)."""
    s = torch.matmul(q, k.transpose(-1, -2)) + bias.float()
    return torch.softmax(s, dim=-1).to(dtype).float()


def plain_partition_attention(qkv: torch.Tensor, bias: torch.Tensor, part_type: str, ps,
                              nh: int) -> torch.Tensor:
    """The forward in plain PyTorch, with the kernel's numerics: partition
    -> per window and head softmax(q k^T + bias) v -> reverse. qkv
    (B, H, W, 3C) with q pre-scaled, bias (nh, T, T); returns (B, H, W, C) in
    qkv's dtype. The products run on fp32 copies of the qkv-dtype operands,
    so they are exact with fp32 sums (TF32 must be off on a GPU). In fp32
    this is JAX's `plain_partition_attention` at any pack."""
    b, h, w, c, ph, pw = _check_geometry(qkv, part_type, ps, nh)
    q, k, v = _heads(_windows(qkv, part_type, ps), nh)
    p = _probs(q, k, bias, qkv.dtype)
    o = torch.matmul(p, v).to(qkv.dtype)  # (N, nh, T, d)
    rows = o.permute(0, 2, 1, 3).reshape(o.shape[0], ph * pw, c)
    return _unwindows(rows, part_type, ps, (h, w))


def plain_partition_attention_bwd(qkv: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
                                  part_type: str, ps, nh: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward in plain PyTorch: the twin of `_bwd_kernel`
    (partition_attention.py:185-229) and of `csrc/partition_attn_bwd.cu`.
    Returns (dqkv in qkv's dtype, dbias in fp32 summed over every window)."""
    b, h, w, c, ph, pw = _check_geometry(qkv, part_type, ps, nh)
    dt = qkv.dtype
    q, k, v = _heads(_windows(qkv, part_type, ps), nh)
    n, t = q.shape[0], ph * pw
    gh = _windows(g, part_type, ps).float().reshape(n, t, nh, -1).permute(0, 2, 1, 3)
    p = _probs(q, k, bias, dt)
    dv = torch.matmul(p.transpose(-1, -2), gh)
    dp = torch.matmul(gh, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dbias = ds.sum(dim=0)
    dsq = ds.to(dt).float()
    dq = torch.matmul(dsq, k)
    dk = torch.matmul(dsq.transpose(-1, -2), q)
    d = torch.stack([dq.to(dt), dk.to(dt), dv.to(dt)])  # (3, N, nh, T, d)
    rows = d.permute(1, 3, 0, 2, 4).reshape(n, t, 3 * c)
    return _unwindows(rows, part_type, ps, (h, w)), dbias


@functools.lru_cache(maxsize=None)
def _kernel_shape(name: str, shape, dtype, part_type: str, ps, nh: int,
                  bias_shape) -> Tuple[Tuple[int, ...], str]:
    """The checks of a launch that depend on the shapes alone, made once a
    shape (an exception is not cached, so a refused shape raises on every
    call): returns the geometry and the suffix of the instance's C entry."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} takes a bf16 or fp32 qkv map, got {dtype}")
    geo = _geometry(shape, part_type, ps, nh)
    b, h, w, c, ph, pw = geo
    t = ph * pw
    if c != nh * HEAD_DIM or t > MAX_TOKENS:
        raise ValueError(f"{name} takes heads of width {HEAD_DIM} and windows of at most "
                         f"{MAX_TOKENS} tokens, got C={c} in {nh} heads and T={t}")
    if bias_shape != (nh, t, t):
        raise ValueError(f"{name}: bias must be ({nh}, {t}, {t}) on the qkv's device, got "
                         f"{tuple(bias_shape)}")
    return geo, KERNEL_DTYPES[dtype]


def _check_kernel_operands(name: str, qkv: torch.Tensor, bias: torch.Tensor, part_type: str,
                           ps, nh: int) -> Tuple[int, torch.Tensor, Tuple[int, ...], str]:
    """Raises on anything the kernels do not take; returns the map's device
    index, the bias as a contiguous fp32 tensor, the geometry and the suffix
    of the instance's C entry. The checks of the shapes are made once a
    shape (`_kernel_shape`), the others read each attribute once: this runs
    on every launch, whose device time at MaxViT's stage-2 shapes is of the
    order of the host's."""
    if not qkv.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors; CPU tensors go to the plain twin")
    geo, suffix = _kernel_shape(name, qkv.shape, qkv.dtype, part_type, tuple(ps), nh,
                                bias.shape)
    if not qkv.is_contiguous():
        raise ValueError(f"{name} takes a contiguous qkv map")
    dev = qkv.get_device()
    if bias.get_device() != dev:
        raise ValueError(f"{name}: bias must be on the qkv's device, got {bias.device}")
    if qkv.data_ptr() % 16:
        raise ValueError(f"{name} needs a 16-byte aligned qkv map")
    if bias.dtype != torch.float32 or not bias.is_contiguous():
        bias = bias.float().contiguous()
    return dev, bias, geo, suffix


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.imt_cuda_error_string(err).decode()}")


@torch.library.custom_op("imtpu::partition_attn_fwd", mutates_args=())
def _partition_attn_fwd_op(qkv: torch.Tensor, bias: torch.Tensor, part_type: str,
                           ps: Sequence[int], nh: int) -> torch.Tensor:
    """The op `imtpu::partition_attn_fwd`: kernel 3's checks, launch and
    count (`fused_partition_attention.launches`). Raises on CPU tensors:
    there is no CPU registration, the caller picks the twin for those."""
    dev, bias, (b, h, w, c, ph, pw), suffix = _check_kernel_operands(
        "fused_partition_attention", qkv, bias, part_type, ps, nh)
    lib = _kernels.partition_attn_fwd_library()
    out = qkv.new_empty((b, h, w, c))
    if b == 0:
        return out
    entry = getattr(lib, f"imt_partition_attn_fwd_{suffix}")
    err = _kernels.launch(entry, dev, qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w,
                          c, nh, ph, pw, int(part_type == "grid"))
    _raise_on(lib, err, "partition_attn_fwd")
    fused_partition_attention.launches += 1
    return out


@_partition_attn_fwd_op.register_fake
def _partition_attn_fwd_fake(qkv, bias, part_type, ps, nh):
    """What kernel 3 writes, from shapes alone: a contiguous (B, H, W, C)
    map of qkv's dtype."""
    (b, h, w, c, _, _), _ = _kernel_shape("fused_partition_attention", tuple(qkv.shape),
                                          qkv.dtype, part_type, tuple(ps), nh, tuple(bias.shape))
    return qkv.new_empty((b, h, w, c))


_PARTITION_ATTN_FWD = torch.ops.imtpu.partition_attn_fwd.default


def fused_partition_attention(qkv: torch.Tensor, bias: torch.Tensor, part_type: str, ps,
                              nh: int) -> torch.Tensor:
    """Kernel 3, the CUDA partition-attention forward, on a bf16 or fp32
    (B, H, W, 3C) map and an fp32 (nh, T, T) bias; returns (B, H, W, C) in
    the map's dtype. Called through the custom op `imtpu::partition_attn_fwd`,
    which `torch.export` traces by its fake function.

    Replaces `_fwd_pallas` (ops/partition_attention.py:286). Raises on
    anything the kernel does not take, CPU tensors included.
    `fused_partition_attention.launches` counts launches."""
    return _PARTITION_ATTN_FWD(qkv, bias, part_type, ps, nh)


fused_partition_attention.launches = 0


@functools.lru_cache(maxsize=None)
def _bwd_blocks(windows: int, nh: int) -> int:
    """Kernel 4's blocks per head (`imt_partition_attn_bwd_blocks`), a
    function of the shape alone, asked once a shape."""
    return _kernels.partition_attn_bwd_library().imt_partition_attn_bwd_blocks(windows, nh)


def fused_partition_attention_bwd(qkv: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
                                  part_type: str, ps, nh: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 4, the CUDA partition-attention backward: (dqkv (B, H, W, 3C)
    in the map's dtype, dbias fp32 (nh, T, T)) from the bf16 or fp32 map, the
    bias and the cotangent g (B, H, W, C) of the map's dtype.

    Replaces `_bwd_pallas` (ops/partition_attention.py:310). In bf16 its
    products run on the tensor cores (fp32 sums in another order than the
    twin's). Each block sums its windows' dbias into a partial of its own; a
    second pass adds the partials in a fixed order, so the result is the
    same on every run. `fused_partition_attention_bwd.launches` counts calls
    that launched it."""
    dev, bias, (b, h, w, c, ph, pw), suffix = _check_kernel_operands(
        "fused_partition_attention_bwd", qkv, bias, part_type, ps, nh)
    if (g.shape != (b, h, w, c) or g.dtype != qkv.dtype or g.get_device() != dev
            or not g.is_contiguous() or g.data_ptr() % 16):
        raise ValueError(f"fused_partition_attention_bwd: the cotangent must be a contiguous "
                         f"{qkv.dtype} ({b}, {h}, {w}, {c}) map on the qkv's device, got "
                         f"{g.dtype} {tuple(g.shape)}")
    lib = _kernels.partition_attn_bwd_library()
    t = ph * pw
    windows = b * (h // ph) * (w // pw)
    if windows == 0:
        raise ValueError("fused_partition_attention_bwd needs at least one window")
    blocks = _bwd_blocks(windows, nh)
    dqkv = torch.empty_like(qkv)
    partials = bias.new_empty(nh * blocks * t * t)
    dbias = bias.new_empty((nh, t, t))
    entry = getattr(lib, f"imt_partition_attn_bwd_{suffix}")
    err = _kernels.launch(entry, dev, qkv.data_ptr(), bias.data_ptr(), g.data_ptr(),
                          dqkv.data_ptr(), partials.data_ptr(), dbias.data_ptr(), b, h, w, c, nh,
                          ph, pw, int(part_type == "grid"), blocks)
    _raise_on(lib, err, "partition_attn_bwd")
    fused_partition_attention_bwd.launches += 1
    return dqkv, dbias


fused_partition_attention_bwd.launches = 0


class PartitionAttentionFunction(torch.autograd.Function):
    """Partition attention on CUDA: kernel 3 forward, kernel 4 as its
    backward. Saves only the inputs, as JAX's custom VJP does
    (partition_attention.py:387-394); the backward recomputes p."""

    @staticmethod
    def forward(ctx, qkv, bias, part_type, ps, nh):
        ctx.save_for_backward(qkv, bias)
        ctx.geometry = (part_type, ps, nh)
        return fused_partition_attention(qkv, bias, part_type, ps, nh)

    @staticmethod
    def backward(ctx, g):
        qkv, bias = ctx.saved_tensors
        dqkv, dbias = fused_partition_attention_bwd(qkv, bias, g.contiguous(), *ctx.geometry)
        return dqkv, dbias.to(bias.dtype), None, None, None


def partition_attention(qkv: torch.Tensor, bias: torch.Tensor, *, part_type: str, ps,
                        num_heads: int, use_kernel: Optional[bool] = None) -> torch.Tensor:
    """softmax attention over the block windows or dilated grid windows of an
    unpartitioned (B, H, W, 3C) qkv map (q pre-scaled), with a (heads, T, T)
    bias; returns (B, H, W, C). The kernels for CUDA tensors, the twin for
    CPU tensors; `use_kernel` forces one. Differentiable either way."""
    ps = tuple(ps)
    if use_kernel is None:
        use_kernel = qkv.is_cuda
    if not use_kernel:
        return plain_partition_attention(qkv, bias, part_type, ps, num_heads)
    return PartitionAttentionFunction.apply(qkv.contiguous(), bias, part_type, ps, num_heads)

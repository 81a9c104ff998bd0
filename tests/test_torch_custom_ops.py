"""The forward kernels as `torch.library` custom ops (`ops/library.py`).

On the CPU: each op's fake function under `FakeTensorMode` against the
shape, dtype and strides of its twin's output on real tensors of the same
shapes; each public wrapper traced on fake tensors to one node of its op;
each op called on CPU tensors raises (there is no CPU registration and no
fallback). On the card (`cuda`-marked, run by `pytest --noconftest -m cuda`):
each wrapper's output through its op bit-equal to the bare C entry that the
wrappers called before the ops (the same kernel on the same inputs), within
the kernel's twin gate, and one launch counted per call.

This file imports no JAX, so that it runs on the card.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

from imagenet_models_tpu_torch.ops import _kernels
from imagenet_models_tpu_torch.ops import convnext_block as cb
from imagenet_models_tpu_torch.ops import flash_attention as fa
from imagenet_models_tpu_torch.ops import library
from imagenet_models_tpu_torch.ops import partition_attention as pa
from imagenet_models_tpu_torch.ops import stripe_attention as sa

DTYPES = [torch.bfloat16, torch.float32]
NH, HEAD = 2, 32
PS = (4, 4)
WS = 2
SCALE = HEAD ** -0.5


def _ln_mlp(dtype, device, gen):
    n, c = 40, 32
    r = lambda *s: torch.randn(*s, generator=gen).to(device)  # noqa: E731
    return ((r(n, c).to(dtype), 1 + 0.1 * r(c), 0.1 * r(c), r(4 * c, c) / c ** 0.5,
             0.1 * r(4 * c), r(c, 4 * c) / (2 * c), 0.1 * r(c), r(c), 1e-6, "exact"))


def _partition(dtype, device, gen):
    qkv = torch.randn(2, 8, 8, 3 * NH * HEAD, generator=gen).to(device, dtype)
    bias = torch.randn(NH, 16, 16, generator=gen).to(device)
    return (qkv, bias, "grid", PS, NH)


def _stripe(dtype, device, gen):
    # q, k, v as channel slices of one qkv map, as CSWin's attention gives them
    qkv = torch.randn(2, 8, 8, 3 * NH * HEAD, generator=gen).to(device, dtype)
    c = NH * HEAD
    w9 = 0.1 * torch.randn(9, c, generator=gen).to(device)
    wb = 0.1 * torch.randn(1, c, generator=gen).to(device)
    return (qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], w9, wb, WS, NH, SCALE)


def _window(dtype, device, gen):
    q, k, v = (torch.randn(6, 49, HEAD, generator=gen).to(device, dtype) for _ in range(3))
    return (q * SCALE, k, v, torch.randn(6, 49, 49, generator=gen).to(device))


def _heads(dtype, device, gen):
    q, k, v = (torch.randn(3, NH, 49, HEAD, generator=gen).to(device, dtype) for _ in range(3))
    return (q * SCALE, k, v, torch.randn(NH, 49, 49, generator=gen).to(device))


def _stripe_twin(q, k, v, w9, wb, ws, nh, scale):
    return sa.plain_stripe_attention(q, k, v, w9, wb, ws=ws, nh=nh, scale=scale)


# op name -> (its inputs, its public wrapper, the kernel's twin)
CASES = {
    "ln_mlp_fwd": (_ln_mlp, cb.fused_ln_mlp, cb.plain_ln_mlp),
    "partition_attn_fwd": (_partition, pa.fused_partition_attention,
                           pa.plain_partition_attention),
    "stripe_attn_fwd": (_stripe, sa.fused_stripe_attention, _stripe_twin),
    "window_attn_fwd": (_window, fa.fused_window_attention, fa.plain_fused_window_attention),
    "window_attn_heads_fwd": (_heads, fa.fused_window_attention_heads,
                              fa.plain_fused_window_attention_heads),
}


def test_every_forward_kernel_is_an_op():
    # importing the op library registers every op of the namespace, and
    # each is one of CASES
    registered = {name.split("::", 1)[1] for name in torch._C._dispatch_get_all_op_names()
                  if name.startswith(f"{library.NAMESPACE}::")}
    assert registered == set(CASES)
    for name in CASES:
        assert hasattr(torch.ops.imtpu, name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", sorted(CASES))
def test_fake_function_matches_the_twin(op, dtype):
    make, wrapper, twin = CASES[op]
    args = make(dtype, "cpu", torch.Generator().manual_seed(0))
    ref = twin(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        out = getattr(torch.ops.imtpu, op)(*fake_args)
    assert tuple(out.shape) == tuple(ref.shape) and out.dtype == ref.dtype == dtype
    assert out.is_contiguous()
    # the public wrapper traces to one node of its op, so the eager path and
    # an exported program take the same code
    graph = make_fx(wrapper, tracing_mode="fake")(*args).graph
    targets = [n.target for n in graph.nodes if n.op == "call_function"]
    assert targets.count(getattr(torch.ops.imtpu, op).default) == 1


@pytest.mark.parametrize("op", sorted(CASES))
def test_op_raises_on_cpu_tensors(op):
    make, wrapper, _ = CASES[op]
    args = make(torch.bfloat16, "cpu", torch.Generator().manual_seed(0))
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*args)
    assert wrapper.launches == before


# ---------------------------------------------------------------- on the card

def _c_entry(op, args):
    """The kernel's C entry called as the wrappers called it before the ops,
    with no op in between; its output."""
    if op == "ln_mlp_fwd":
        return cb.ln_mlp_fwd_pipeline(*args).out
    if op == "partition_attn_fwd":
        qkv, bias, part, ps, nh = args
        b, h, w, c3 = qkv.shape
        out = qkv.new_empty((b, h, w, c3 // 3))
        lib = _kernels.partition_attn_fwd_library()
        entry = getattr(lib, f"imt_partition_attn_fwd_{pa.KERNEL_DTYPES[qkv.dtype]}")
        err = _kernels.launch(entry, qkv.get_device(), qkv.data_ptr(), bias.data_ptr(),
                              out.data_ptr(), b, h, w, c3 // 3, nh, ps[0], ps[1],
                              int(part == "grid"))
    elif op == "stripe_attn_fwd":
        q, k, v, w9, wb, ws, nh, scale = args
        b, h, w, c = q.shape
        out = torch.empty(b, h, w, c, dtype=q.dtype, device=q.device)
        lib = _kernels.stripe_attn_fwd_library()
        entry = getattr(lib, f"imt_stripe_attn_fwd_{sa.KERNEL_DTYPES[q.dtype]}")
        err = entry(q.data_ptr(), sa._pixel_ld(q), k.data_ptr(), sa._pixel_ld(k), v.data_ptr(),
                    sa._pixel_ld(v), w9.data_ptr(), wb.data_ptr(), out.data_ptr(), b, h, w, c,
                    nh, ws, sa._scale_in(scale, q.dtype), torch.cuda.current_stream().cuda_stream)
    elif op == "window_attn_fwd":
        q, k, v, bias = args
        out = torch.empty_like(q)
        lib = _kernels.window_attn_fwd_library()
        err = _kernels.launch(lib.imt_window_attn_fwd, q.get_device(), q.data_ptr(),
                              k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                              *q.shape, int(q.dtype == torch.bfloat16))
    else:
        q, k, v, bias = args
        out = torch.empty_like(q)
        lib = _kernels.window_attn_heads_fwd_library()
        err = _kernels.launch(lib.imt_window_attn_heads_fwd, q.get_device(), q.data_ptr(),
                              k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                              *q.shape, int(q.dtype == torch.bfloat16))
    assert err == 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", sorted(CASES))
def test_op_is_the_kernel_on_cuda(op, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    make, wrapper, twin = CASES[op]
    args = make(dtype, "cuda", torch.Generator().manual_seed(1))
    before = wrapper.launches
    got = wrapper(*args)
    assert wrapper.launches == before + 1
    bare = _c_entry(op, args)
    torch.cuda.synchronize()
    assert torch.equal(got, bare)
    ref = twin(*args)
    # the kernels' twin gates: sums in other orders, a rounded p or output
    # may round to its neighbour; 1e-2 of the largest |output| in bf16, 1e-4
    # in fp32
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert (got.float() - ref.float()).abs().max().item() <= tol * ref.float().abs().max().item()

"""The port's fused window attention (kernels 12 and 13) against the JAX
package, and the dispatch rule.

`plain_fused_window_attention` and `plain_fused_window_attention_heads`
(imagenet_models_tpu_torch/ops/flash_attention.py), the twins of the CUDA
kernels 12 and 13, are held to the Pallas kernels `fused_window_attention` /
`fused_window_attention_heads` run in interpret mode, at the shapes of
tests/test_flash_attention.py (CSWin's stripes of 56 and 98 tokens, the
7x7 window, a ragged 50 x 24), with and without a bias, on the same numpy
inputs. The dispatchers and the autograd functions' pullbacks are held to
JAX's `window_attention` / `window_attention_heads` on the CPU (JAX's plain
composition there) and to `jax.vjp` of that composition, which is what JAX's
custom VJPs pull back through. The CUDA kernels are held to the twins on a
GPU (the `cuda`-marked tests, and chip_smoke.py).

This file imports jax only inside the tests that need it, so the GPU cases
can be collected on a machine without jax.
"""

import numpy as np
import pytest
import torch

from imagenet_models_tpu_torch.ops import flash_attention as tfa

# (BW, N, D): tests/test_flash_attention.py:27
SHAPES = [(16, 56, 32), (8, 98, 32), (16, 49, 32), (4, 50, 24)]
# (BW, H, N, D): tests/test_flash_attention.py:67, then the shapes where
# kernel 13's tensor-core tiles pad or split: one 16-row tile, a window of
# exactly 64 keys, 65 keys (a second key chunk), and heads of 16, 24
# (padded to 32) and 48 channels
HEAD_SHAPES = [(8, 2, 49, 32), (4, 3, 50, 24), (2, 2, 16, 16), (2, 2, 64, 24), (2, 2, 65, 48)]
NEW_HEAD_SHAPES = HEAD_SHAPES[2:]
# fp32 on both sides: only the summation order differs
# (tests/test_flash_attention.py:43)
F32 = dict(rtol=2e-6, atol=2e-6)


def _inputs(shape, bias_shape, seed=0):
    """numpy q, k, v of `shape` and a bias of `bias_shape` (or None), all 0.3 N(0, 1)."""
    rng = np.random.default_rng(seed)
    f = lambda s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    return f(shape), f(shape), f(shape), None if bias_shape is None else f(bias_shape)


def _torch(*arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(dtype) for a in arrays]


def _pallas(q, k, v, bias, heads: bool, dtype):
    """JAX's Pallas kernel in interpret mode on numpy inputs cast to `dtype`."""
    import jax
    import jax.numpy as jnp

    from imagenet_models_tpu.ops import flash_attention as jfa

    arr = lambda a: None if a is None else jnp.asarray(a, dtype)
    fn = jfa.fused_window_attention_heads if heads else jfa.fused_window_attention
    with jax.default_matmul_precision("highest"):
        out = fn(arr(q), arr(k), arr(v), None if bias is None else jnp.asarray(bias),
                 interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("bw,n,d", SHAPES)
def test_twin_matches_pallas_kernel(bw, n, d, with_bias):
    q, k, v, b = _inputs((bw, n, d), (bw, n, n) if with_bias else None)
    got = tfa.plain_fused_window_attention(*_torch(q, k, v, b))
    np.testing.assert_allclose(got.numpy(), _pallas(q, k, v, b, False, np.float32), **F32)


@pytest.mark.parametrize("bw,h,n,d", HEAD_SHAPES)
def test_heads_twin_matches_pallas_kernel(bw, h, n, d):
    q, k, v, b = _inputs((bw, h, n, d), (h, n, n), seed=3)
    got = tfa.plain_fused_window_attention_heads(*_torch(q, k, v, b))
    np.testing.assert_allclose(got.numpy(), _pallas(q, k, v, b, True, np.float32), **F32)


@pytest.mark.parametrize("bw,h,n,d", NEW_HEAD_SHAPES)
def test_heads_bf16_twin_matches_pallas_kernel(bw, h, n, d):
    """bf16 q, k, v at the tensor-core tiles' edge shapes, against the Pallas
    kernel on the same bf16 values: within 1e-2 of the largest |output| (2.5
    bf16 ulps), as `test_bf16_twins_match_pallas_kernel`."""
    import jax.numpy as jnp

    q, k, v, b = _inputs((bw, h, n, d), (h, n, n), seed=14)
    got = tfa.plain_fused_window_attention_heads(*_torch(q, k, v, dtype=torch.bfloat16),
                                                 torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    ref = _pallas(q, k, v, b, True, jnp.bfloat16)
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 1e-2 * np.abs(ref).max(), err


@pytest.mark.parametrize("heads", [False, True])
def test_bf16_twins_match_pallas_kernel(heads):
    """bf16 q, k, v and an fp32 bias on both sides: both keep the scores in
    fp32 from exact products and round p and the output to bf16, so they
    differ where a sum taken in another order rounds to the neighbouring
    bf16 value: within 1e-2 of the largest |output| (2.5 bf16 ulps)."""
    import jax.numpy as jnp

    shape, bshape = ((8, 2, 49, 32), (2, 49, 49)) if heads else ((16, 56, 32), (16, 56, 56))
    q, k, v, b = _inputs(shape, bshape, seed=4)
    fn = tfa.plain_fused_window_attention_heads if heads else tfa.plain_fused_window_attention
    got = fn(*_torch(q, k, v, dtype=torch.bfloat16), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    ref = _pallas(q, k, v, b, heads, jnp.bfloat16)
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 1e-2 * np.abs(ref).max(), err
    # the twin rounds p: it is not the fp32 function of the rounded inputs
    exact = fn(*(t.float() for t in _torch(q, k, v, dtype=torch.bfloat16)), torch.from_numpy(b))
    assert 0 < (got.float() - exact).abs().max().item() <= 2e-2 * exact.abs().max().item()


@pytest.mark.parametrize("heads,with_bias", [(False, False), (False, True), (True, True)])
def test_dispatchers_and_gradients_match_jax(heads, with_bias):
    """Forward and the gradients of q, k, v and the bias through the port's
    CPU dispatch (autograd of the twin) against JAX's CPU dispatch (autodiff
    of its plain composition), in fp32, where the two functions agree."""
    import jax
    import jax.numpy as jnp

    from imagenet_models_tpu.ops import flash_attention as jfa

    shape = (4, 3, 50, 24) if heads else (6, 56, 32)
    n = shape[-2]
    bshape = (shape[1], n, n) if heads else (shape[0], n, n)
    q, k, v, b = _inputs(shape, bshape if with_bias else None, seed=5)
    g = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    jfn = jfa.window_attention_heads if heads else jfa.window_attention
    tfn = tfa.window_attention_heads if heads else tfa.window_attention
    args = [jnp.asarray(a) for a in (q, k, v, b) if a is not None]
    with jax.default_matmul_precision("highest"):
        ref, vjp = jax.vjp(jfn, *args)
        ref_grads = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_() for t in _torch(*(a for a in (q, k, v, b) if a is not None))]
    before = (tfa.fused_window_attention.launches, tfa.fused_window_attention_heads.launches)
    out = tfn(*leaves)
    out.backward(torch.from_numpy(g))
    assert (tfa.fused_window_attention.launches,
            tfa.fused_window_attention_heads.launches) == before  # CPU: the twin
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    for t, r in zip(leaves, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("heads", [False, True])
def test_autograd_functions_pull_back_through_the_composition(heads, monkeypatch):
    """The autograd functions' backward, run on the CPU with the kernel
    wrapper replaced by its twin: the gradients are those of `jax.vjp` of
    JAX's plain composition (its custom VJP's pullback) in fp32, where the
    twin is the composition's function, and in bf16 bit for bit those of
    autograd through the twin, the kernel's own numerics."""
    import jax
    import jax.numpy as jnp

    from imagenet_models_tpu.ops import flash_attention as jfa

    monkeypatch.setattr(tfa, "fused_window_attention", tfa.plain_fused_window_attention)
    monkeypatch.setattr(tfa, "fused_window_attention_heads",
                        tfa.plain_fused_window_attention_heads)
    shape, bshape = ((4, 2, 49, 32), (2, 49, 49)) if heads else ((6, 98, 32), (6, 98, 98))
    fn = tfa.WindowAttentionHeadsFunction if heads else tfa.WindowAttentionFunction
    twin = tfa.plain_fused_window_attention_heads if heads else tfa.plain_fused_window_attention
    jplain = jfa.plain_window_attention_heads if heads else jfa.plain_window_attention
    q, k, v, b = _inputs(shape, bshape, seed=7)
    g = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(jplain, *(jnp.asarray(a) for a in (q, k, v, b)))
        ref = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_() for t in _torch(q, k, v, b)]
    fn.apply(*leaves).backward(torch.from_numpy(g))
    for t, r in zip(leaves, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)

    # bf16 operands, fp32 bias; only q needs a gradient
    q16, k16, v16 = _torch(q, k, v, dtype=torch.bfloat16)
    bias = torch.from_numpy(b)
    g16 = torch.from_numpy(g).bfloat16()
    tq = q16.clone().requires_grad_()
    fn.apply(tq, k16, v16, bias).backward(g16)
    rq = q16.clone().requires_grad_()
    twin(rq, k16, v16, bias).backward(g16)
    assert tq.grad.dtype == torch.bfloat16
    assert torch.equal(tq.grad, rq.grad)


@pytest.mark.parametrize("heads", [False, True])
def test_bf16_pullback_is_nearer_fp32_than_the_compositions(heads):
    """In bf16 the twin's pullback, the autograd functions' backward, is
    nearer the fp32 gradients at the same bf16 operands than autograd of the
    composition, which rounds the scores and the score gradient to bf16:
    each gradient (q, k, v, bias) at most 0.004 (L2 relative) from fp32 and
    at most half the composition's distance, at scores of unit scale."""
    shape, bshape = ((4, 2, 49, 32), (2, 49, 49)) if heads else ((6, 98, 32), (6, 98, 98))
    twin = tfa.plain_fused_window_attention_heads if heads else tfa.plain_fused_window_attention
    comp = tfa.plain_window_attention_heads if heads else tfa.plain_window_attention
    q, k, v, b = (a / 0.3 for a in _inputs(shape, bshape, seed=7))
    q16, k16, v16 = _torch(q, k, v, dtype=torch.bfloat16)
    g16 = torch.from_numpy(np.random.default_rng(8).standard_normal(shape).astype(np.float32)
                           ).bfloat16()

    def grads(fn, dtype):
        leaves = [t.to(dtype).requires_grad_() for t in (q16, k16, v16)]
        bias = torch.from_numpy(b).requires_grad_()
        fn(*leaves, bias).backward(g16.to(dtype))
        return [t.grad.float() for t in leaves + [bias]]

    ref = grads(twin, torch.float32)
    rel = lambda a, r: ((a - r).norm() / r.norm()).item()
    for t, c, r in zip(grads(twin, torch.bfloat16), grads(comp, torch.bfloat16), ref):
        assert rel(t, r) <= 0.004 and rel(t, r) <= 0.5 * rel(c, r), (rel(t, r), rel(c, r))


def test_cpu_dispatch_runs_the_twin_and_wrappers_refuse_cpu():
    q, k, v, b = _torch(*_inputs((4, 49, 32), (4, 49, 49), seed=9))
    before = tfa.fused_window_attention.launches
    torch.testing.assert_close(tfa.window_attention(q, k, v, b),
                               tfa.plain_fused_window_attention(q, k, v, b), rtol=0, atol=0)
    assert tfa.fused_window_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tfa.window_attention(q, k, v, b, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.window_attention_heads(q[None], k[None], v[None], b, use_kernel=True)
    # in fp32 the twin is the composition's function
    torch.testing.assert_close(tfa.plain_fused_window_attention(q, k, v, b),
                               tfa.plain_window_attention(q, k, v, b), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- on the card

def _cuda(shape, bias_shape, dtype, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, b = _inputs(shape, bias_shape, seed=seed)
    qkv = [torch.from_numpy(a).to(dtype).cuda() for a in (q, k, v)]
    return (*qkv, None if b is None else torch.from_numpy(b).cuda())


def _float64_reference(q, k, v, b):
    """softmax(q k^T [+ b]) v in float64, b broadcast to the scores."""
    s = torch.matmul(q.double(), k.double().transpose(-1, -2))
    return torch.matmul(torch.softmax(s if b is None else s + b.double(), -1), v.double())


def _assert_kernel_close(got, ref):
    # both sum in fp32 in other orders, and a rounded p or output may round
    # to its neighbour: 1e-2 of the largest |output| is 2.5 bf16 ulps; fp32
    # keeps every digit of p, so its bound is 1e-5
    assert got.shape == ref.shape and got.dtype == ref.dtype
    tol = 1e-2 if got.dtype == torch.bfloat16 else 1e-5
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


# (BW, N, D) for kernel 12: GA-CSWin's stripes (56, 98) and full window (49),
# the 384 and 512 px windows (144, 256), a ragged 50 x 24, and heads of 128;
# then where its tensor-core tiles pad or split: one token, one 16-row block
# of 8 or 16 channels, 129 keys (a second key chunk), and heads of 48 and 80
# channels (the instances whose window blocks are counted at run time)
GPU_SHAPES = [(64, 56, 32), (32, 98, 32), (48, 49, 32), (8, 144, 32), (4, 256, 32),
              (5, 50, 24), (3, 256, 128), (7, 33, 64), (5, 1, 8), (6, 16, 16), (4, 129, 32),
              (3, 200, 48), (2, 112, 80)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("bw,n,d", GPU_SHAPES)
def test_kernel12_matches_twin_on_cuda(bw, n, d, with_bias, dtype):
    """Kernel 12 against its twin; in bf16 (tensor cores, sums in another
    order than the twin's) also against the float64 function of the same
    inputs: its error at most 1.25 times the twin's."""
    q, k, v, b = _cuda((bw, n, d), (bw, n, n) if with_bias else None, dtype, seed=10)
    out = tfa.fused_window_attention(q, k, v, b)
    torch.cuda.synchronize()
    twin = tfa.plain_fused_window_attention(q, k, v, b)
    _assert_kernel_close(out, twin)
    assert torch.equal(tfa.fused_window_attention(q, k, v, b), out)  # fixed sum order
    if dtype == torch.bfloat16:
        ref = _float64_reference(q, k, v, b)
        err = (out.double() - ref).abs().max().item()
        assert err <= 1.25 * (twin.double() - ref).abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bw,h,n,d", [(9, 2, 49, 32), (4, 16, 49, 32), (3, 4, 144, 32),
                                      (2, 3, 256, 32), (5, 3, 50, 24), (7, 3, 16, 16),
                                      (7, 3, 64, 24), (7, 3, 65, 48), (3, 2, 49, 128),
                                      (5, 2, 1, 8)])
def test_kernel13_matches_twin_on_cuda(bw, h, n, d, dtype):
    """Kernel 13 against its twin; in bf16 (tensor cores, sums in another
    order than the twin's) also against the float64 function of the same
    inputs: its error at most 1.25 times the twin's."""
    q, k, v, b = _cuda((bw, h, n, d), (h, n, n), dtype, seed=11)
    out = tfa.fused_window_attention_heads(q, k, v, b)
    torch.cuda.synchronize()
    twin = tfa.plain_fused_window_attention_heads(q, k, v, b)
    _assert_kernel_close(out, twin)
    assert torch.equal(tfa.fused_window_attention_heads(q, k, v, b), out)
    if dtype == torch.bfloat16:
        ref = _float64_reference(q, k, v, b[None])
        err = (out.double() - ref).abs().max().item()
        assert err <= 1.25 * (twin.double() - ref).abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [False, True])
def test_autograd_on_cuda_runs_the_kernel(heads):
    shape, bshape = ((6, 2, 49, 32), (2, 49, 49)) if heads else ((12, 56, 32), (12, 56, 56))
    q, k, v, b = _cuda(shape, bshape, torch.bfloat16, seed=12)
    g = torch.randn(shape, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, b)]
    counter = tfa.fused_window_attention_heads if heads else tfa.fused_window_attention
    before = counter.launches
    out = (tfa.window_attention_heads if heads else tfa.window_attention)(*leaves)
    out.backward(g.bfloat16())
    assert counter.launches - before == 1
    refs = [t.clone().requires_grad_() for t in (q, k, v, b)]
    plain = tfa.plain_window_attention_heads if heads else tfa.plain_window_attention
    plain(*refs).backward(g.bfloat16())
    for t, r in zip(leaves, refs):
        assert torch.equal(t.grad, r.grad)  # the pullback is autograd of the composition


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_cannot_take_on_cuda():
    q, k, v, b = _cuda((4, 49, 32), (4, 49, 49), torch.bfloat16, seed=13)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        tfa.fused_window_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        tfa.fused_window_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="bias"):
        tfa.fused_window_attention(q, k, v, b[:1])
    with pytest.raises(ValueError, match="dtype"):
        tfa.fused_window_attention(q, k.float(), v)
    wide = torch.zeros(2, 49, 36, dtype=torch.bfloat16, device="cuda")  # D not a multiple of 8
    with pytest.raises(ValueError, match="steps of 8"):
        tfa.fused_window_attention(wide, wide, wide)
    big = torch.zeros(1, 1, 289, 32, dtype=torch.bfloat16, device="cuda")  # 17 x 17 tokens
    with pytest.raises(ValueError, match="256"):
        tfa.fused_window_attention_heads(big, big, big, torch.zeros(1, 289, 289, device="cuda"))

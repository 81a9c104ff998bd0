"""The port's partition attention (MaxViT window / grid attention) against the
JAX package, and the dispatch rule.

`plain_partition_attention` and `plain_partition_attention_bwd`
(imagenet_models_tpu_torch/ops/partition_attention.py), the twins of the CUDA
kernels 3 and 4, are held to JAX's `plain_partition_attention` and to the
Pallas kernels `_fwd_pallas` / `_bwd_pallas` run in interpret mode, at the
geometry of tests/test_partition_attention.py (block and grid, pack 1 and 2,
square and non-square maps), on the same numpy inputs in fp32. The CUDA
kernels are held to the twins on a GPU (the `cuda`-marked tests, and
chip_smoke.py).

This file imports jax only inside the tests that need it, so the GPU cases can
be collected on a machine without jax.
"""

import numpy as np
import pytest
import torch

from imagenet_models_tpu_torch.ops import partition_attention as tpa

PS = (7, 7)
# (b, h, w, c, nh, part_type): tests/test_partition_attention.py:21-30
CASES = [
    (2, 14, 14, 64, 2, "block"),
    (2, 14, 14, 64, 2, "grid"),
    (1, 28, 28, 128, 4, "block"),
    (1, 28, 28, 128, 4, "grid"),
    (2, 14, 21, 96, 3, "block"),
    (2, 14, 21, 96, 3, "grid"),
    (3, 21, 14, 64, 2, "block"),
    (3, 21, 14, 64, 2, "grid"),
]


def _inputs(b, h, w, c, nh, ps=PS, seed=0):
    """numpy qkv (b, h, w, 3c), bias (nh, T, T) and cotangent (b, h, w, c)."""
    rng = np.random.default_rng(seed)
    t = ps[0] * ps[1]
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    return f(b, h, w, 3 * c), f(nh, t, t, scale=0.1), f(b, h, w, c)


def _packs(w):
    """The pack factors JAX can run at width w: 1, and 2 where the windows of
    a row pair up."""
    return [1, 2] if (w // PS[1]) % 2 == 0 else [1]


@pytest.mark.parametrize("b,h,w,c,nh,part", CASES)
def test_forward_twin_matches_jax(b, h, w, c, nh, part):
    """Against JAX's plain twin at every pack, and against the Pallas forward
    in interpret mode at JAX's own pack."""
    import jax
    import jax.numpy as jnp

    from imagenet_models_tpu.ops import partition_attention as jpa

    qkv, bias, _ = _inputs(b, h, w, c, nh)
    got = tpa.plain_partition_attention(torch.from_numpy(qkv), torch.from_numpy(bias), part,
                                        PS, nh).numpy()
    with jax.default_matmul_precision("highest"):
        for pack in _packs(w):
            ref = jpa.plain_partition_attention(jnp.asarray(qkv), jnp.asarray(bias),
                                                part_type=part, ps=PS, nh=nh, pack=pack)
            np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
        ref = jpa._fwd_pallas(jnp.asarray(qkv), jnp.asarray(bias), part_type=part, ps=PS, nh=nh,
                              pack=jpa._pack_factor(PS, h, w), interpret=True)
    # fp32 on both sides: only the summation order differs
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,w,c,nh,part", CASES[:6])
def test_backward_twin_and_autograd_match_pallas_backward(b, h, w, c, nh, part):
    import jax
    import jax.numpy as jnp

    from imagenet_models_tpu.ops import partition_attention as jpa

    qkv, bias, g = _inputs(b, h, w, c, nh, seed=3)
    with jax.default_matmul_precision("highest"):
        dq_ref, db_ref = jpa._bwd_pallas(jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(g),
                                         part_type=part, ps=PS, nh=nh,
                                         pack=jpa._pack_factor(PS, h, w), interpret=True)
    dq, db = tpa.plain_partition_attention_bwd(torch.from_numpy(qkv), torch.from_numpy(bias),
                                               torch.from_numpy(g), part, PS, nh)
    assert dq.shape == qkv.shape and db.shape == bias.shape and db.dtype == torch.float32
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_ref), rtol=2e-5, atol=2e-5)

    # the CPU dispatch: autograd through the forward twin gives the same
    tq = torch.from_numpy(qkv).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    before = tpa.fused_partition_attention_bwd.launches
    tpa.partition_attention(tq, tb, part_type=part, ps=PS, num_heads=nh).backward(
        torch.from_numpy(g))
    assert tpa.fused_partition_attention_bwd.launches == before
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(dq_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(db_ref), rtol=2e-5, atol=2e-5)


def test_bf16_twin_rounds_p_and_ds():
    """In bf16 the twins round where the kernels round. Against the fp32
    twins run on the bf16 inputs, the forward moves by bf16 output rounding
    and the rounded p; the backward's dbias moves by the rounded p only, since
    its ds is summed unrounded."""
    qkv, bias, g = _inputs(2, 14, 14, 64, 2, seed=5)
    q16 = torch.from_numpy(qkv).bfloat16()
    g16 = torch.from_numpy(g).bfloat16()
    b = torch.from_numpy(bias)
    out = tpa.plain_partition_attention(q16, b, "grid", PS, 2)
    assert out.dtype == torch.bfloat16
    ref = tpa.plain_partition_attention(q16.float(), b, "grid", PS, 2)
    err = (out.float() - ref).abs().max().item()
    assert 0 < err <= 2e-2 * ref.abs().max().item()
    dq, db = tpa.plain_partition_attention_bwd(q16, b, g16, "grid", PS, 2)
    assert dq.dtype == torch.bfloat16 and db.dtype == torch.float32
    dq_ref, db_ref = tpa.plain_partition_attention_bwd(q16.float(), b, g16.float(), "grid", PS, 2)
    assert (db - db_ref).abs().max().item() <= 2e-2 * db_ref.abs().max().item()
    assert (dq.float() - dq_ref).abs().max().item() <= 3e-2 * dq_ref.abs().max().item()


def test_cpu_dispatch_runs_the_twin_and_wrappers_refuse_cpu():
    qkv, bias, g = (torch.from_numpy(a) for a in _inputs(1, 14, 14, 64, 2, seed=6))
    before = tpa.fused_partition_attention.launches
    got = tpa.partition_attention(qkv, bias, part_type="block", ps=PS, num_heads=2)
    torch.testing.assert_close(got, tpa.plain_partition_attention(qkv, bias, "block", PS, 2),
                               rtol=0, atol=0)
    assert tpa.fused_partition_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tpa.partition_attention(qkv, bias, part_type="block", ps=PS, num_heads=2, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.fused_partition_attention_bwd(qkv, bias, g, "grid", PS, 2)
    with pytest.raises(ValueError, match="part_type"):
        tpa.plain_partition_attention(qkv, bias, "stripe", PS, 2)
    with pytest.raises(ValueError, match="windows"):
        tpa.plain_partition_attention(qkv[:, :13], bias, "block", PS, 2)


# ---------------------------------------------------------------- on the card

def _cuda_inputs(b, h, w, nh, ps, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv, bias, g = _inputs(b, h, w, 32 * nh, nh, ps=ps, seed=seed)
    return (torch.from_numpy(qkv).bfloat16().cuda(), torch.from_numpy(bias).cuda(),
            torch.from_numpy(g).bfloat16().cuda())


def _assert_kernel_close(got, ref):
    # both sum in fp32 in other orders, and a bf16-rounded p or ds may round
    # to its neighbour: 1e-2 of the largest |output| is 2.5 bf16 ulps
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item(), err


def _float64_reference(qkv, bias, g, part, ps, nh):
    """out, dqkv and dbias of the same inputs in float64, with no rounding (p
    and ds exact)."""
    h, w = qkv.shape[1:3]
    c, t = qkv.shape[-1] // 3, ps[0] * ps[1]
    rows = tpa._windows(qkv, part, ps).double()
    n = rows.shape[0]
    q, k, v = rows.reshape(n, t, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
    gh = tpa._windows(g, part, ps).double().reshape(n, t, nh, c // nh).transpose(1, 2)
    p = torch.softmax(q @ k.transpose(-1, -2) + bias.double(), dim=-1)
    dp = gh @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    grads = torch.stack([ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ gh])
    back = lambda x: tpa._unwindows(x, part, ps, (h, w))
    return (back((p @ v).transpose(1, 2).reshape(n, t, c)),
            back(grads.permute(1, 3, 0, 2, 4).reshape(n, t, 3 * c)), ds.sum(dim=0))


# (b, h, w, heads, window): T = 49 at the three MaxViT-T stage shapes (small
# batch, one odd), T = 144 and 256 (the 384 and 512 px models), a non-square
# map and windows that are not square; T = 49 with more windows per head
# than a launch of either kernel has blocks (a block walks several, copying
# the next window in while it computes one), and an odd batch on a
# non-square map
GPU_CASES = [(2, 56, 56, 2, (7, 7)), (2, 28, 28, 4, (7, 7)), (3, 14, 14, 8, (7, 7)),
             (2, 14, 21, 3, (7, 7)), (2, 24, 24, 3, (12, 12)), (1, 32, 32, 2, (16, 16)),
             (2, 12, 15, 2, (4, 5)), (16, 56, 56, 2, (7, 7)), (5, 14, 21, 3, (7, 7))]


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["block", "grid"])
@pytest.mark.parametrize("b,h,w,nh,ps", GPU_CASES)
def test_kernels_match_twins_on_cuda(b, h, w, nh, ps, part):
    """Each output (out, dqkv, dbias) may be no farther from the float64
    function of the inputs than 1.25 times the twin's error (both kernels
    sum in other orders than the twin: kernel 4's bf16 instance on the
    tensor cores, kernel 3 in FMA chains). Every sum has a fixed order (no
    atomics): the same bits on every run."""
    qkv, bias, g = _cuda_inputs(b, h, w, nh, ps, seed=7)
    got = (tpa.fused_partition_attention(qkv, bias, part, ps, nh),
           *tpa.fused_partition_attention_bwd(qkv, bias, g, part, ps, nh))
    again = (tpa.fused_partition_attention(qkv, bias, part, ps, nh),
             *tpa.fused_partition_attention_bwd(qkv, bias, g, part, ps, nh))
    torch.cuda.synchronize()
    twin = (tpa.plain_partition_attention(qkv, bias, part, ps, nh),
            *tpa.plain_partition_attention_bwd(qkv, bias, g, part, ps, nh))
    exact = _float64_reference(qkv, bias, g, part, ps, nh)
    for name, o, a, r, x in zip(("out", "dqkv", "dbias"), got, again, twin, exact):
        _assert_kernel_close(o, r)
        assert torch.equal(o, a), name
        err = (o.double() - x).abs().max().item()
        assert err <= 1.25 * (r.double() - x).abs().max().item(), (name, err)


@pytest.mark.cuda
def test_autograd_on_cuda_runs_both_kernels():
    qkv, bias, g = _cuda_inputs(2, 14, 14, 2, PS, seed=8)
    tq, tb = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    fwd, bwd = tpa.fused_partition_attention.launches, tpa.fused_partition_attention_bwd.launches
    out = tpa.partition_attention(tq, tb, part_type="grid", ps=PS, num_heads=2)
    out.backward(g)
    assert (tpa.fused_partition_attention.launches - fwd,
            tpa.fused_partition_attention_bwd.launches - bwd) == (1, 1)
    dq_ref, db_ref = tpa.plain_partition_attention_bwd(qkv, bias, g, "grid", PS, 2)
    _assert_kernel_close(tq.grad, dq_ref)
    _assert_kernel_close(tb.grad, db_ref)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_cannot_take_on_cuda():
    qkv, bias, g = _cuda_inputs(1, 14, 14, 2, PS, seed=9)
    with pytest.raises(TypeError, match="bf16 or fp32"):  # fp16; fp32 has an instance
        tpa.fused_partition_attention(qkv.half(), bias, "block", PS, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tpa.fused_partition_attention(qkv.transpose(1, 2), bias, "block", PS, 2)
    with pytest.raises(ValueError, match="bias"):
        tpa.fused_partition_attention(qkv, bias[:1], "block", PS, 2)
    with pytest.raises(ValueError, match="cotangent"):
        tpa.fused_partition_attention_bwd(qkv, bias, g.float(), "block", PS, 2)
    wide = torch.zeros(1, 14, 14, 3 * 96, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="width"):  # heads of 48 channels
        tpa.fused_partition_attention(wide, bias, "block", PS, 2)
    big = torch.zeros(1, 17, 17, 3 * 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="256"):  # T = 289
        tpa.fused_partition_attention(big, torch.zeros(2, 289, 289, device="cuda"), "block",
                                      (17, 17), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["block", "grid"])
@pytest.mark.parametrize("b,h,w,nh,ps", [(2, 14, 14, 2, (7, 7)), (1, 32, 32, 2, (16, 16)),
                                         (2, 12, 15, 2, (4, 5))])
def test_fp32_instances_match_twins_on_cuda(b, h, w, nh, ps, part):
    """Kernels 3 and 4 on an fp32 map (an fp32 model) run their fp32
    instances, with no rounding to bf16: fp32 sums in other orders than the
    twins', within 1e-4 of the twin's largest |value|."""
    qkv, bias, g = (t.float() for t in _cuda_inputs(b, h, w, nh, ps, seed=10))
    out = tpa.fused_partition_attention(qkv, bias, part, ps, nh)
    dq, db = tpa.fused_partition_attention_bwd(qkv, bias, g, part, ps, nh)
    dq_ref, db_ref = tpa.plain_partition_attention_bwd(qkv, bias, g, part, ps, nh)
    for got, ref in ((out, tpa.plain_partition_attention(qkv, bias, part, ps, nh)),
                     (dq, dq_ref), (db, db_ref)):
        assert got.dtype == ref.dtype == torch.float32 and got.shape == ref.shape
        assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()

"""The port's BatchNorm statistics (imagenet_models_tpu_torch/ops/batch_norm.py)
against the JAX package, the dispatch rule, the gate and the BatchNorm module.

`plain_channel_moments` and `plain_channel_dot_sums`, the twins of the CUDA
kernels 7 and 8, are held to the Pallas kernels `channel_moments` and
`channel_dot_sums` in interpret mode, at the shapes of
tests/test_batch_norm_kernel.py and its tolerances (rtol 1e-5, atol 1e-4),
and to float64 sums. `BNTrainFunction` (forward, and its explicit backward
with non-zero cotangents on y, mean and var) is held to `fused_bn_train`
under `force_tpu_interpret_mode` and `jax.grad`; mode "0" to autodiff of
JAX's `plain_bn_train`. The CUDA kernels are held to their twins and to
float64 sums on a GPU (the `cuda`-marked tests, and chip_smoke.py).

This file imports jax only inside the tests that need it, so the GPU cases
can be collected on a machine without jax.
"""

import numpy as np
import pytest
import torch

from imagenet_models_tpu_torch.nn import layers as tl
from imagenet_models_tpu_torch.ops import batch_norm as tbn

SHAPES = [(4, 8, 8, 64), (2, 16, 16, 96), (8, 8, 8, 128)]  # test_batch_norm_kernel.py:32
PALLAS_TOL = dict(rtol=1e-5, atol=1e-4)                      # test_batch_norm_kernel.py:38-49


def _x(shape, seed=0):
    """numpy N(0.5, 2^2) values: test_batch_norm_kernel.py:27-29."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)


def _affine(c):
    return _x((c,), 3) * 0.5 + 1.0, _x((c,), 4) * 0.1


@pytest.fixture
def mode(monkeypatch, request):
    """Sets the switch of both packages to `request.param` for one test."""
    from imagenet_models_tpu.ops import batch_norm as jbn

    monkeypatch.setattr(jbn, "_PALLAS_BN_MODE", request.param)
    monkeypatch.setattr(tbn, "_PALLAS_BN_MODE", request.param)
    return request.param


# ---------------------------------------------------------------- the twins

@pytest.mark.parametrize("shape", SHAPES)
def test_moments_twin_matches_pallas(shape):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from imagenet_models_tpu.ops import batch_norm as jbn

    x = _x(shape)
    with pltpu.force_tpu_interpret_mode():
        ref = jbn.channel_moments(jnp.asarray(x))
    got = tbn.plain_channel_moments(torch.from_numpy(x))
    xf = x.astype(np.float64).reshape(-1, shape[-1])
    for g, r, exact in zip(got, ref, (xf.sum(0), (xf * xf).sum(0))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **PALLAS_TOL)
        np.testing.assert_allclose(g.numpy(), exact, **PALLAS_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_sums_twin_matches_pallas(dtype):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from imagenet_models_tpu.ops import batch_norm as jbn

    a, b = _x((4, 8, 8, 64), 1), _x((4, 8, 8, 64), 2)
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = jbn.channel_dot_sums(ja, jb)
    ta, tb = (torch.from_numpy(np.asarray(t.astype(jnp.float32))).to(getattr(torch, dtype))
              for t in (ja, jb))
    got = tbn.plain_channel_dot_sums(ta, tb)
    af = np.asarray(ja.astype(jnp.float32), np.float64).reshape(-1, 64)
    bf = np.asarray(jb.astype(jnp.float32), np.float64).reshape(-1, 64)
    for g, r, exact in zip(got, ref, (af.sum(0), (af * bf).sum(0))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **PALLAS_TOL)
        np.testing.assert_allclose(g.numpy(), exact, **PALLAS_TOL)


@pytest.mark.parametrize("mode", ["1", "bwd"], indirect=True)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_train_forward_matches_fused_bn_train(mode, dtype):
    """(y, mean, var) of `bn_train` on the CPU (the twins) against
    `fused_bn_train` with the Pallas kernel in interpret mode. Tolerances of
    test_batch_norm_kernel.py:60-67: 1e-5 in fp32; in bf16 an output may
    round to the neighbouring value."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from imagenet_models_tpu.ops import batch_norm as jbn

    x = jnp.asarray(_x((4, 8, 8, 64)), dtype)
    scale, bias = _affine(64)
    with pltpu.force_tpu_interpret_mode():
        ref = jbn.fused_bn_train(x, jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tbn.bn_train(tx, torch.from_numpy(scale), torch.from_numpy(bias), 1e-5)
    assert got[0].dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 2e-2
    for g, r, t in zip(got, ref, (dict(rtol=tol, atol=5 * tol), dict(rtol=1e-5, atol=1e-5),
                                   dict(rtol=1e-5, atol=1e-5))):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r.astype(jnp.float32)), **t)


def _cotangents(shape):
    c = shape[-1]
    return _x(shape, 5), _x((c,), 6), _x((c,), 7)


@pytest.mark.parametrize("mode", ["1", "bwd"], indirect=True)
def test_bn_train_backward_matches_jax_grad(mode):
    """The explicit backward against `jax.grad` through `fused_bn_train`'s
    custom VJP (`_fused_bwd` on the Pallas dot sums in interpret mode), with
    non-zero cotangents on y and on the returned mean and var, as
    test_batch_norm_kernel.py:70-90. Both compute the same fp32 formula;
    1e-5 of the largest |gradient| leaves room for the summation order."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from imagenet_models_tpu.ops import batch_norm as jbn

    shape = (2, 8, 8, 64)
    x = _x(shape)
    scale, bias = _affine(64)
    wy, wm, wv = _cotangents(shape)

    def loss(x, s, b):
        y, mean, var = jbn.fused_bn_train(x, s, b, 1e-5)
        return jnp.sum(y * wy) + jnp.sum(mean * wm) + jnp.sum(var * wv)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, scale, bias)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    y, mean, var = tbn.bn_train(*leaves, 1e-5)
    ((y * torch.from_numpy(wy)).sum() + (mean * torch.from_numpy(wm)).sum()
     + (var * torch.from_numpy(wv)).sum()).backward()
    for t, r in zip(leaves, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-5, atol=1e-5 * np.abs(r).max())


def test_plain_bn_train_autograd_matches_jax_grad():
    """Mode "0": autograd through `plain_bn_train` against `jax.grad` through
    JAX's `plain_bn_train`, the same cotangents."""
    import jax
    import jax.numpy as jnp

    from imagenet_models_tpu.ops import batch_norm as jbn

    shape = (2, 8, 8, 64)
    x = _x(shape)
    scale, bias = _affine(64)
    wy, wm, wv = _cotangents(shape)

    def loss(x, s, b):
        y, mean, var = jbn.plain_bn_train(x, s, b, 1e-5)
        return jnp.sum(y * wy) + jnp.sum(mean * wm) + jnp.sum(var * wv)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, scale, bias)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    y, mean, var = tbn.plain_bn_train(*leaves, 1e-5)
    ((y * torch.from_numpy(wy)).sum() + (mean * torch.from_numpy(wm)).sum()
     + (var * torch.from_numpy(wv)).sum()).backward()
    for t, r in zip(leaves, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-5, atol=1e-5 * np.abs(r).max())


# ---------------------------------------------------------------- the module and the gate

@pytest.mark.parametrize("mode", ["0", "1", "full", "bwd"], indirect=True)
def test_batch_norm_module_matches_jax(mode):
    """The port's BatchNorm against JAX's in training (output and the running
    statistics after the update) and at eval, on a map big enough for the
    gate; each package's switch set to the same mode."""
    import jax.numpy as jnp

    from imagenet_models_tpu.nn import layers as jl
    from imagenet_models_tpu.ops import batch_norm as jbn
    from torch_parity import init_shapes, load_port, random_variables

    x = _x((8, 32, 32, 64))
    assert tbn.use_fused_bn(torch.from_numpy(x)) == (mode != "0") == jbn.use_fused_bn(x)
    jm = jl.BatchNorm()
    variables = random_variables(init_shapes(jm, jnp.asarray(x)), seed=1)
    ref, mut = jm.apply(variables, jnp.asarray(x), use_running_average=False,
                        mutable=["batch_stats"])
    ref_eval = jm.apply(variables, jnp.asarray(x), use_running_average=True)
    tm = load_port(tl.BatchNorm(64), variables, prefix="m")
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), np.asarray(ref_eval),
                               rtol=1e-5, atol=1e-5)
    got = tm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)


def test_mode_off_keeps_the_plain_code(monkeypatch):
    """With the switch at "0" a training BatchNorm computes exactly what it
    computed before the switch existed: fp32 mean and E[x^2], the clamp, one
    cast; bit for bit, gradients included."""
    monkeypatch.setattr(tbn, "_PALLAS_BN_MODE", "0")
    x = torch.from_numpy(_x((8, 32, 32, 64))).bfloat16().requires_grad_()
    m = tl.BatchNorm(64).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(_affine(64)[0]))
        m.bias.copy_(torch.from_numpy(_affine(64)[1]))
    y = m(x)
    g = torch.from_numpy(_x((8, 32, 32, 64), 9)).bfloat16()
    (dx,) = torch.autograd.grad(y, x, g)
    x2 = x.detach().clone().requires_grad_()
    xf = x2.float()
    mean = xf.mean(dim=(0, 1, 2))
    var = torch.clamp(xf.square().mean(dim=(0, 1, 2)) - mean.square(), min=0.0)
    ref = ((xf - mean) * (torch.rsqrt(var + 1e-5) * m.weight.float()) + m.bias.float()).to(x.dtype)
    (ref_dx,) = torch.autograd.grad(ref, x2, g)
    assert torch.equal(y, ref) and torch.equal(dx, ref_dx)
    n, k = 8 * 32 * 32, m.momentum
    assert torch.equal(m.running_var, k * torch.ones(64) + (1 - k) * (var * (n / (n - 1))))


def test_use_fused_bn_gate_matches_jax(monkeypatch):
    """The cases of test_batch_norm_kernel.py:125-131, on both gates, and an
    unknown mode."""
    import jax.numpy as jnp

    from imagenet_models_tpu.ops import batch_norm as jbn

    cases = [(_x((8, 32, 32, 64)), "0"), (_x((4, 64)), "1"), (_x((2, 4, 4, 8)), "1"),
             (_x((8, 32, 32, 64)), "1"), (np.zeros((8, 32, 32, 64), np.int32), "1"),
             (_x((8, 32, 32, 64)), "bwd"), (_x((8, 32, 32, 64)), "full"),
             (_x((4, 16, 16, 256)), "1"), (_x((4, 16, 16, 255)), "1")]
    for x, mode in cases:
        monkeypatch.setattr(jbn, "_PALLAS_BN_MODE", mode)
        monkeypatch.setattr(tbn, "_PALLAS_BN_MODE", mode)
        assert tbn.use_fused_bn(torch.from_numpy(x)) == jbn.use_fused_bn(jnp.asarray(x)), \
            (x.shape, x.dtype, mode)
    assert tbn.use_fused_bn(torch.zeros(8, 32, 32, 64, dtype=torch.bfloat16))
    assert not tbn.use_fused_bn(torch.zeros(8, 32, 32, 64, dtype=torch.float16))
    for module in (tbn, jbn):
        monkeypatch.setattr(module, "_PALLAS_BN_MODE", "on")
    with pytest.raises(ValueError, match="IMTPU_PALLAS_BN"):
        tbn.use_fused_bn(torch.zeros(8, 32, 32, 64))
    with pytest.raises(ValueError, match="IMTPU_PALLAS_BN"):
        jbn.use_fused_bn(jnp.zeros((8, 32, 32, 64)))


def test_cpu_dispatch_runs_the_twins_and_wrappers_refuse_cpu(monkeypatch):
    monkeypatch.setattr(tbn, "_PALLAS_BN_MODE", "full")
    x, g = torch.from_numpy(_x((2, 4, 4, 40))), torch.from_numpy(_x((2, 4, 4, 40), 1))
    before = (tbn.fused_channel_moments.launches, tbn.fused_channel_dot_sums.launches)
    for got, ref in ((tbn.channel_moments(x), tbn.plain_channel_moments(x)),
                     (tbn.channel_dot_sums(g, x), tbn.plain_channel_dot_sums(g, x))):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert (tbn.fused_channel_moments.launches, tbn.fused_channel_dot_sums.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tbn.channel_moments(x, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tbn.fused_channel_dot_sums(g, x)
    with pytest.raises(ValueError, match="CUDA"):
        tbn.bn_train(x, torch.ones(40), torch.zeros(40), 1e-5, use_kernel=True)


def test_row_view_reads_rows_in_place():
    """Contiguous maps and channel slices of wider ones are read in place;
    transposed, broadcast or overlapping layouts are copied first."""
    t = torch.zeros(2, 4, 6, 96)
    assert tbn._row_stride(t) == 96 and tbn.row_view(t) is t
    s = t[..., 32:64]
    assert tbn._row_stride(s) == 96 and tbn.row_view(s) is s
    for bad in (t.transpose(1, 2), torch.zeros(1, 1, 1, 32).expand(2, 4, 6, 32),
                torch.zeros(96)[None].expand(48, 96)):
        assert tbn._row_stride(bad) is None and tbn.row_view(bad).is_contiguous()
    assert tbn._row_stride(torch.zeros(1, 1, 1, 32)) == 32


# ---------------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _exact(*ts):
    return [t.double() for t in ts]


def _assert_sums_close(got, twin, ref):
    """Against the fp32 twin and float64 sums: 1e-5 of the largest |sum| of
    the same kind (fp32 sums of up to 1.6M terms in other orders)."""
    for g, t, r in zip(got, twin, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape
        scale = r.abs().max().item() + 1e-30
        assert (g.double() - r).abs().max().item() <= 1e-5 * scale
        assert (g - t).abs().max().item() <= 1e-5 * scale


# (n, C): the smallest and the widest BN shapes of map_resnet50's train step
# at B=8, odd row counts, C not a multiple of 8, a single row
CUDA_SHAPES = [(8 * 112 * 112, 64), (8 * 7 * 7, 1024), (8 * 14 * 14, 384), (12345, 40),
               (777, 96), (1, 64), (3001, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [("bfloat16", "bfloat16"), ("float32", "float32"),
                                    ("bfloat16", "float32"), ("float32", "bfloat16")])
@pytest.mark.parametrize("n,c", CUDA_SHAPES)
def test_kernels_match_twins_on_cuda(n, c, dtypes):
    gen = _cuda()
    a, b = (torch.randn(n, c, generator=gen, device="cuda").mul_(2).add_(0.5)
            .to(getattr(torch, d)) for d in dtypes)
    got = tbn.fused_channel_moments(a)
    af = a.double()
    _assert_sums_close(got, tbn.plain_channel_moments(a), (af.sum(0), (af * af).sum(0)))
    got = tbn.fused_channel_dot_sums(a, b)
    _assert_sums_close(got, tbn.plain_channel_dot_sums(a, b),
                       (af.sum(0), (af * b.double()).sum(0)))
    again = tbn.fused_channel_dot_sums(a, b)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.cuda
def test_kernels_read_channel_slices_and_4d_maps_on_cuda():
    gen = _cuda()
    wide = torch.randn(4, 14, 14, 3 * 96, generator=gen, device="cuda").bfloat16()
    for t in (wide[..., 96:192], wide[..., 1:97], wide):
        ref = tbn.plain_channel_moments(t)
        got = tbn.fused_channel_moments(t)
        _assert_sums_close(got, ref, _exact(*ref))


@pytest.mark.cuda
def test_dot_sums_read_channel_slices_on_cuda():
    """Kernel 8 on operands whose rows are 3C apart (channel slices of a
    wider map), one of them off a 16-byte boundary."""
    gen = _cuda()
    wide = torch.randn(4, 14, 14, 3 * 96, generator=gen, device="cuda").bfloat16()
    for a, b in ((wide[..., 96:192], wide[..., :96]), (wide[..., 1:97], wide[..., 192:])):
        ref = tbn.plain_channel_dot_sums(a, b)
        got = tbn.fused_channel_dot_sums(a, b)
        ad, bd = a.double().reshape(-1, 96), b.double().reshape(-1, 96)
        _assert_sums_close(got, ref, (ad.sum(0), (ad * bd).sum(0)))


@pytest.mark.cuda
def test_dot_sums_tickets_across_shapes_on_cuda():
    """The last-block tickets are left at zero by every call: calls on
    shapes of other plans in turn (one row, odd rows, one and many slice
    groups, a channel slice) give each shape the bits of its first call."""
    gen = _cuda()
    wide = torch.randn(6, 7, 7, 3 * 64, generator=gen, device="cuda").bfloat16()
    cases = [torch.randn(1, 64, generator=gen, device="cuda"),
             torch.randn(777, 96, generator=gen, device="cuda").bfloat16(),
             torch.randn(8 * 7 * 7, 1024, generator=gen, device="cuda").bfloat16(),
             torch.randn(8 * 112 * 112, 64, generator=gen, device="cuda").bfloat16(),
             wide[..., 64:128]]
    first = [[t.clone() for t in tbn.fused_channel_dot_sums(x, x)] for x in cases]
    for _ in range(2):
        for x, ref in zip(cases, first):
            got = tbn.fused_channel_dot_sums(x, x)
            assert all(torch.equal(g, r) for g, r in zip(got, ref))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_dot_sums_on_two_streams_on_cuda():
    """Calls in flight on two streams at once: each stream has its own
    tickets, and both give the bits of a call on the default stream."""
    gen = _cuda()
    x = torch.randn(8 * 14 * 14, 1024, generator=gen, device="cuda").bfloat16()
    ref = [t.clone() for t in tbn.fused_channel_dot_sums(x, x)]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    outs = []
    for _ in range(4):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(tbn.fused_channel_dot_sums(x, x))
    torch.cuda.synchronize()
    assert all(torch.equal(g, r) for out in outs for g, r in zip(out, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "bwd"])
def test_bn_train_on_cuda_runs_the_kernels(mode, monkeypatch):
    monkeypatch.setattr(tbn, "_PALLAS_BN_MODE", mode)
    gen = _cuda()
    x = torch.randn(8, 28, 28, 128, generator=gen, device="cuda").bfloat16()
    scale = 1 + 0.1 * torch.randn(128, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(128, generator=gen, device="cuda")
    g = torch.randn(8, 28, 28, 128, generator=gen, device="cuda").bfloat16()
    outs = {}
    for use_kernel in (True, False):
        leaves = [t.detach().clone().requires_grad_() for t in (x, scale, bias)]
        before = (tbn.fused_channel_moments.launches, tbn.fused_channel_dot_sums.launches)
        y, mean, var = tbn.bn_train(*leaves, 1e-5, use_kernel=use_kernel)
        y.backward(g)
        launched = (tbn.fused_channel_moments.launches - before[0],
                    tbn.fused_channel_dot_sums.launches - before[1])
        assert launched == (((mode == "full"), 1) if use_kernel else (0, 0))
        outs[use_kernel] = [y, mean, var] + [t.grad for t in leaves]
    for got, ref in zip(outs[True], outs[False]):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 1e-2 * ref.float().abs().max().item(), err


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_cannot_take_on_cuda():
    _cuda()
    x = torch.zeros(4, 8, 8, 64, device="cuda")
    with pytest.raises(TypeError, match="bf16 or fp32"):
        tbn.fused_channel_moments(x.half())
    with pytest.raises(ValueError, match="evenly spaced"):
        tbn.fused_channel_moments(x.transpose(1, 2))
    with pytest.raises(ValueError, match="differ"):
        tbn.fused_channel_dot_sums(x, x[:2])
    with pytest.raises(ValueError, match="CUDA"):
        tbn.fused_channel_dot_sums(x, x.cpu())

"""The port's depthwise 7x7 conv with its weight-gradient kernel
(imagenet_models_tpu_torch/ops/dw_conv.py) against the JAX package.

`plain_dw7_wgrad`, the twin of CUDA kernel 9, is held to the Pallas kernel
`dw7_wgrad` in interpret mode, as tests/test_dw_conv.py runs it (:39), at
that file's shapes, in fp32 and in bf16. `DwConv7Function`'s dx, dw and db
are held to `jax.vjp` of `dw_conv7_opt` (interpret mode) and of the plain
`dw_conv7`. The tap order and the (7, 7, 1, C) <-> (C, 1, 7, 7) layout are
checked on single taps; the switch IMTPU_DW_WGRAD at "0" must leave the
ConvNeXt block exactly as it was. The CUDA kernel is held to its twin and to
float64 sums on a GPU (the `cuda`-marked tests, and chip_smoke.py).

Tolerances: fp32 sums of the same products in other orders, so 1e-5 of the
tap's sum of |terms| (an fp32 sum of some 400 terms errs by a few 1e-7 of
it); the gradients of the conv against XLA at highest precision 1e-5
relative, 2e-4 as tests/test_dw_conv.py:44 where the Pallas kernel is in the
chain.

This file imports jax only inside the tests that need it, so the GPU cases
can be collected on a machine without jax.
"""

import numpy as np
import pytest
import torch

from imagenet_models_tpu_torch.ops import convnext_block as tcb
from imagenet_models_tpu_torch.ops import dw_conv as tdc

SHAPES = [(2, 14, 14, 96), (3, 8, 10, 128)]  # tests/test_dw_conv.py:33
SUM_RTOL = 1e-5


def _case(b, h, w, c, seed=0):
    """numpy x, kernel (7, 7, 1, C), bias and cotangent: tests/test_dw_conv.py:24-30."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    dw_w = (rng.standard_normal((7, 7, 1, c)) * 0.1).astype(np.float32)
    dw_b = (rng.standard_normal(c) * 0.01).astype(np.float32)
    g = rng.standard_normal((b, h, w, c)).astype(np.float32)
    return x, dw_w, dw_b, g


def _to_torch_kernel(k):
    """JAX's (7, 7, 1, C) HWIO depthwise kernel in the torch layout (C, 1, 7, 7)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))


def _abs_sums(x, g):
    """The per-tap sum of |terms|, (C, 1, 7, 7) float64: the scale of the
    fp32 rounding of any order of summation."""
    xp = np.pad(np.abs(x.astype(np.float64)), ((0, 0), (3, 3), (3, 3), (0, 0)))
    b, h, w, c = x.shape
    ga = np.abs(g.astype(np.float64))
    out = np.stack([(xp[:, ky:ky + h, kx:kx + w] * ga).sum((0, 1, 2))
                    for ky in range(7) for kx in range(7)], axis=1)
    return out.reshape(c, 1, 7, 7)


def _bf16(a):
    """a rounded to bf16, as float32 numpy (so both packages see the same values)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


# ---------------------------------------------------------------- the twin

def _rounded_sums(x, g):
    """float64 sums of the products of x and g each rounded to bf16, (C, 1, 7, 7)."""
    xp = np.pad(x.astype(np.float64), ((0, 0), (3, 3), (3, 3), (0, 0)))
    b, h, w, c = x.shape
    out = [torch.from_numpy(xp[:, ky:ky + h, kx:kx + w] * g).float().bfloat16().double()
           .sum((0, 1, 2)).numpy() for ky in range(7) for kx in range(7)]
    return np.stack(out, axis=1).reshape(c, 1, 7, 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,c", SHAPES)
def test_twin_matches_pallas_wgrad(b, h, w, c, dtype):
    """The twin against the TPU kernel in interpret mode, both on the same
    values. In bf16 the TPU kernel's products are bf16 (`win * dy` of bf16
    blocks), and the twin rounds each one to bf16 before the fp32 sum; the
    interpret mode on the CPU keeps them exact in fp32 (XLA's CPU fusion
    drops the rounding of the product inside the kernel body), so there the
    twin is held to it through its exact-product form (the same values in
    fp32, within 1e-5 of the sum of |terms|), and its bf16 form to float64
    sums of the rounded products (1e-5) and to the interpret mode within the
    rounding's own bound, 2^-9 of the sum of |terms| (one round to nearest
    per product)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from imagenet_models_tpu.ops import dw_conv as jdc

    x, _, _, g = _case(b, h, w, c)
    if dtype == "bfloat16":
        x, g = _bf16(x), _bf16(g)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jdc.dw7_wgrad(jnp.asarray(x, dtype), jnp.asarray(g, dtype)))
    ref = np.transpose(ref, (3, 2, 0, 1))
    size = _abs_sums(x, g)
    exact = tdc.plain_dw7_wgrad(torch.from_numpy(x), torch.from_numpy(g))
    assert (np.abs(exact.numpy() - ref) / size).max() <= SUM_RTOL
    if dtype == "bfloat16":
        got = tdc.plain_dw7_wgrad(torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16())
        assert got.dtype == torch.float32 and tuple(got.shape) == (c, 1, 7, 7)
        assert (np.abs(got.numpy() - _rounded_sums(x, g)) / size).max() <= SUM_RTOL
        assert (np.abs(got.numpy() - ref) / size).max() <= 2 ** -9 + SUM_RTOL
        assert not torch.equal(got, exact)


def test_twin_rounds_bf16_products():
    """With bf16 operands each product is rounded to bf16: the sum of one
    tap over products that round differs from the exact sum, and equals the
    float64 sum of the rounded products."""
    x = torch.full((1, 1, 2, 8), 1.0 + 2 ** -7).bfloat16()   # 1 + ulp
    g = torch.full((1, 1, 2, 8), 1.0 + 2 ** -7).bfloat16()
    got = tdc.plain_dw7_wgrad(x, g)[:, 0, 3, 3]               # the centre tap: x * g
    exact = 2 * (1.0 + 2 ** -7) ** 2                          # 2.0312805...
    rounded = 2 * float(torch.tensor((1.0 + 2 ** -7) ** 2).bfloat16())  # 2 * (1 + 2^-6)
    assert torch.all(got == rounded) and rounded != exact
    assert torch.all(tdc.plain_dw7_wgrad(x.float(), g.float())[:, 0, 3, 3] == exact)


def test_tap_order_and_layout():
    """Tap (ky, kx) of the torch (C, 1, 7, 7) weight pairs dy[h, w] with
    x[h + ky - 3, w + kx - 3], as JAX's (7, 7, 1, C) kernel's [ky, kx, 0, c]:
    a single x pixel and a single dy pixel light exactly one tap, and the
    forward with a single-tap kernel shifts the map the same way in both
    packages."""
    import jax.numpy as jnp

    from imagenet_models_tpu.ops.convnext_block import dw_conv7 as jax_dw_conv7

    x = torch.zeros(1, 9, 9, 8)
    g = torch.zeros(1, 9, 9, 8)
    x[0, 2, 6, 3] = 1.0
    g[0, 4, 5, 3] = 1.0
    dw = tdc.plain_dw7_wgrad(x, g)
    assert dw.sum() == 1.0 and dw[3, 0, 2 - 4 + 3, 6 - 5 + 3] == 1.0
    k = np.zeros((7, 7, 1, 8), np.float32)
    k[1, 5, 0, :] = 1.0
    xs = np.random.default_rng(3).standard_normal((1, 9, 9, 8)).astype(np.float32)
    ref = np.asarray(jax_dw_conv7(jnp.asarray(xs), jnp.asarray(k), jnp.zeros(8)))
    got = tdc.dw_conv7(torch.from_numpy(xs), _to_torch_kernel(k), torch.zeros(8))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert np.allclose(got.numpy()[0, 2, 2], xs[0, 0, 4])   # y[h, w] = x[h - 2, w + 2]


# ---------------------------------------------------------------- the autograd function

def _jax_grads(fn, x, dw_w, dw_b, g, interpret):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    with jax.default_matmul_precision("highest"):
        if interpret:
            with pltpu.force_tpu_interpret_mode():
                _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(dw_w), jnp.asarray(dw_b))
                return [np.asarray(t) for t in vjp(jnp.asarray(g))]
        _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(dw_w), jnp.asarray(dw_b))
        return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("reference", ["dw_conv7_opt", "dw_conv7"])
def test_function_matches_jax_vjp(reference):
    """dx, dw and db of `DwConv7Function` (the twin for dw, on the CPU)
    against jax.vjp of the custom VJP with the Pallas kernel in interpret
    mode (tol 2e-4, tests/test_dw_conv.py:44), and of the plain conv (tol
    1e-5 relative to each gradient's largest value)."""
    from imagenet_models_tpu.ops import convnext_block as jcb
    from imagenet_models_tpu.ops import dw_conv as jdc

    x, dw_w, dw_b, g = _case(2, 12, 12, 96, seed=3)   # tests/test_dw_conv.py:51
    fn = jdc.dw_conv7_opt if reference == "dw_conv7_opt" else jcb.dw_conv7
    rdx, rdw, rdb = _jax_grads(fn, x, dw_w, dw_b, g, interpret=reference == "dw_conv7_opt")
    xt = torch.from_numpy(x).requires_grad_()
    wt = _to_torch_kernel(dw_w).requires_grad_()
    bt = torch.from_numpy(dw_b).requires_grad_()
    y = tdc.DwConv7Function.apply(xt, wt, bt)
    y.backward(torch.from_numpy(g))
    refs = (rdx, np.transpose(rdw, (3, 2, 0, 1)), rdb)
    for name, got, ref in zip(("dx", "dw", "db"), (xt.grad, wt.grad, bt.grad), refs):
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape, name
        if reference == "dw_conv7_opt":
            np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4, err_msg=name)
        else:
            err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
            assert err <= 1e-5, (name, err)


def test_function_in_bf16_keeps_the_weight_dtypes():
    """bf16 activations, fp32 parameters (the models' policy): dx bf16, dw
    and db fp32; dw is the twin on the bf16 operands, db the fp32 sum of the
    bf16 cotangent; the forward is `dw_conv7`'s, bit for bit."""
    x, dw_w, dw_b, g = _case(2, 8, 8, 32, seed=4)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = _to_torch_kernel(dw_w).requires_grad_()
    bt = torch.from_numpy(dw_b).requires_grad_()
    gt = torch.from_numpy(g).bfloat16()
    y = tdc.DwConv7Function.apply(xt, wt, bt)
    assert torch.equal(y, tdc.dw_conv7(xt.detach(), wt.detach(), bt.detach()))
    y.backward(gt)
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == bt.grad.dtype == torch.float32
    ref_dx, = torch.autograd.grad(tdc.dw_conv7(xt, wt.detach(), bt.detach()), xt, gt)
    assert torch.equal(xt.grad, ref_dx)
    assert torch.equal(wt.grad, tdc.plain_dw7_wgrad(xt.detach(), gt))
    assert torch.allclose(bt.grad, gt.float().sum((0, 1, 2)), rtol=1e-6, atol=1e-5)


def _block_args(c, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32))

    x = t(2, 8, 8, c)
    params = [t(c, 1, 7, 7, scale=0.1), t(c, scale=0.01), t(c, scale=0.1, shift=1.0),
              t(c, scale=0.1), t(4 * c, c, scale=c ** -0.5), t(4 * c, scale=0.1),
              t(c, 4 * c, scale=(4 * c) ** -0.5), t(c, scale=0.1), t(c, scale=0.1, shift=1.0)]
    return x, params, t(2, 8, 8, c)


def _block_grads(x, params, g, **kw):
    x = x.clone().requires_grad_()
    ps = [p.clone().requires_grad_() for p in params]
    out = tcb.convnext_block_apply(x, *ps, **kw)
    out.backward(g)
    return out.detach(), [x.grad] + [p.grad for p in ps]


@pytest.mark.parametrize("training", [False, True])
def test_switch_off_is_the_old_block_bit_for_bit(training, monkeypatch):
    """IMTPU_DW_WGRAD at "0": the block's forward and every gradient are
    those of `F.conv2d` under autograd followed by `ln_mlp`, bit for bit;
    at "1" the forward, dx and every LN+MLP gradient are the same bits (dx is
    the same framework call), and the dw conv's weight and bias gradients
    (the twin, the fp32 sum) agree within fp32 rounding."""
    x, params, g = _block_args(32, seed=5)
    impl = tcb.resolve_gelu_impl(training)

    def old_block(x, dw_w, dw_b, ln_s, ln_b, w1, b1, w2, b2, gamma):
        h = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), dw_w, dw_b, padding=3,
                                       groups=x.shape[-1]).permute(0, 2, 3, 1)
        return tcb.ln_mlp(h, ln_s, ln_b, w1, b1, w2, b2, gamma, gelu_impl=impl)

    xr = x.clone().requires_grad_()
    ps = [p.clone().requires_grad_() for p in params]
    ref = old_block(xr, *ps)
    ref.backward(g)
    ref_grads = [xr.grad] + [p.grad for p in ps]
    monkeypatch.setattr(tdc, "_DW_WGRAD", "0")
    out, grads = _block_grads(x, params, g, training=training)
    assert torch.equal(out, ref.detach())
    assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
    monkeypatch.setattr(tdc, "_DW_WGRAD", "1")
    out1, grads1 = _block_grads(x, params, g, training=training)
    assert torch.equal(out1, ref.detach())
    assert all(torch.equal(a, b) for a, b in zip(grads1[:1] + grads1[3:],
                                                  ref_grads[:1] + ref_grads[3:]))
    for a, b in zip(grads1[1:3], ref_grads[1:3]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), (a - b).abs().max()


def test_switch_routes_the_block(monkeypatch):
    """At "1" the block's dw weight gradient goes through `dw7_wgrad` (the
    twin on the CPU), once per backward; at "0", and on the plain path
    (use_kernel=False) at "1", it does not."""
    x, params, g = _block_args(16, seed=6)
    calls = []
    real = tdc.dw7_wgrad
    monkeypatch.setattr(tdc, "dw7_wgrad", lambda a, b: calls.append(a.shape) or real(a, b))
    for mode, use_kernel, expected in (("1", None, 1), ("0", None, 0), ("1", False, 0)):
        monkeypatch.setattr(tdc, "_DW_WGRAD", mode)
        calls.clear()
        _block_grads(x, params, g, use_kernel=use_kernel, training=True)
        assert len(calls) == expected, (mode, use_kernel, calls)
    assert tdc.fused_dw7_wgrad.launches == 0


def test_wrapper_refuses_cpu_tensors_and_the_switch_defaults_off():
    x = torch.zeros(1, 7, 7, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tdc.fused_dw7_wgrad(x, x)
    assert torch.equal(tdc.dw7_wgrad(x, x), torch.zeros(8, 1, 7, 7))  # CPU: the twin
    import os
    assert tdc._DW_WGRAD == os.environ.get("IMTPU_DW_WGRAD", "0")


# ---------------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _fp64_check(x, g, got):
    """|kernel - float64 sum of the (rounded) products| per tap, over the
    tap's sum of |terms|."""
    xd, gd = x.double(), g.double()
    b, h, w, c = x.shape
    xp = torch.nn.functional.pad(xd, (0, 0, 3, 3, 3, 3))
    exact, size = [], []
    for ky in range(7):
        for kx in range(7):
            prod = xp[:, ky:ky + h, kx:kx + w] * gd
            if x.dtype == torch.bfloat16:
                prod = prod.float().bfloat16().double()
            exact.append(prod.sum((0, 1, 2)))
            size.append(prod.abs().sum((0, 1, 2)))
    exact = torch.stack(exact, 1).reshape(c, 1, 7, 7)
    size = torch.stack(size, 1).reshape(c, 1, 7, 7)
    return ((got.double() - exact).abs() / size.clamp_min(1e-30)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4, 56, 56, 96), (8, 14, 14, 384), (3, 7, 7, 768),
                                   (5, 13, 19, 688), (1, 40, 9, 40), (6, 20, 36, 128),
                                   (2, 28, 28, 192), (3, 5, 3, 16)])
def test_kernel_matches_twin_and_fp64_on_cuda(shape, dtype):
    gen = _cuda()
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    before = tdc.fused_dw7_wgrad.launches
    got = tdc.fused_dw7_wgrad(x, g)
    again = tdc.fused_dw7_wgrad(x, g)
    torch.cuda.synchronize()
    assert tdc.fused_dw7_wgrad.launches == before + 2
    assert got.dtype == torch.float32 and tuple(got.shape) == (shape[-1], 1, 7, 7)
    assert torch.equal(got, again)   # a fixed order of summation
    assert _fp64_check(x, g, got) <= SUM_RTOL
    twin = tdc.plain_dw7_wgrad(x, g)
    assert (got - twin).abs().max() <= 1e-4 * twin.abs().max()


@pytest.mark.cuda
def test_function_on_cuda_runs_the_kernel():
    """DwConv7Function on CUDA: dw from kernel 9, within the fp32 rounding of
    the twin; dx and db as autograd's conv gives them."""
    gen = _cuda()
    x = torch.randn(2, 14, 14, 64, generator=gen, device="cuda").requires_grad_()
    w = (0.1 * torch.randn(64, 1, 7, 7, generator=gen, device="cuda")).requires_grad_()
    b = (0.01 * torch.randn(64, generator=gen, device="cuda")).requires_grad_()
    g = torch.randn(2, 14, 14, 64, generator=gen, device="cuda")
    torch.backends.cudnn.allow_tf32 = False
    before = tdc.fused_dw7_wgrad.launches
    tdc.DwConv7Function.apply(x, w, b).backward(g)
    assert tdc.fused_dw7_wgrad.launches == before + 1
    refs = torch.autograd.grad(tdc.dw_conv7(x, w, b), (x, w, b), g)
    for got, ref in zip((x.grad, w.grad, b.grad), refs):
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_cannot_take_on_cuda():
    _cuda()
    x = torch.zeros(2, 8, 8, 64, device="cuda")
    odd = torch.zeros(2, 8, 8, 60, device="cuda")
    for a, b in ((odd, odd),                                     # C % 8 != 0
                 (x, x.bfloat16()),                              # mixed types
                 (x.transpose(1, 2), x),                         # not contiguous
                 (x.half(), x.half()),                           # fp16
                 (x, torch.zeros(2, 8, 9, 64, device="cuda"))):  # shapes differ
        with pytest.raises(ValueError):
            tdc.fused_dw7_wgrad(a, b)

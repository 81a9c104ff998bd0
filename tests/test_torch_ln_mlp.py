"""The port's LN+MLP twin against the JAX package, and the dispatch rule.

`plain_ln_mlp` (imagenet_models_tpu_torch/ops/convnext_block.py) is held to
JAX's `plain_ln_mlp` and to the Pallas kernel `_fused_ln_mlp_pallas` run in
TPU-interpret mode, on the same numpy inputs. The CUDA kernel itself is held
to the twin on a GPU (`test_kernel_matches_twin_on_cuda`, and chip_smoke.py).

This file imports jax only inside the tests that need it, so the GPU case can
be collected on a machine without jax.
"""

import numpy as np
import pytest
import torch

from imagenet_models_tpu_torch.ops import convnext_block as tcb


def _args(c: int, n: int, seed: int = 0, hidden: int = 0):
    """numpy inputs: h (n, c), then ln_s, ln_b, w1 (c, hidden) in JAX layout,
    b1, w2 (hidden, c), b2, gamma; hidden 4c unless given."""
    rng = np.random.default_rng(seed)
    hid = hidden or 4 * c
    f = lambda *s, scale=1.0, shift=0.0: (rng.standard_normal(s) * scale + shift).astype(np.float32)
    return (f(n, c), f(c, scale=0.1, shift=1.0), f(c, scale=0.1),
            f(c, hid, scale=c ** -0.5), f(hid, scale=0.1),
            f(hid, c, scale=hid ** -0.5), f(c, scale=0.1), f(c))


def _torch_args(args, dtype=torch.float32):
    """JAX-layout numpy args -> port args: weights transposed to the torch
    Linear layout, tokens in `dtype`, everything else fp32."""
    h, s, b, w1, b1, w2, b2, g = (torch.from_numpy(a) for a in args)
    return (h.to(dtype), s, b, w1.t().contiguous(), b1, w2.t().contiguous(), b2, g)


# n = 77 is not a multiple of any tile either implementation might use; the
# CUDA kernel's edges: C = 64 (one padded k-block) with hidden 256, C = 688
# (43 x 16, a ragged channel tile) at a ragged N, and a hidden width other
# than 4C (hidden tiles of 64)
@pytest.mark.parametrize("c,n,hidden", [(96, 128, 0), (96, 77, 0), (128, 128, 0), (128, 77, 0),
                                        (64, 77, 256), (688, 19, 0), (96, 77, 256)])
def test_twin_matches_jax_plain(c, n, hidden):
    import jax
    import jax.numpy as jnp

    from imagenet_models_tpu.ops import convnext_block as jcb

    args = _args(c, n, hidden=hidden)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jcb.plain_ln_mlp(*map(jnp.asarray, args)))
    got = tcb.plain_ln_mlp(*_torch_args(args)).numpy()
    # fp32 on both sides; only the summation order differs (~1e-6 relative)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("c", [96, 128])
def test_twin_matches_pallas_kernel_interpret(c):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from imagenet_models_tpu.ops import convnext_block as jcb

    args = _args(c, 128, seed=1)
    jargs = [jnp.asarray(a) for a in args]
    jargs[0] = jargs[0].reshape(2, 8, 8, c)  # the Pallas entry takes NHWC
    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jcb._fused_ln_mlp_pallas(*jargs)).reshape(128, c)
    got = tcb.plain_ln_mlp(*_torch_args(args)).numpy()
    # the kernel's A&S erf (|err| < 1.5e-7) against exact erf, plus summation order
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_bf16_twin_matches_pallas_kernel_numerics():
    """In bf16 the twin rounds where the Pallas kernel rounds: LN'd tokens,
    GELU output and the final result, with fp32 accumulation in between."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from imagenet_models_tpu.ops import convnext_block as jcb

    c = 96
    args = _args(c, 128, seed=2)
    jargs = [jnp.asarray(a) for a in args]
    jargs[0] = jargs[0].astype(jnp.bfloat16).reshape(2, 8, 8, c)
    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jcb._fused_ln_mlp_pallas(*jargs).astype(jnp.float32)).reshape(128, c)
    got = tcb.plain_ln_mlp(*_torch_args(args, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # a different summation order can round an output to the neighbouring
    # bf16 value: one ulp is 2^-8 relative, so 1e-2 of the largest |output|
    err = np.abs(got - ref).max()
    assert err <= 1e-2 * np.abs(ref).max(), err
    # and most outputs round identically
    assert np.mean(got == ref) > 0.9


def test_cpu_dispatch_runs_the_twin():
    args = _torch_args(_args(96, 50, seed=3))
    before = tcb.fused_ln_mlp.launches
    got = tcb.ln_mlp(*args)
    torch.testing.assert_close(got, tcb.plain_ln_mlp(*args), rtol=0, atol=0)
    assert tcb.fused_ln_mlp.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    args = _torch_args(_args(96, 50, seed=4))
    with pytest.raises(ValueError, match="CUDA"):
        tcb.ln_mlp(*args, use_kernel=True)


@pytest.mark.cuda
@pytest.mark.parametrize("c,n", [(96, 64 * 56 * 7), (192, 64 * 28 * 3), (384, 4 * 196 + 5),
                                 (768, 49 * 3 + 5),
                                 # the GA ConvNeXt widths outside ConvNeXt-T's
                                 (128, 1000), (256, 333), (512, 77), (688, 77), (976, 77),
                                 (1024, 77),
                                 # PiT's three stages (27x27, 14x14, 7x7 maps) at B=2
                                 (144, 2 * 729), (288, 2 * 196), (576, 2 * 49)])
def test_kernel_matches_twin_on_cuda(c, n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [t.cuda() for t in _torch_args(_args(c, n, seed=5), torch.bfloat16)]
    with torch.no_grad():
        got = tcb.fused_ln_mlp(*args).float()
        ref = tcb.plain_ln_mlp(*args).float()
    # both sum in fp32 in different orders; 1e-2 of the largest |output| is
    # 2.5 bf16 ulps at the top of the range
    assert (got - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_it_cannot_take_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    args = [t.cuda() for t in _torch_args(_args(96, 50, seed=6), torch.bfloat16)]
    # the kernels take bf16 and fp32 tokens (each has an instance); fp16 is
    # refused, and on the card never falls back to the twin
    with pytest.raises(TypeError, match="bf16 or fp32"):
        tcb.ln_mlp(args[0].half(), *args[1:])
    # an input that needs a gradient goes through the autograd function of
    # the forward and backward kernels
    out = tcb.ln_mlp(*args[:3], args[3].requires_grad_(), *args[4:])
    assert out.grad_fn is not None
    wide = [t.cuda() for t in _torch_args(_args(1040, 8, seed=6), torch.bfloat16)]
    with torch.no_grad(), pytest.raises(ValueError, match="C=1040"):
        tcb.ln_mlp(*wide)


@pytest.mark.cuda
@pytest.mark.parametrize("gelu_impl", ["exact", "fast"])
@pytest.mark.parametrize("c,n,hidden", [(64, 1, 256), (64, 300, 256), (688, 257, 0), (688, 77, 0),
                                        (96, 643, 256), (1024, 129, 0), (768, 152, 0),
                                        # a B=256 eval forward's stage-0 and stage-3 tokens
                                        (96, 256 * 56 * 56, 0), (768, 256 * 7 * 7, 0)])
def test_kernel_edges_match_twin_on_cuda(c, n, hidden, gelu_impl):
    """The redesigned kernel's edges (padded k-blocks, ragged channel and
    token tiles, hidden tiles of 64) and the eval batch's sizes, with both
    GELUs: within 1e-2 of the twin's largest |output|, and the same bits on a
    second run (no sum is split across blocks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [t.cuda() for t in _torch_args(_args(c, n, seed=9, hidden=hidden), torch.bfloat16)]
    with torch.no_grad():
        got = tcb.fused_ln_mlp(*args, gelu_impl=gelu_impl)
        again = tcb.fused_ln_mlp(*args, gelu_impl=gelu_impl)
        ref = tcb.plain_ln_mlp(*args, gelu_impl=gelu_impl).float()
    assert torch.equal(got, again)
    assert (got.float() - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("gelu_impl", ["exact", "fast"])
@pytest.mark.parametrize("c,n,hidden", [(96, 2 * 56 * 56, 0), (768, 2 * 49, 0), (64, 77, 256),
                                        (688, 19, 0), (96, 1, 256)])
def test_fp32_instances_match_twins_on_cuda(c, n, hidden, gelu_impl):
    """Kernels 1 and 2 on fp32 tokens (an fp32 model) run their fp32
    instances: both sum fp32 products in other orders than the twins, so
    every output is within 1e-4 of the twin's largest |value|, and a second
    run gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [t.cuda() for t in _torch_args(_args(c, n, seed=10, hidden=hidden))]
    g = torch.from_numpy(np.random.default_rng(11).standard_normal((n, c)).astype(np.float32))
    g = g.cuda()
    with torch.no_grad():
        got = tcb.fused_ln_mlp(*args, gelu_impl=gelu_impl)
        assert torch.equal(got, tcb.fused_ln_mlp(*args, gelu_impl=gelu_impl))
        grads = tcb.fused_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl=gelu_impl)
        again = tcb.fused_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl=gelu_impl)
        refs = (tcb.plain_ln_mlp(*args, gelu_impl=gelu_impl),) + tcb.plain_ln_mlp_bwd(
            args[0], g, *args[1:], gelu_impl=gelu_impl)
    for name, o, r in zip(("out", "dx", "dln_s", "dln_b", "dw1", "db1", "dw2", "db2", "dgamma"),
                          (got,) + grads, refs):
        assert o.dtype == torch.float32 and o.shape == r.shape, name
        assert (o - r).abs().max().item() <= 1e-4 * r.abs().max().item(), name
    assert all(torch.equal(a, b) for a, b in zip(grads, again))

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


def _args(c: int, n: int, seed: int = 0):
    """numpy inputs: h (n, c), then ln_s, ln_b, w1 (c, 4c) in JAX layout, b1,
    w2 (4c, c), b2, gamma."""
    rng = np.random.default_rng(seed)
    hid = 4 * c
    f = lambda *s, scale=1.0, shift=0.0: (rng.standard_normal(s) * scale + shift).astype(np.float32)
    return (f(n, c), f(c, scale=0.1, shift=1.0), f(c, scale=0.1),
            f(c, hid, scale=c ** -0.5), f(hid, scale=0.1),
            f(hid, c, scale=hid ** -0.5), f(c, scale=0.1), f(c))


def _torch_args(args, dtype=torch.float32):
    """JAX-layout numpy args -> port args: weights transposed to the torch
    Linear layout, tokens in `dtype`, everything else fp32."""
    h, s, b, w1, b1, w2, b2, g = (torch.from_numpy(a) for a in args)
    return (h.to(dtype), s, b, w1.t().contiguous(), b1, w2.t().contiguous(), b2, g)


# n = 77 is not a multiple of any tile either implementation might use
@pytest.mark.parametrize("c,n", [(96, 128), (96, 77), (128, 128), (128, 77)])
def test_twin_matches_jax_plain(c, n):
    import jax
    import jax.numpy as jnp

    from imagenet_models_tpu.ops import convnext_block as jcb

    args = _args(c, n)
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
                                 (1024, 77)])
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
    with pytest.raises(TypeError, match="bf16"):
        tcb.ln_mlp(args[0].float(), *args[1:])
    with pytest.raises(NotImplementedError, match="backward"):
        tcb.ln_mlp(*args[:3], args[3].requires_grad_(), *args[4:])
    wide = [t.cuda() for t in _torch_args(_args(1040, 8, seed=6), torch.bfloat16)]
    with torch.no_grad(), pytest.raises(ValueError, match="C=1040"):
        tcb.ln_mlp(*wide)

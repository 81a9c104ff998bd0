"""The port's LN+MLP backward (kernel 2) against the JAX package.

`plain_ln_mlp_bwd` (imagenet_models_tpu_torch/ops/convnext_block.py), the
twin of the CUDA backward, is held to the Pallas backward
`_fused_ln_mlp_bwd_pallas` run in TPU-interpret mode, and autograd through
the port's CPU `ln_mlp` to `jax.vjp` of JAX's `plain_ln_mlp`, on the same
numpy inputs in fp32. The CUDA kernels are held to the twins on a GPU (the
`cuda`-marked tests, and chip_smoke.py).

This file imports jax only inside the tests that need it, so the GPU cases
can be collected on a machine without jax.
"""

import numpy as np
import pytest
import torch

from imagenet_models_tpu_torch.ops import convnext_block as tcb

NAMES = ("dx", "dln_s", "dln_b", "dw1", "db1", "dw2", "db2", "dgamma")


def _args(c: int, n: int, seed: int = 0, hidden: int = 0):
    """numpy inputs in JAX layout: h (n, c), ln_s, ln_b, w1 (c, hidden), b1,
    w2 (hidden, c), b2, gamma, and a cotangent g (n, c); hidden 4c unless
    given."""
    rng = np.random.default_rng(seed)
    hid = hidden or 4 * c
    f = lambda *s, scale=1.0, shift=0.0: (rng.standard_normal(s) * scale + shift).astype(np.float32)
    return (f(n, c), f(c, scale=0.1, shift=1.0), f(c, scale=0.1),
            f(c, hid, scale=c ** -0.5), f(hid, scale=0.1),
            f(hid, c, scale=hid ** -0.5), f(c, scale=0.1), f(c)), f(n, c)


def _torch_args(args, dtype=torch.float32):
    h, s, b, w1, b1, w2, b2, g = (torch.from_numpy(a) for a in args)
    return (h.to(dtype), s, b, w1.t().contiguous(), b1, w2.t().contiguous(), b2, g)


def _to_jax_layout(grads):
    """Port grads (torch Linear layout) -> numpy in JAX layout."""
    out = [t.detach().float().numpy() for t in grads]
    out[3], out[5] = out[3].T, out[5].T
    return out


def _assert_close(got, ref, rel):
    for name, o, r in zip(NAMES, got, ref):
        r = np.asarray(r, np.float32).reshape(o.shape)
        err = np.abs(o - r).max()
        assert err <= rel * np.abs(r).max(), (name, err, np.abs(r).max())


# N = 70 and 2 x 5 x 7 tokens: no tile of 8, 16 or 64 divides them; at
# N = 128 a 64-token Pallas tile makes the JAX side add two tiles' sums; the
# last case has a hidden width other than 4C (the kernel takes any multiple
# of 64 on the card; the twin is held to JAX here at a narrow one).
@pytest.mark.parametrize("gelu_impl", ["exact", "fast"])
@pytest.mark.parametrize("c,hw,tile,hidden", [(8, (5, 7), None, 0), (16, (5, 7), None, 0),
                                              (16, (8, 8), "64", 0), (16, (5, 7), None, 40)],
                         ids=["8-hw0-None", "16-hw1-None", "16-hw2-64", "16-hw1-None-hidden40"])
def test_twin_matches_pallas_backward_interpret(c, hw, tile, hidden, gelu_impl, monkeypatch):
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from imagenet_models_tpu.ops import convnext_block as jcb

    if tile:
        monkeypatch.setenv("IMTPU_LNMLP_BWD_TILE", tile)
    n = 2 * hw[0] * hw[1]
    args, g = _args(c, n, seed=c, hidden=hidden)
    jargs = [jnp.asarray(a) for a in args]
    jargs[0] = jargs[0].reshape(2, *hw, c)
    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        with pltpu.force_tpu_interpret_mode():
            ref = jcb._fused_ln_mlp_bwd_pallas(*jargs, jnp.asarray(g).reshape(2, *hw, c),
                                               eps=1e-6, gelu_impl=gelu_impl)
    ta = _torch_args(args)
    got = tcb.plain_ln_mlp_bwd(ta[0], torch.from_numpy(g), *ta[1:], gelu_impl=gelu_impl)
    # fp32 on both sides: A&S erf against erf (< 1.5e-7) and summation order
    _assert_close(_to_jax_layout(got), ref, 1e-4)


@pytest.mark.parametrize("gelu_impl", ["exact", "fast"])
def test_cpu_autograd_matches_jax_vjp(gelu_impl):
    import jax
    import jax.numpy as jnp

    from imagenet_models_tpu.ops import convnext_block as jcb

    c, n = 16, 70
    args, g = _args(c, n, seed=3)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda *a: jcb.plain_ln_mlp(*a, eps=1e-6, gelu_impl=gelu_impl),
                         *map(jnp.asarray, args))
        ref = vjp(jnp.asarray(g))
    targs = [t.requires_grad_() for t in _torch_args(args)]
    before = tcb.fused_ln_mlp_bwd.launches
    out = tcb.ln_mlp(*targs, gelu_impl=gelu_impl)
    out.backward(torch.from_numpy(g))
    assert tcb.fused_ln_mlp_bwd.launches == before  # CPU tensors never reach the kernel
    _assert_close(_to_jax_layout([t.grad for t in targs]), ref, 1e-4)


@pytest.mark.parametrize("gelu_impl", ["exact", "fast"])
def test_twin_backward_matches_autograd_of_twin_forward(gelu_impl):
    """In fp32 the backward twin is the gradient of the forward twin, up to the
    GELU derivative being the fit's (the fast fit's derivative differs by
    < 2e-4 from the derivative of the fast erf fit)."""
    args, g = _args(16, 50, seed=4)
    targs = [t.requires_grad_() for t in _torch_args(args)]
    tcb.plain_ln_mlp(*targs, gelu_impl=gelu_impl).backward(torch.from_numpy(g))
    ta = [t.detach() for t in targs]
    got = tcb.plain_ln_mlp_bwd(ta[0], torch.from_numpy(g), *ta[1:], gelu_impl=gelu_impl)
    ref = [t.grad for t in targs]
    _assert_close([t.numpy() for t in got], [t.numpy() for t in ref],
                  1e-4 if gelu_impl == "exact" else 2e-3)


def test_kernel_wrappers_refuse_cpu_tensors():
    args, g = _args(16, 20, seed=5)
    targs = _torch_args(args, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tcb.fused_ln_mlp_bwd(targs[0], torch.from_numpy(g).bfloat16(), *targs[1:])
    with pytest.raises(ValueError, match="CUDA"):
        tcb.ln_mlp(*targs, use_kernel=True, gelu_impl="fast")
    with pytest.raises(ValueError, match="gelu_impl"):
        tcb.plain_ln_mlp(*targs, gelu_impl="tanh")


def _cuda_args(c, n, seed, dtype=torch.bfloat16, hidden=0):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, g = _args(c, n, seed, hidden)
    return ([t.cuda() for t in _torch_args(args, dtype)],
            torch.from_numpy(g).to(dtype).cuda())


def _assert_kernel_close(got, ref):
    # both sum in fp32 in other orders, and a bf16 operand (hmid, dpre1) may
    # round to its neighbour: 1e-2 of the largest |output| is 2.5 bf16 ulps
    for name, o, r in zip(NAMES, got, ref):
        assert o.shape == r.shape and o.dtype == r.dtype, name
        err = (o.float() - r.float()).abs().max().item()
        assert err <= 1e-2 * r.float().abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("gelu_impl", ["exact", "fast"])
@pytest.mark.parametrize("c,n", [(96, 64 * 56 * 3 + 7), (192, 64 * 28 * 2 + 5), (384, 4 * 196 + 5),
                                 (768, 49 * 3 + 5), (128, 1000), (256, 333), (512, 77),
                                 (688, 77), (976, 77), (1024, 77)])
def test_backward_kernel_matches_twin_on_cuda(c, n, gelu_impl):
    args, g = _cuda_args(c, n, seed=6)
    got = tcb.fused_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl=gelu_impl)
    ref = tcb.plain_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl=gelu_impl)
    torch.cuda.synchronize()
    _assert_kernel_close(got, ref)


# the kernel's 128-token and 128-column tiles: one token, a few, one tile
# less or more than k tiles; C from 64 to 1024 with 688 = 43 x 16 (not a
# multiple of the 64-wide loads); a hidden width other than 4C
@pytest.mark.cuda
@pytest.mark.parametrize("gelu_impl", ["exact", "fast"])
@pytest.mark.parametrize("c,n,hidden", [(64, 1, 0), (96, 17, 0), (96, 128 * 3 - 1, 0),
                                        (96, 128 * 3 + 1, 0), (688, 128 * 2 + 1, 0),
                                        (768, 128 - 1, 0), (1024, 128 + 1, 0),
                                        (96, 128 * 5 + 3, 256)])
def test_backward_kernel_tiles_and_edges_on_cuda(c, n, hidden, gelu_impl):
    args, g = _cuda_args(c, n, seed=10, hidden=hidden)
    got = tcb.fused_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl=gelu_impl)
    again = tcb.fused_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl=gelu_impl)
    ref = tcb.plain_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl=gelu_impl)
    torch.cuda.synchronize()
    _assert_kernel_close(got, ref)
    # no float atomics: the same bits on every run
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_backward_pipeline_stages_rerun_on_cuda():
    """Each stage launched again alone reads what the earlier ones left and
    gives the same outputs."""
    args, g = _cuda_args(192, 700, seed=11)
    call = tcb.ln_mlp_bwd_pipeline(args[0], g, *args[1:], gelu_impl="fast")
    first = [t.clone() for t in (call.dx, call.dw1, call.dw2, call.vecs)]
    for k in range(len(tcb.BWD_STAGES)):
        call.run(k, k + 1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, (call.dx, call.dw1, call.dw2, call.vecs)))


@pytest.mark.cuda
@pytest.mark.parametrize("c,n", [(96, 3000), (768, 152)])
def test_fast_forward_kernel_matches_twin_on_cuda(c, n):
    args, _ = _cuda_args(c, n, seed=7)
    with torch.no_grad():
        got = tcb.fused_ln_mlp(*args, gelu_impl="fast").float()
        ref = tcb.plain_ln_mlp(*args, gelu_impl="fast").float()
    assert (got - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


@pytest.mark.cuda
def test_autograd_on_cuda_runs_both_kernels():
    args, g = _cuda_args(192, 500, seed=8)
    leaves = [args[0].clone().requires_grad_()] + [t.clone().requires_grad_() for t in args[1:]]
    fwd, bwd = tcb.fused_ln_mlp.launches, tcb.fused_ln_mlp_bwd.launches
    tcb.ln_mlp(*leaves, gelu_impl="fast").backward(g)
    assert (tcb.fused_ln_mlp.launches - fwd, tcb.fused_ln_mlp_bwd.launches - bwd) == (1, 1)
    ref = tcb.plain_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl="fast")
    _assert_kernel_close([t.grad for t in leaves], ref)


@pytest.mark.cuda
def test_backward_wrapper_refuses_what_it_cannot_take_on_cuda():
    args, g = _cuda_args(96, 50, seed=9)
    with pytest.raises(TypeError, match="bf16"):
        tcb.fused_ln_mlp_bwd(args[0].float(), g, *args[1:])
    with pytest.raises(TypeError, match="bf16"):
        tcb.fused_ln_mlp_bwd(args[0], g.float(), *args[1:])
    with pytest.raises(ValueError, match="CUDA"):
        tcb.fused_ln_mlp_bwd(args[0].cpu(), g.cpu(), *[t.cpu() for t in args[1:]])
    with pytest.raises(ValueError, match="does not match"):
        tcb.fused_ln_mlp_bwd(args[0], g[:10], *args[1:])
    wide, gw = _cuda_args(1040, 8, seed=9)
    with pytest.raises(ValueError, match="C=1040"):
        tcb.fused_ln_mlp_bwd(wide[0], gw, *wide[1:])

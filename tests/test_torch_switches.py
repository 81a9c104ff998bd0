"""The JAX switches that choose a model's kernel route, ported: each port
gate against the JAX gate over a grid of shapes and values, one
parametrised test per switch.

- IMTPU_PART_ATTN (`ops/window_attention._PART_ATTN`) and IMTPU_STRIPE_ATTN /
  IMTPU_STRIPE_MAXH (`ops/stripe_attention._STRIPE_ATTN`, `_STRIPE_MAXH`):
  the port's gate is JAX's minus its TPU tests (a 4 MB VMEM bound, and for
  the stripes the tile geometry), and for the stripes plus the CUDA
  kernels' own limits (MAX_TOKENS, HEAD_DIMS), which refuse what they
  cannot take to the composition. The grids' shapes pass JAX's VMEM test.
- IMTPU_FUSED_BWD, IMTPU_PALLAS_MIN_C, IMTPU_BLOCK_REMAT
  (`ops/convnext_block._FUSED_BWD`, `_PALLAS_MIN_C`, `_REMAT`): the route
  each side takes (kernel, plain, plain recomputed, or the device's: the
  kernel on the accelerator, the plain ops on the CPU), recorded by stubs
  of the route functions; where the route is plain ops on both sides, its
  gradients are held to JAX's in fp32 within 1e-4 of the largest |value|
  (tests/test_torch_ln_mlp_bwd.py's tolerance for the plain VJP).

JAX reads its switches from the environment when it traces; the port reads
them once at import into module attributes, which the tests set.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagenet_models_tpu.ops import convnext_block as jcb
from imagenet_models_tpu.ops import stripe_attention as jsa
from imagenet_models_tpu.ops import window_attention as jwa
from imagenet_models_tpu_torch.ops import convnext_block as tcb
from imagenet_models_tpu_torch.ops import stripe_attention as tsa
from imagenet_models_tpu_torch.ops import window_attention as twa

# (B, H, W, C) maps of MaxViT's partition attention at 224 and 384 px and
# ones the gate refuses: H or W not a multiple of the window, one window
PART_SHAPES = [(2, 56, 56, 64), (2, 28, 28, 128), (2, 14, 14, 256), (2, 7, 7, 512),
               (2, 96, 96, 64), (2, 24, 24, 256), (2, 12, 12, 512), (2, 30, 28, 64)]


@pytest.mark.parametrize("mode", ["fused", "xla", "block", "all", "other"])
def test_part_attn_switch_matches_jax(mode, monkeypatch):
    monkeypatch.setenv("IMTPU_PART_ATTN", mode)
    monkeypatch.setattr(twa, "_PART_ATTN", mode)
    seen = set()
    for shape, ps, part, drop, det in itertools.product(
            PART_SHAPES, [(7, 7), (12, 12)], ["block", "grid"], [0.0, 0.1], [False, True]):
        assert ps[0] * shape[2] * 3 * shape[3] * 2 <= 4 << 20  # JAX's VMEM test passes
        got = twa.use_fused_partition_attn(shape, ps, part, drop, det)
        assert got == jwa.use_fused_partition_attn(shape, ps, part, drop, det), \
            (mode, shape, ps, part, drop, det)
        seen.add(got)
    assert seen == ({False} if mode == "xla" else {False, True})


# (B, H, W, C) idx=0 half-maps of GA-CSWin, stripe width, head width: stages
# 1-3 and 5 at 224 px (T, H) and at 384 px (stage 3 of ga_cswin_base_384: h
# = 24, ws = 12, T = 288 > MAX_TOKENS), and a width off the kernels' heads
STRIPE_SHAPES = [((2, 56, 56, 32), 1, 32), ((2, 28, 28, 64), 2, 32), ((2, 14, 14, 128), 7, 32),
                 ((2, 14, 14, 192), 7, 24), ((2, 24, 24, 192), 12, 24),
                 ((2, 48, 48, 96), 2, 24), ((2, 14, 14, 64), 7, 16), ((2, 7, 7, 64), 7, 32),
                 ((2, 20, 21, 64), 2, 32)]


def _stripe_cases():
    for (shape, ws, d), drop, training in itertools.product(STRIPE_SHAPES, [0.0, 0.1],
                                                            [False, True]):
        yield shape, ws, d, drop, training


@pytest.mark.parametrize("mode", ["fused", "xla"])
def test_stripe_attn_switch_matches_jax(mode, monkeypatch):
    monkeypatch.setenv("IMTPU_STRIPE_ATTN", mode)
    monkeypatch.setattr(tsa, "_STRIPE_ATTN", mode)
    seen = set()
    for shape, ws, d, drop, training in _stripe_cases():
        ref = jsa.use_fused_stripe_attn(shape, ws, drop, not training)
        got = tsa.use_fused_stripe_attn(shape, ws, drop, training, head_dim=d)
        assert got == (ref and d in tsa.HEAD_DIMS), (mode, shape, ws, d, drop, training)
        seen.add(got)
    assert seen == ({False} if mode == "xla" else {False, True})


@pytest.mark.parametrize("maxh", [8, 16, 24, 56])
def test_stripe_maxh_switch_matches_jax(maxh, monkeypatch):
    """Also the stripe that MAXH admits past the kernels' MAX_TOKENS (h = 24,
    ws = 12, T = 288 at MAXH >= 24): JAX takes its kernel, the port refuses
    it to the composition."""
    monkeypatch.setenv("IMTPU_STRIPE_MAXH", str(maxh))
    monkeypatch.setattr(tsa, "_STRIPE_MAXH", maxh)
    over_tokens = 0
    for shape, ws, d, drop, training in _stripe_cases():
        ref = jsa.use_fused_stripe_attn(shape, ws, drop, not training)
        got = tsa.use_fused_stripe_attn(shape, ws, drop, training, head_dim=d)
        within = shape[1] * ws <= tsa.MAX_TOKENS and d in tsa.HEAD_DIMS
        assert got == (ref and within), (maxh, shape, ws, d, drop, training)
        over_tokens += ref and shape[1] * ws > tsa.MAX_TOKENS
    assert (over_tokens > 0) == (maxh >= 24)
    # the JAX package's default: the 14x14 stage and its like only
    assert tsa.use_fused_stripe_attn((2, 28, 28, 64), 2, 0.0, True, head_dim=32) == (maxh >= 28)


def _ln_mlp_inputs(c=16, n=10, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, shift=0.0: (rng.standard_normal(s) * scale + shift).astype(np.float32)
    jargs = (f(n, c), f(c, scale=0.1, shift=1.0), f(c, scale=0.1), f(c, 4 * c, scale=c ** -0.5),
             f(4 * c, scale=0.1), f(4 * c, c, scale=(4 * c) ** -0.5), f(c, scale=0.1), f(c))
    return jargs, f(n, c)


def _close(got, ref):
    for o, r in zip(got, ref):
        r = np.asarray(r, np.float32).reshape(o.shape)
        assert np.abs(o - r).max() <= 1e-4 * np.abs(r).max()


@pytest.mark.parametrize("value", ["1", "0"])
def test_fused_bwd_switch_matches_jax(value, monkeypatch):
    """"1": both sides take the fused backward (kernel 2 / the Pallas
    kernel); "0": both take the plain VJP, whose gradients agree."""
    on = value != "0"
    monkeypatch.setattr(jcb, "_FUSED_BWD", on)
    monkeypatch.setattr(tcb, "_FUSED_BWD", on)
    routes = []
    monkeypatch.setattr(jcb, "_fused_ln_mlp_bwd_pallas",
                        lambda *a, **k: routes.append("jax-fused") or tuple(a[:8]))
    monkeypatch.setattr(tcb, "fused_ln_mlp_bwd",
                        lambda *a, **k: routes.append("port-fused") or tuple(a[:1] + a[2:9]))
    jargs, g = _ln_mlp_inputs()
    for gelu_impl in ("exact", "fast"):
        with jax.default_matmul_precision("highest"):
            ref = jcb._bwd(1e-6, gelu_impl, tuple(jnp.asarray(a) for a in jargs), jnp.asarray(g))
        targs = [torch.from_numpy(a) for a in jargs]
        targs[3], targs[5] = targs[3].t().contiguous(), targs[5].t().contiguous()
        got = [t.detach().numpy() for t in
               tcb.ln_mlp_backward(tuple(targs), torch.from_numpy(g), 1e-6, gelu_impl)]
        if not on:
            got[3], got[5] = got[3].T, got[5].T
            _close(got, ref)
    assert routes == (["jax-fused", "port-fused"] * 2 if on else [])


def _convnext_routes(monkeypatch):
    """Stubs of each side's block routes; returns the list they append to:
    (side, route) with route "kernel", "plain", "remat" or "device"."""
    routes = []
    zeros = lambda x, *a, **k: jnp.zeros_like(x)  # noqa: E731
    monkeypatch.setattr(jcb, "fused_convnext_block",
                        lambda x, *a, **k: routes.append(("jax", "kernel")) or x)
    monkeypatch.setattr(jcb, "plain_convnext_block",
                        lambda x, *a, **k: routes.append(("jax", "plain")) or x)
    monkeypatch.setattr(jcb.jax, "checkpoint",
                        lambda fn, **k: lambda x, *a: routes.append(("jax", "remat")) or x)
    monkeypatch.setattr(jcb.jax.lax, "platform_dependent",
                        lambda x, *a, **k: routes.append(("jax", "device")) or zeros(x))
    names = {None: "device", True: "kernel", False: "plain"}
    monkeypatch.setattr(tcb, "ln_mlp", lambda h, *a, use_kernel=None, **k:
                        routes.append(("port", names[use_kernel])) or h)
    monkeypatch.setattr(tcb, "checkpoint_call",
                        lambda fn, x, *a, **k: routes.append(("port", "remat")) or x)
    return routes


def _block_args(c):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((1, 4, 4, c)).astype(np.float32)
    vec = np.ones(c, np.float32)
    jw = (np.ones((7, 7, 1, c), np.float32), vec, vec, vec, np.ones((c, 4 * c), np.float32),
          np.ones(4 * c, np.float32), np.ones((4 * c, c), np.float32), vec, vec)
    tw = (torch.ones(c, 1, 7, 7), torch.ones(c), torch.ones(c), torch.ones(c),
          torch.ones(4 * c, c), torch.ones(4 * c), torch.ones(c, 4 * c), torch.ones(c),
          torch.ones(c))
    return x, jw, tw


@pytest.mark.parametrize("min_c", [0, 64, 128, 1024])
def test_pallas_min_c_switch_matches_jax(min_c, monkeypatch):
    """Blocks with C below IMTPU_PALLAS_MIN_C take the plain path when the
    caller leaves the route to the dispatch; an explicit choice stands."""
    monkeypatch.setattr(jcb, "_PALLAS_MIN_C", min_c)
    monkeypatch.setattr(tcb, "_PALLAS_MIN_C", min_c)
    monkeypatch.setattr(jcb, "_REMAT", False)
    monkeypatch.setattr(tcb, "_REMAT", False)
    routes = _convnext_routes(monkeypatch)
    for c, choice in itertools.product([32, 64, 96, 768], [None, True, False]):
        x, jw, tw = _block_args(c)
        del routes[:]
        jcb.convnext_block_apply(jnp.asarray(x), *jw, use_pallas=choice)
        tcb.convnext_block_apply(torch.from_numpy(x), *tw, use_kernel=choice)
        assert [r for s, r in routes if s == "jax"] == [r for s, r in routes if s == "port"], \
            (min_c, c, choice, routes)
        assert routes[0][1] == ("plain" if choice is None and c < min_c else
                                {None: "device", True: "kernel", False: "plain"}[choice])


@pytest.mark.parametrize("env", [False, True])
def test_block_remat_switch_matches_jax(env, monkeypatch):
    """IMTPU_BLOCK_REMAT and the `remat` argument recompute the plain path's
    block (and nothing else); the recomputed block's gradients are the plain
    block's bits, and JAX's remat gradients within 1e-4."""
    monkeypatch.setattr(jcb, "_REMAT", env)
    monkeypatch.setattr(tcb, "_REMAT", env)
    monkeypatch.setattr(jcb, "_PALLAS_MIN_C", 0)
    monkeypatch.setattr(tcb, "_PALLAS_MIN_C", 0)
    with monkeypatch.context() as m:
        routes = _convnext_routes(m)
        for choice, remat in itertools.product([None, True, False], [None, True, False]):
            x, jw, tw = _block_args(16)
            del routes[:]
            jcb.convnext_block_apply(jnp.asarray(x), *jw, use_pallas=choice, remat=remat)
            tcb.convnext_block_apply(torch.from_numpy(x), *tw, use_kernel=choice, remat=remat)
            jr, tr = [r for s, r in routes if s == "jax"], [r for s, r in routes if s == "port"]
            assert jr == tr, (env, choice, remat, routes)
            want_remat = choice is False and (remat if remat is not None else env)
            assert (jr == ["remat"]) == want_remat

    # the recomputed plain block, numerically: bit-equal to the kept one, and JAX's
    c, rng = 16, np.random.default_rng(1)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    x, g = f(2, 5, 5, c), f(2, 5, 5, c)
    jw = (f(7, 7, 1, c, scale=0.2), f(c, scale=0.1), 1 + f(c, scale=0.1), f(c, scale=0.1),
          f(c, 4 * c, scale=c ** -0.5), f(4 * c, scale=0.1), f(4 * c, c, scale=(4 * c) ** -0.5),
          f(c, scale=0.1), f(c))
    tw = [torch.from_numpy(a) for a in jw]
    tw[0] = tw[0].permute(3, 2, 0, 1).contiguous()
    tw[4], tw[6] = tw[4].t().contiguous(), tw[6].t().contiguous()

    def port_grads(remat):
        leaves = [torch.from_numpy(x).requires_grad_()] + [t.clone().requires_grad_() for t in tw]
        out = tcb.convnext_block_apply(*leaves, use_kernel=False, remat=remat, training=True)
        return torch.autograd.grad(out, leaves, torch.from_numpy(g))

    kept, recomputed = port_grads(False), port_grads(True)
    assert all(torch.equal(a, b) for a, b in zip(kept, recomputed))
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda *a: jcb.convnext_block_apply(*a, use_pallas=False, remat=True,
                                                             training=True),
                         *(jnp.asarray(a) for a in (x,) + jw))
        ref = vjp(jnp.asarray(g))
    got = [t.numpy() for t in recomputed]
    got[1] = got[1].transpose(2, 3, 1, 0)
    got[5], got[7] = got[5].T, got[7].T
    _close(got, ref)

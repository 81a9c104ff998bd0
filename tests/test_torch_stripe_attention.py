"""The port's CSWin stripe attention + LePE against the JAX package, the
dispatch rule and the gate.

`plain_stripe_attention` and `plain_stripe_attention_bwd`
(imagenet_models_tpu_torch/ops/stripe_attention.py), the twins of the CUDA
kernels 5 and 6, are held to JAX's `plain_stripe_attention` and to the Pallas
kernels `_vs_fwd_pallas` / `_vs_bwd_pallas` run in interpret mode, at the
geometry of tests/test_stripe_attention.py (stripes of width 1, 2, 7 and 3, a
non-square map, an odd batch), on the same numpy inputs in fp32. The CUDA
kernels are held to the twins on a GPU (the `cuda`-marked tests, and
chip_smoke.py).

This file imports jax only inside the tests that need it, so the GPU cases can
be collected on a machine without jax.
"""

import numpy as np
import pytest
import torch

from imagenet_models_tpu_torch.ops import stripe_attention as tsa

# (b, h, w, cb, nh, ws): tests/test_stripe_attention.py:22-29
CASES = [
    (2, 14, 14, 32, 1, 1),
    (2, 14, 14, 64, 2, 2),
    (1, 14, 14, 128, 4, 7),
    (2, 8, 12, 64, 2, 2),
    (3, 8, 9, 96, 3, 3),
]
# The Pallas kernels in interpret mode take 6-14 s per image on the 14x14
# maps of stripe width 1 and 2 (14 and 7 stripes, unrolled): those two run at
# batch 1 against them, at batch 2 against JAX's plain twin and its vjp.
PALLAS_CASES = [(1, *c[1:]) if c[1:3] == (14, 14) and c[5] < 7 else c for c in CASES]


def _close(got, ref, name=""):
    """fp32 on both sides, only the summation order differs: within 1e-5,
    relative to the largest |reference| where that is above 1 (dw9 and dwb
    are sums over every stripe of the batch, up to ~25 here)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=name)


def _inputs(b, h, w, cb, seed=0):
    """numpy q, k, v (b, h, w, cb), taps w9 (9, cb) and bias wb (1, cb) drawn
    at random (no symmetry a swapped tap order could hide behind), and a
    cotangent g."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    return (f(b, h, w, cb), f(b, h, w, cb), f(b, h, w, cb), f(9, cb, scale=0.2),
            f(1, cb, scale=0.1), f(b, h, w, cb))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,h,w,cb,nh,ws", PALLAS_CASES)
def test_forward_twin_matches_jax(b, h, w, cb, nh, ws):
    """Against JAX's plain twin and the Pallas forward in interpret mode, at
    JAX's own pack."""
    import jax
    import jax.numpy as jnp

    from imagenet_models_tpu.ops import stripe_attention as jsa

    q, k, v, w9, wb, _ = _inputs(b, h, w, cb)
    scale = (cb // nh) ** -0.5
    got = tsa.plain_stripe_attention(*_torch(q, k, v, w9, wb), ws=ws, nh=nh, scale=scale).numpy()
    args = [jnp.asarray(a) for a in (q, k, v, w9, wb)]
    with jax.default_matmul_precision("highest"):
        ref = jsa.plain_stripe_attention(*args, ws=ws, nh=nh, scale=scale)
        pal = jsa._vs_fwd_pallas(*args, ws=ws, nh=nh, scale=scale,
                                 pack=jsa._stripe_pack(h * ws, w // ws), interpret=True)
    _close(got, ref)
    _close(got, pal)


@pytest.mark.parametrize("b,h,w,cb,nh,ws", PALLAS_CASES)
def test_backward_twin_matches_pallas_backward(b, h, w, cb, nh, ws):
    """All five outputs of the backward twin against `_vs_bwd_pallas` in
    interpret mode."""
    import jax
    import jax.numpy as jnp

    from imagenet_models_tpu.ops import stripe_attention as jsa

    q, k, v, w9, wb, g = _inputs(b, h, w, cb, seed=3)
    scale = (cb // nh) ** -0.5
    with jax.default_matmul_precision("highest"):
        refs = jsa._vs_bwd_pallas(*[jnp.asarray(a) for a in (q, k, v, w9, wb, g)], ws=ws, nh=nh,
                                  scale=scale, pack=jsa._stripe_pack(h * ws, w // ws),
                                  interpret=True)
    outs = tsa.plain_stripe_attention_bwd(*_torch(q, k, v, w9, wb, g), ws=ws, nh=nh, scale=scale)
    for name, o, r in zip(("dq", "dk", "dv", "dw9", "dwb"), outs, refs):
        assert tuple(o.shape) == r.shape and o.dtype == torch.float32, name
        _close(o.numpy(), r, name)
    if ws == 1:  # the dy != 0 taps of width-1 stripes have no source: exactly 0
        np.testing.assert_array_equal(outs[3].numpy()[[0, 2, 3, 5, 6, 8]], 0.0)


@pytest.mark.parametrize("b,h,w,cb,nh,ws", CASES)
def test_cpu_autograd_matches_jax_vjp(b, h, w, cb, nh, ws):
    """The CPU dispatch: autograd through the forward twin against jax.vjp of
    JAX's twin, and no kernel launch."""
    import jax
    import jax.numpy as jnp

    from imagenet_models_tpu.ops import stripe_attention as jsa

    q, k, v, w9, wb, g = _inputs(b, h, w, cb, seed=5)
    scale = (cb // nh) ** -0.5
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda *a: jsa.plain_stripe_attention(*a, ws=ws, nh=nh, scale=scale),
                         *[jnp.asarray(a) for a in (q, k, v, w9, wb)])
        refs = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_() for t in _torch(q, k, v, w9, wb)]
    before = (tsa.fused_stripe_attention.launches, tsa.fused_stripe_attention_bwd.launches)
    tsa.stripe_attention(*leaves, ws=ws, num_heads=nh, scale=scale).backward(torch.from_numpy(g))
    assert (tsa.fused_stripe_attention.launches, tsa.fused_stripe_attention_bwd.launches) == before
    for name, t, r in zip(("dq", "dk", "dv", "dw9", "dwb"), leaves, refs):
        _close(t.grad.numpy(), r, name)


def test_tap_order_is_dx_along_h():
    """An asymmetric w9 (one tap at a time) against the depthwise conv of the
    torch weight layout: tap t = 3*(dx+1) + (dy+1) reads v[a+dx, y+dy] with dx
    along H. A twin with H and W swapped fails every off-centre tap."""
    b, h, w, cb, ws = 1, 6, 6, 32, 3
    q, k, v, _, _, _ = _torch(*_inputs(b, h, w, cb, seed=7))
    wb = torch.zeros(1, cb)
    base = tsa.plain_stripe_attention(q, k, v, torch.zeros(9, cb), wb, ws=ws, nh=1, scale=1.0)

    def lepe_of(t):
        w9 = torch.zeros(9, cb)
        w9[t] = 1.0
        return tsa.plain_stripe_attention(q, k, v, w9, wb, ws=ws, nh=1, scale=1.0) - base

    for t in range(9):
        dx, dy = t // 3 - 1, t % 3 - 1
        want = torch.zeros_like(v)
        for a in range(h):
            for x in range(w):
                src_a, src_y = a + dx, x % ws + dy
                if 0 <= src_a < h and 0 <= src_y < ws:  # inside the stripe of x
                    want[:, a, x] = v[:, src_a, x - x % ws + src_y]
        torch.testing.assert_close(lepe_of(t), want, rtol=0, atol=1e-5)
        if dx != dy:  # the tap with H and W swapped reads elsewhere
            assert not torch.allclose(lepe_of(3 * (dy + 1) + dx + 1), want, atol=1e-2)


def test_bf16_twin_rounds_q_p_and_ds():
    """In bf16 the twins round where the kernels round: q times the bf16
    scale (0.1767578 for d = 32), the rounded p and ds. Against the fp32
    twins run on the bf16 inputs, the outputs move by bf16 output rounding;
    dw9 and dwb, sums of exact products of the same values on both sides,
    do not move."""
    q, k, v, w9, wb, g = _torch(*_inputs(2, 14, 14, 64, seed=9))
    q16, k16, v16, g16 = (t.bfloat16() for t in (q, k, v, g))
    out = tsa.plain_stripe_attention(q16, k16, v16, w9, wb, ws=2, nh=2, scale=32 ** -0.5)
    assert out.dtype == torch.bfloat16
    ref = tsa.plain_stripe_attention(q16.float(), k16.float(), v16.float(), w9, wb, ws=2, nh=2,
                                     scale=32 ** -0.5)
    err = (out.float() - ref).abs().max().item()
    assert 0 < err <= 2e-2 * ref.abs().max().item()
    assert tsa._bf16_scale(32 ** -0.5) == 0.1767578125
    outs = tsa.plain_stripe_attention_bwd(q16, k16, v16, w9, wb, g16, ws=2, nh=2,
                                          scale=32 ** -0.5)
    refs = tsa.plain_stripe_attention_bwd(q16.float(), k16.float(), v16.float(), w9, wb,
                                          g16.float(), ws=2, nh=2, scale=32 ** -0.5)
    for name, o, r in zip(("dq", "dk", "dv", "dw9", "dwb"), outs, refs):
        assert o.dtype == (torch.float32 if name.startswith("dw") else torch.bfloat16), name
        bound = 0 if name.startswith("dw") else 3e-2
        assert (o.float() - r).abs().max().item() <= bound * r.abs().max().item() + 1e-6, name


def test_gate_matches_jax_on_ga_cswin_shapes():
    """The port's gate against JAX's on the idx=0 branch shapes of
    ga_cswin_tiny at 224 px (stages 1-3, the single-window stage 4, the
    stage-5 block and the gram layers), at 112 px, and with softmax dropout
    in both modes."""
    from imagenet_models_tpu.ops import stripe_attention as jsa

    shapes = [((2, 56, 56, 32), 1), ((2, 28, 28, 64), 2), ((2, 14, 14, 128), 7),
              ((2, 7, 7, 256), 7), ((2, 14, 14, 256), 7), ((2, 14, 14, 96), 7),
              ((2, 28, 28, 32), 1), ((2, 7, 7, 64), 7), ((2, 8, 12, 64), 2), ((3, 8, 9, 96), 3),
              ((2, 14, 15, 64), 2), ((2, 17, 34, 64), 2)]
    seen = set()
    for shape, ws in shapes:
        for drop, training in ((0.0, False), (0.0, True), (0.1, False), (0.1, True)):
            got = tsa.use_fused_stripe_attn(shape, ws, drop, training)
            assert got == jsa.use_fused_stripe_attn(shape, ws, drop, not training), \
                (shape, ws, drop, training)
            seen.add(got)
    assert seen == {True, False}


def test_cpu_dispatch_runs_the_twin_and_wrappers_refuse_cpu():
    q, k, v, w9, wb, g = _torch(*_inputs(1, 8, 8, 64, seed=6))
    before = tsa.fused_stripe_attention.launches
    got = tsa.stripe_attention(q, k, v, w9, wb, ws=2, num_heads=2, scale=0.25)
    torch.testing.assert_close(got, tsa.plain_stripe_attention(q, k, v, w9, wb, ws=2, nh=2,
                                                               scale=0.25), rtol=0, atol=0)
    assert tsa.fused_stripe_attention.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tsa.stripe_attention(q, k, v, w9, wb, ws=2, num_heads=2, scale=0.25, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tsa.fused_stripe_attention_bwd(q, k, v, w9, wb, g, 2, 2, 0.25)
    with pytest.raises(ValueError, match="stripes"):
        tsa.plain_stripe_attention(q, k, v, w9, wb, ws=3, nh=2, scale=0.25)
    with pytest.raises(ValueError, match="heads"):
        tsa.plain_stripe_attention(q, k, v, w9, wb, ws=2, nh=3, scale=0.25)


def test_pixel_rows_reads_channel_slices_in_place():
    """A channel slice of a wider map (q, k, v of a qkv projection, or the
    cotangent slice of a concat) is read in place; other layouts are copied."""
    qkv = torch.zeros(2, 4, 6, 3 * 64)
    for i in range(3):
        s = qkv[..., i * 64:i * 64 + 32]
        assert tsa._pixel_ld(s) == 192 and tsa.pixel_rows(s) is s
    t = qkv[..., :32].transpose(1, 2)
    assert tsa._pixel_ld(t) is None and tsa.pixel_rows(t).is_contiguous()
    assert tsa._pixel_ld(torch.zeros(1, 1, 1, 32)) == 32


# ---------------------------------------------------------------- on the card

def _cuda_inputs(b, h, w, cb, seed, sliced=False):
    """bf16 q, k, v on the card (channel slices of one qkv map when
    `sliced`), fp32 w9, wb, and a bf16 cotangent."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q, k, v, w9, wb, g = (t.cuda() for t in _torch(*_inputs(b, h, w, cb, seed=seed)))
    if sliced:
        qkv = torch.cat([q, torch.zeros_like(q), k, torch.zeros_like(k), v, torch.zeros_like(v)],
                        -1).bfloat16()
        q, k, v = qkv[..., :cb], qkv[..., 2 * cb:3 * cb], qkv[..., 4 * cb:5 * cb]
    else:
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    return q, k, v, w9, wb, g.bfloat16()


def _assert_kernel_close(got, ref):
    # both sum in fp32 in other orders, and a bf16-rounded p or ds may round
    # to its neighbour: 1e-2 of the largest |output| is 2.5 bf16 ulps
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item(), err


# (b, h, w, cb, heads, ws): the idx=0 stripes of ga_cswin_tiny at 224 px
# (stages 1-3, the stage-5 block, a gram layer) at small batch, ga_cswin_base's
# stage 3 (heads of 24), a non-square map, an odd batch and the longest stripe
GPU_CASES = [(2, 56, 56, 32, 1, 1), (2, 28, 28, 64, 2, 2), (2, 14, 14, 128, 4, 7),
             (2, 14, 14, 256, 8, 7), (2, 14, 14, 96, 3, 7), (2, 14, 14, 192, 8, 7),
             (2, 8, 12, 64, 2, 2), (3, 8, 9, 96, 3, 3), (1, 16, 32, 64, 2, 16)]
# the edges of the bf16 kernels' tensor-core tiles (stripes padded to 16-row
# blocks, heads of 24 padded to 32 channels, two key chunks past 128 tokens):
# T = 16, 24, 112, 128, 144, 200 and 256 with heads of 24 and 32, most with an
# odd number of stripes
TILE_CASES = [(2, 16, 16, 64, 2, 1), (1, 8, 6, 48, 2, 2), (1, 8, 9, 48, 2, 3),
              (2, 12, 4, 64, 2, 2), (2, 16, 14, 64, 2, 7), (1, 14, 24, 96, 4, 8),
              (2, 16, 16, 64, 2, 8), (1, 8, 48, 72, 3, 16), (1, 16, 18, 64, 2, 9),
              (1, 20, 30, 48, 2, 10), (1, 16, 48, 48, 2, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("b,h,w,cb,nh,ws", GPU_CASES + TILE_CASES)
def test_kernels_match_twins_on_cuda(b, h, w, cb, nh, ws, sliced):
    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    q, k, v, w9, wb, g = _cuda_inputs(b, h, w, cb, seed=7, sliced=sliced)
    scale = (cb // nh) ** -0.5
    out = sa.fused_stripe_attention(q, k, v, w9, wb, ws, nh, scale)
    outs = sa.fused_stripe_attention_bwd(q, k, v, w9, wb, g, ws, nh, scale)
    torch.cuda.synchronize()
    _assert_kernel_close(out, sa.plain_stripe_attention(q, k, v, w9, wb, ws=ws, nh=nh, scale=scale))
    refs = sa.plain_stripe_attention_bwd(q, k, v, w9, wb, g, ws=ws, nh=nh, scale=scale)
    for o, r in zip(outs, refs):
        _assert_kernel_close(o, r)
    # every sum has a fixed order (no atomics): the same bits on every run
    again = sa.fused_stripe_attention_bwd(q, k, v, w9, wb, g, ws, nh, scale)
    assert all(torch.equal(a, o) for a, o in zip(again, outs))
    assert torch.equal(sa.fused_stripe_attention(q, k, v, w9, wb, ws, nh, scale), out)
    if ws == 1:
        assert not outs[3][[0, 2, 3, 5, 6, 8]].any()


@pytest.mark.cuda
def test_autograd_on_cuda_runs_both_kernels():
    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    q, k, v, w9, wb, g = _cuda_inputs(2, 14, 14, 64, seed=8, sliced=True)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, w9, wb)]
    fwd, bwd = sa.fused_stripe_attention.launches, sa.fused_stripe_attention_bwd.launches
    sa.stripe_attention(*leaves, ws=7, num_heads=2, scale=32 ** -0.5).backward(g)
    assert (sa.fused_stripe_attention.launches - fwd,
            sa.fused_stripe_attention_bwd.launches - bwd) == (1, 1)
    refs = sa.plain_stripe_attention_bwd(q, k, v, w9, wb, g, ws=7, nh=2, scale=32 ** -0.5)
    for t, r in zip(leaves, refs):
        _assert_kernel_close(t.grad.to(r.dtype), r)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_cannot_take_on_cuda():
    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    q, k, v, w9, wb, g = _cuda_inputs(1, 14, 14, 64, seed=9)
    with pytest.raises(TypeError, match="bf16 or fp32"):  # fp16; fp32 has an instance
        sa.fused_stripe_attention(q.half(), k, v, w9, wb, 7, 2, 0.25)
    with pytest.raises(ValueError, match="pixels"):
        sa.fused_stripe_attention(q.transpose(1, 2), k, v, w9, wb, 7, 2, 0.25)
    with pytest.raises(ValueError, match="w9"):
        sa.fused_stripe_attention(q, k, v, w9[:3], wb, 7, 2, 0.25)
    with pytest.raises(ValueError, match="cotangent"):
        sa.fused_stripe_attention_bwd(q, k, v, w9, wb, g.float(), 7, 2, 0.25)
    with pytest.raises(ValueError, match="width"):  # heads of 64 channels
        sa.fused_stripe_attention(q, k, v, w9, wb, 7, 1, 0.25)
    tall = torch.zeros(1, 20, 14, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="256"):  # T = 280
        sa.fused_stripe_attention(tall, tall, tall, w9, wb, 14, 2, 0.25)


@pytest.mark.cuda
@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("b,h,w,cb,nh,ws", [(2, 14, 14, 64, 2, 7), (2, 14, 14, 96, 3, 7),
                                            (1, 16, 32, 64, 2, 16), (2, 56, 56, 32, 1, 1)])
def test_fp32_instances_match_twins_on_cuda(b, h, w, cb, nh, ws, sliced):
    """Kernels 5 and 6 on fp32 maps (an fp32 model) run their fp32 instances,
    with no rounding to bf16 (q times the fp32 scale): fp32 sums in other
    orders than the twins', within 1e-4 of the twin's largest |value|."""
    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    q, k, v, w9, wb, g = _cuda_inputs(b, h, w, cb, seed=10)
    q, k, v, g = (t.float() for t in (q, k, v, g))
    if sliced:  # channel slices of one fp32 qkv map, read in place
        qkv = torch.cat([q, k, v], -1)
        q, k, v = qkv[..., :cb], qkv[..., cb:2 * cb], qkv[..., 2 * cb:]
        assert sa.pixel_rows(q) is q
    scale = (cb // nh) ** -0.5
    out = sa.fused_stripe_attention(q, k, v, w9, wb, ws, nh, scale)
    outs = sa.fused_stripe_attention_bwd(q, k, v, w9, wb, g, ws, nh, scale)
    refs = (sa.plain_stripe_attention(q, k, v, w9, wb, ws=ws, nh=nh, scale=scale),)
    refs += tuple(sa.plain_stripe_attention_bwd(q, k, v, w9, wb, g, ws=ws, nh=nh, scale=scale))
    for got, ref in zip((out,) + tuple(outs), refs):
        assert got.dtype == ref.dtype == torch.float32 and got.shape == ref.shape
        assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()

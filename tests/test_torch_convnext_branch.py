"""The port's fused ConvNeXt branch (kernels 10 and 11,
imagenet_models_tpu_torch/ops/convnext_branch.py) against the JAX package.

`plain_convnext_branch` and `plain_convnext_branch_bwd`, the twins of the
CUDA kernels, are held to the Pallas kernels `_branch_fwd_pallas` and
`_branch_bwd_pallas` in interpret mode on the same numpy inputs, at
(2, 8, 8, 32) and (3, 7, 9, 64); the second with JAX's `_group`
monkeypatched to one image per grid step, so the TPU kernel's gradients add
up over three steps (as tests/test_convnext_branch.py:37 forces it). The
CPU dispatch of `convnext_branch_apply` (the plain composition under
autograd) is held to JAX's `convnext_branch_apply` on the CPU (JAX's plain
composition there), forward and `jax.vjp`, on a narrow ConvNeXt block's
weights carried across by `ckpt/convert.py`. `ConvNeXtBranchFunction`, run on
the CPU with the kernel wrappers replaced by the twins, is held to `jax.vjp`
of JAX's custom VJP `fused_convnext_branch` in interpret mode. The CUDA
kernels are held to the twins on a GPU (the `cuda`-marked tests, and
chip_smoke.py phase 25).

Tolerances. fp32 at highest precision: 3e-5 forward and 5e-5 backward,
tests/test_convnext_branch.py's (:52, :72), of the largest |value| of each
output (the two sides sum the same exact products in other orders). bf16:
both round the tokens, the GELU output, dpre2, dpre1 and the outputs to bf16
at the same places; a different summation order can move a value across a
rounding boundary, by one bf16 ulp (2^-8 relative) of that value, and such a
flip reaches an output scaled by at most about one ulp of its own size. So
2^-7 (two ulps) of the largest |value| of each output.

This file imports jax only inside the tests that need it, so the GPU cases
can be collected on a machine without jax.
"""

import numpy as np
import pytest
import torch

from imagenet_models_tpu_torch.ops import convnext_branch as tbr

SHAPES = [((2, 8, 8, 32), 0), ((3, 7, 9, 64), 1)]  # (B, H, W, C), images per grid step (0: JAX's)
F32_FWD, F32_BWD, BF16_TOL = 3e-5, 5e-5, 2.0 ** -7


def _case(b, h, w, c, seed=0):
    """numpy x and the parameters in JAX's layouts (tests/test_convnext_branch.py:24-32)."""
    rng = np.random.default_rng(seed)
    hid = 4 * c
    mk = lambda s, sc: (rng.standard_normal(s) * sc).astype(np.float32)
    return (rng.standard_normal((b, h, w, c)).astype(np.float32), mk((7, 7, 1, c), 0.1),
            mk((c,), 0.3), mk((c,), 0.3), mk((c,), 0.3), mk((c, hid), 0.05), mk((hid,), 0.3),
            mk((hid, c), 0.05), mk((c,), 0.3), mk((c,), 0.3))


def _torch_params(jparams):
    """JAX-layout parameters (dw (7, 7, 1, C), Dense (in, out)) in the port's
    layout (dw (C, 1, 7, 7), Linear (out, in)), as torch tensors."""
    dww, dwb, lns, lnb, w1, b1, w2, b2, gm = (np.asarray(p, np.float32) for p in jparams)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(np.transpose(dww, (3, 2, 0, 1))), t(dwb), t(lns), t(lnb), t(w1.T), t(b1), t(w2.T),
            t(b2), t(gm))


def _jax_layout(name, got, c):
    """A port gradient as numpy in JAX's layout."""
    a = got.float().detach().numpy()
    if name == "ddw_w":
        return np.transpose(a, (2, 3, 1, 0))  # (C, 1, 7, 7) -> (7, 7, 1, C)
    if name in ("dw1", "dw2"):
        return a.T
    return a


def _bf16(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _assert_close(got, ref, tol, what):
    err = np.abs(got - ref).max()
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert err <= tol * np.abs(ref).max(), (what, err, np.abs(ref).max())


# ---------------------------------------------------------------- the twins

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,grp", SHAPES)
def test_twins_match_pallas_kernels(shape, grp, dtype, monkeypatch):
    """Forward and every gradient of the twins against the TPU kernels in
    interpret mode, on the same values (x and g rounded to bf16 first in
    bf16)."""
    import jax
    import jax.numpy as jnp

    from imagenet_models_tpu.ops import convnext_branch as jbr

    if grp:
        monkeypatch.setattr(jbr, "_group", lambda *a, **k: grp)
    c = shape[-1]
    x, *params = _case(*shape)
    g = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        x, g = _bf16(x), _bf16(g)
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(x, jdt), jnp.asarray(params[0]).reshape(49, c)] + \
        [jnp.asarray(p) for p in params[1:]]
    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        ref = jbr._branch_fwd_pallas(*jargs, interpret=True)
        ref_grads = jbr._branch_bwd_pallas(*jargs, jnp.asarray(g, jdt), interpret=True)
    tdt = getattr(torch, dtype)
    tx, tg, tparams = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt), _torch_params(params)
    got = tbr.plain_convnext_branch(tx, *tparams)
    assert got.dtype == tdt
    tol = (F32_FWD, F32_BWD) if dtype == "float32" else (BF16_TOL, BF16_TOL)
    _assert_close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), tol[0], "out")
    grads = tbr.plain_convnext_branch_bwd(tx, tg, *tparams)
    assert grads[0].dtype == tdt and all(d.dtype == torch.float32 for d in grads[1:])
    for name, o, r, p in zip(tbr.GRAD_NAMES, grads, ref_grads, [x] + params):
        r = np.asarray(r.astype(jnp.float32)).reshape(p.shape)
        _assert_close(_jax_layout(name, o, c), r, tol[1], name)


def test_tap_layout_on_single_taps():
    """Tap (ky, kx) of the port's (C, 1, 7, 7) weight is JAX's [ky, kx, 0, c]:
    with one tap set, the twins' conv shifts the map as JAX's `dw_conv7`
    does, and its data gradient shifts a single cotangent pixel back; a
    single x pixel against a single dh pixel lights exactly one tap of the
    tap gradient."""
    import jax.numpy as jnp

    from imagenet_models_tpu.ops.convnext_block import dw_conv7 as jax_dw_conv7

    c = 16
    k = np.zeros((7, 7, 1, c), np.float32)
    k[1, 5, 0, :] = 1.0
    taps = tbr._taps(torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))))
    xs = np.random.default_rng(3).standard_normal((1, 9, 9, c)).astype(np.float32)
    ref = np.asarray(jax_dw_conv7(jnp.asarray(xs), jnp.asarray(k), jnp.zeros(c)))
    got = tbr._dw_fp32(torch.from_numpy(xs), taps, torch.zeros(c))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert np.allclose(got.numpy()[0, 2, 2], xs[0, 0, 4])   # h[y, x] = x[y - 2, x + 2]
    x = torch.zeros(1, 9, 9, c)
    x[0, 2, 6, 3] = 1.0
    dh = torch.zeros(1, 9, 9, c)
    dh[0, 4, 5, 3] = 1.0
    dx, ddw = tbr._conv_bwd(x, dh, taps)
    assert dx.sum() == 1.0 and dx[0, 2, 7, 3] == 1.0   # dx[y, x] = dh[y + 2, x - 2]
    assert ddw.sum() == 1.0 and ddw[3, 0, 2 - 4 + 3, 6 - 5 + 3] == 1.0


# ---------------------------------------------------------------- the dispatch

def _block_weights(c, seed):
    """A narrow JAX ConvNeXtBlock's random variables and the port's copy of
    them through `state_dict_from_jax`: (JAX branch parameters, port
    ConvNeXtBlock)."""
    import jax.numpy as jnp

    from imagenet_models_tpu.models.convnext import ConvNeXtBlock as JaxBlock
    from imagenet_models_tpu_torch.ckpt.convert import state_dict_from_jax
    from imagenet_models_tpu_torch.models.convnext import ConvNeXtBlock
    from torch_parity import init_shapes, random_variables

    shapes = init_shapes(JaxBlock(dim=c, ls_init_value=1.0), jnp.zeros((1, 8, 8, c)))
    variables = random_variables(shapes, seed=seed)
    prefix = "stages_0_blocks_0"
    sd = state_dict_from_jax({col: {prefix: tree} for col, tree in variables.items()},
                             "map_convnext_tiny")
    block = ConvNeXtBlock(c, ls_init_value=1.0)
    block.load_state_dict({k[len("stages.0.0."):]: v for k, v in sd.items()}, strict=True)
    p = variables["params"]
    jparams = (p["dwconv"]["kernel"], p["dwconv"]["bias"], p["norm"]["scale"], p["norm"]["bias"],
               p["pwconv1"]["kernel"], p["pwconv1"]["bias"], p["pwconv2"]["kernel"],
               p["pwconv2"]["bias"], p["gamma"])
    tparams = (block.dwconv.weight, block.dwconv.bias, block.norm.weight, block.norm.bias,
               block.pwconv1.weight, block.pwconv1.bias, block.pwconv2.weight,
               block.pwconv2.bias, block.gamma)
    return jparams, tparams


@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (3, 7, 9, 64)])
def test_apply_matches_jax_apply_on_cpu(shape):
    """`convnext_branch_apply` on CPU tensors (the plain composition under
    autograd) against JAX's `convnext_branch_apply` on the CPU (its plain
    composition), forward and `jax.vjp`, in fp32 on a narrow ConvNeXt
    block's converted weights; no kernel launches."""
    import jax
    import jax.numpy as jnp

    from imagenet_models_tpu.ops import convnext_branch as jbr

    c = shape[-1]
    jparams, tparams = _block_weights(c, seed=4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        ref, vjp = jax.vjp(jbr.convnext_branch_apply, jnp.asarray(x), *jparams)
        ref_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_()] + [p.detach().clone().requires_grad_()
                                                       for p in tparams]
    before = (tbr.fused_convnext_branch.launches, tbr.fused_convnext_branch_bwd.launches)
    out = tbr.convnext_branch_apply(*leaves)
    out.backward(torch.from_numpy(g))
    assert (tbr.fused_convnext_branch.launches, tbr.fused_convnext_branch_bwd.launches) == before
    _assert_close(out.detach().numpy(), np.asarray(ref), F32_FWD, "out")
    for name, t, r in zip(tbr.GRAD_NAMES, leaves, ref_grads):
        _assert_close(_jax_layout(name, t.grad, c), np.asarray(r), F32_BWD, name)


def test_gamma_none_means_ones():
    """gamma=None is a unit layer scale on both dispatch paths, as in JAX."""
    import jax
    import jax.numpy as jnp

    from imagenet_models_tpu.ops import convnext_branch as jbr

    x, *params = _case(2, 6, 6, 32, seed=6)
    tparams = _torch_params(params)
    tx = torch.from_numpy(x)
    ones = torch.ones(32)
    got = tbr.convnext_branch_apply(tx, *tparams[:-1], None)
    torch.testing.assert_close(got, tbr.convnext_branch_apply(tx, *tparams[:-1], ones),
                               rtol=0, atol=0)
    torch.testing.assert_close(tbr.plain_convnext_branch(tx, *tparams[:-1], ones), got,
                               rtol=1e-5, atol=1e-5)
    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        ref = jbr.convnext_branch_apply(jnp.asarray(x), *[jnp.asarray(p) for p in params[:-1]],
                                        None)
    _assert_close(got.numpy(), np.asarray(ref), F32_FWD, "out")


def test_dispatch_rules(monkeypatch):
    """use_kernel=False and CPU tensors take the plain composition; the
    kernel path goes to the autograd function of the two kernels and never
    to a twin: on the CPU its wrappers raise, and with the twins made to
    raise the dispatcher still reaches the kernel wrappers."""
    x, *params = _case(2, 5, 7, 32, seed=7)
    tx, tparams = torch.from_numpy(x), _torch_params(params)
    plain = tbr.plain_branch(tx, *tparams)
    for kw in ({}, {"use_kernel": False}):
        torch.testing.assert_close(tbr.convnext_branch_apply(tx, *tparams, **kw), plain,
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tbr.convnext_branch_apply(tx, *tparams, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tbr.fused_convnext_branch(tx, *tparams)
    with pytest.raises(ValueError, match="CUDA"):
        tbr.fused_convnext_branch_bwd(tx, tx, *tparams)

    def refuse(*a, **k):
        raise AssertionError("the kernel path reached a twin or the composition")

    reached = []
    monkeypatch.setattr(tbr, "plain_convnext_branch", refuse)
    monkeypatch.setattr(tbr, "plain_convnext_branch_bwd", refuse)
    monkeypatch.setattr(tbr, "plain_branch", refuse)
    monkeypatch.setattr(tbr, "fused_convnext_branch", lambda *a: reached.append("fwd") or a[0] * 1.0)
    tbr.convnext_branch_apply(tx, *tparams, use_kernel=True)
    assert reached == ["fwd"]


def test_autograd_function_pulls_back_like_jax_custom_vjp(monkeypatch):
    """`ConvNeXtBranchFunction` on the CPU with the kernel wrappers replaced
    by their twins, gamma=None through the dispatcher: the output and every
    gradient against `jax.vjp` of JAX's custom VJP `fused_convnext_branch`
    (its Pallas forward and backward in interpret mode), in fp32, on a
    three-step grid."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from imagenet_models_tpu.ops import convnext_branch as jbr

    monkeypatch.setattr(jbr, "_group", lambda *a, **k: 1)
    counts = []
    monkeypatch.setattr(tbr, "fused_convnext_branch",
                        lambda *a: counts.append("fwd") or tbr.plain_convnext_branch(*a))
    monkeypatch.setattr(tbr, "fused_convnext_branch_bwd",
                        lambda *a: counts.append("bwd") or tbr.plain_convnext_branch_bwd(*a))
    x, *params = _case(3, 6, 5, 32, seed=8)
    g = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    c = x.shape[-1]
    jargs = [jnp.asarray(x), jnp.asarray(params[0]).reshape(49, c)] + \
        [jnp.asarray(p) for p in params[1:-1]] + [jnp.ones((c,), jnp.float32)]
    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        with pltpu.force_tpu_interpret_mode():
            ref, vjp = jax.vjp(jbr.fused_convnext_branch, *jargs)
            ref_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_()] + [p.requires_grad_()
                                                       for p in _torch_params(params)[:-1]]
    out = tbr.convnext_branch_apply(*leaves, None, use_kernel=True)
    out.backward(torch.from_numpy(g))
    assert counts == ["fwd", "bwd"]
    _assert_close(out.detach().numpy(), np.asarray(ref), F32_FWD, "out")
    for name, t, r in zip(tbr.GRAD_NAMES, leaves, ref_grads):
        r = np.asarray(r)
        if name == "ddw_w":
            r = r.reshape(7, 7, 1, c)
        _assert_close(_jax_layout(name, t.grad, c), r, F32_BWD, name)


# ---------------------------------------------------------------- on the card

def _cuda_case(shape, dtype, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, *params = _case(*shape, seed=seed)
    g = np.random.default_rng(seed + 1).standard_normal(shape).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(dtype).cuda()
    return to(x), to(g), [p.cuda() for p in _torch_params(params)]


def _assert_kernel_close(got, ref, what, dtype):
    # a run in `dtype`. bf16: both sum in fp32 in other orders, and a value
    # rounded to bf16 may land on its neighbour; 1e-2 of the largest |value|
    # is 2.5 ulps at the top of the range (chip_smoke.py's KERNEL_RTOL).
    # fp32: the kernels' products are 3xTF32 (about 22 bits kept) against
    # exact fp32 in the twins, summed in other orders: within 2.5e-4, below
    # what one-pass TF32 products read (chip_smoke.py's BRANCH_FP32_RTOL)
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    tol = 1e-2 if dtype == torch.bfloat16 else 2.5e-4
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), (what, err)


GPU_SHAPES = [(4, 56, 56, 96), (4, 28, 28, 192), (5, 14, 14, 384), (3, 7, 7, 768),
              (2, 14, 14, 192), (3, 7, 7, 688), (2, 20, 36, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_kernels_match_twins_on_cuda(shape, dtype):
    x, g, params = _cuda_case(shape, dtype, seed=10)
    with torch.no_grad():
        out = tbr.fused_convnext_branch(x, *params)
        grads = tbr.fused_convnext_branch_bwd(x, g, *params)
        again = tbr.fused_convnext_branch_bwd(x, g, *params)
        torch.cuda.synchronize()
        _assert_kernel_close(out, tbr.plain_convnext_branch(x, *params), "out", dtype)
        for name, o, r, a in zip(tbr.GRAD_NAMES, grads, tbr.plain_convnext_branch_bwd(x, g, *params),
                                 again):
            _assert_kernel_close(o, r, name, dtype)
            assert torch.equal(o, a), name  # fixed summation order


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 7, 7, 1024), (1, 9, 11, 896)])
def test_bf16_kernels_take_the_widest_channels_on_cuda(shape):
    """bf16 at C = 1024 and 896, where the channel pairs outnumber the conv +
    LayerNorm stage's threads (a thread takes two, reloading its taps) and,
    at 1024, that stage's ring keeps 7 rows, not 8."""
    x, g, params = _cuda_case(shape, torch.bfloat16, seed=14)
    with torch.no_grad():
        out = tbr.fused_convnext_branch(x, *params)
        grads = tbr.fused_convnext_branch_bwd(x, g, *params)
        torch.cuda.synchronize()
        _assert_kernel_close(out, tbr.plain_convnext_branch(x, *params), "out", torch.bfloat16)
        for name, o, r in zip(tbr.GRAD_NAMES, grads, tbr.plain_convnext_branch_bwd(x, g, *params)):
            _assert_kernel_close(o, r, name, torch.bfloat16)


@pytest.mark.cuda
def test_autograd_on_cuda_runs_the_kernels():
    x, g, params = _cuda_case((2, 14, 14, 96), torch.bfloat16, seed=12)
    leaves = [x.clone().requires_grad_()] + [p.clone().requires_grad_() for p in params]
    before = (tbr.fused_convnext_branch.launches, tbr.fused_convnext_branch_bwd.launches)
    tbr.convnext_branch_apply(*leaves).backward(g)
    assert (tbr.fused_convnext_branch.launches - before[0],
            tbr.fused_convnext_branch_bwd.launches - before[1]) == (1, 1)
    ref = tbr.plain_convnext_branch_bwd(x, g, *params)
    for name, t, r in zip(tbr.GRAD_NAMES, leaves, ref):
        _assert_kernel_close(t.grad, r, name, torch.bfloat16)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_cannot_take_on_cuda():
    x, g, params = _cuda_case((2, 7, 7, 96), torch.bfloat16, seed=13)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        tbr.fused_convnext_branch(x.half(), *params)
    with pytest.raises(ValueError, match="contiguous"):
        tbr.fused_convnext_branch(x.transpose(1, 2), *params)
    with pytest.raises(ValueError, match="cotangent"):
        tbr.fused_convnext_branch_bwd(x, g.float(), *params)
    odd = torch.zeros(1, 4, 4, 40, dtype=torch.bfloat16, device="cuda")  # C not a multiple of 16
    odd_params = [p.cuda() for p in _torch_params(_case(1, 4, 4, 40)[1:])]
    with pytest.raises(ValueError, match="does not take"):
        tbr.fused_convnext_branch(odd, *odd_params)

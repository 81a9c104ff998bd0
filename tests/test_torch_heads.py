"""Port layers and MAP-head modules against the JAX package, fp32, narrow widths.

Each case builds the JAX module and its port counterpart, randomizes every
parameter and BN statistic from numpy, carries the weights over with
`state_dict_from_jax`, and compares outputs on the same numpy inputs.
Tolerance: fp32 on both sides, XLA at highest precision; only the order of
summation differs (~1e-6 relative), so 1e-5 leaves margin without hiding a
wrong op.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagenet_models_tpu.nn import heads as jh
from imagenet_models_tpu.nn import layers as jl
from imagenet_models_tpu_torch.nn import heads as th
from imagenet_models_tpu_torch.nn import layers as tl
from torch_parity import highest, init_shapes, load_port, random_variables

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _parity(jmodule, tmodule, inputs, seed=0, jkw=None, tkw=None, jinputs=None):
    """Run both sides on the same weights; return (jax_out, port_out) as numpy."""
    jkw, tkw = jkw or {}, tkw or {}
    jinputs = jinputs if jinputs is not None else [jnp.asarray(a) for a in inputs]
    variables = random_variables(init_shapes(jmodule, *jinputs, **jkw), seed=seed)
    with highest():
        ref = jmodule.apply(variables, *jinputs, **jkw)
    load_port(tmodule, variables, prefix="m")
    with torch.no_grad():
        got = tmodule(*[torch.from_numpy(a) for a in inputs], **tkw)
    return ref, got


def test_layer_norm():
    ref, got = _parity(jl.LayerNorm(), tl.LayerNorm(12), [_x(3, 5, 12)])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_batch_norm_eval_running_stats():
    ref, got = _parity(jl.BatchNorm(), tl.BatchNorm(12), [_x(3, 4, 4, 12)],
                       jkw={"use_running_average": True})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_grouped_dense():
    ref, got = _parity(jl.GroupedDense(24, groups=3), tl.GroupedDense(12, 24, groups=3),
                       [_x(5, 12)])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_group_conv_mlp(act):
    jact, tact = {"relu": (jl.nn.relu, tl.relu), "gelu": (jl.gelu, tl.gelu)}[act]
    ref, got = _parity(jl.GroupConvMlp(hidden_features=32, act=jact, groups=2),
                       tl.GroupConvMlp(16, 32, act=tact, groups=2), [_x(2, 3, 16)])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((8, 8), (4, 4)),    # bilinear down, integer factor
    ((12, 12), (5, 5)),  # bilinear down, fractional factor
    ((2, 2), (4, 4)),    # adaptive-avg duplication up
    ((7, 7), (14, 14)),  # adaptive-avg up, the 7 -> 14 of ConvNeXt-T
    ((3, 3), (7, 7)),    # adaptive-avg up, uneven bins
    ((4, 4), (4, 4)),    # identity
])
def test_scale_features(in_hw, out_hw):
    x = _x(2, *in_hw, 5)
    ref = jl.scale_features(jnp.asarray(x), out_hw)
    got = tl.scale_features(torch.from_numpy(x), out_hw)
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("fn,in_hw,out_hw", [
    ("adaptive_avg_pool", (8, 8), (2, 2)),    # GA-CSWin's 56 -> 14 and 28 -> 14
    ("adaptive_avg_pool", (4, 6), (2, 3)),    # non-square
    ("adaptive_avg_pool", (7, 7), (3, 3)),    # uneven bins
    ("adaptive_avg_pool", (3, 3), (7, 7)),    # duplication up, uneven
    ("resize_bilinear", (7, 7), (14, 14)),    # GA-CSWin's 7 -> 14
    ("resize_bilinear", (12, 12), (5, 5)),    # down, fractional factor
    ("resize_bilinear", (5, 8), (9, 3)),      # up one axis, down the other
])
def test_resample_and_its_gradient(fn, in_hw, out_hw):
    """The resamples' values and input gradients (their own backward, the
    transpose by per-axis weights) against JAX's functions and jax.vjp."""
    import jax

    x = _x(2, *in_hw, 5)
    g = np.random.default_rng(3).standard_normal((2, *out_hw, 5)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: getattr(jl, fn)(a, out_hw), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = getattr(tl, fn)(tx, out_hw)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), **TOL)


@pytest.mark.parametrize("interleave", [1, 3])
def test_gram_triu_normalize_fp32(interleave):
    x = _x(2, 9, 6)
    with highest():
        ref = jh.gram_triu_normalize(jnp.asarray(x), scale=1.0 / 9, interleave=interleave)
    got = th.gram_triu_normalize(torch.from_numpy(x), scale=1.0 / 9, interleave=interleave)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_gram_triu_normalize_bf16_is_exact_products():
    """bf16 tokens: the Gram of the bf16 values comes out in fp32, not rounded
    to bf16 -- equal to the fp32 path on the same (bf16-representable) values."""
    xb = torch.from_numpy(_x(2, 49, 16)).to(torch.bfloat16)
    got = th.gram_triu_normalize(xb, scale=1.0 / 49, interleave=2)
    assert got.dtype == torch.float32
    exact = xb.float().numpy()
    with highest():
        ref = jh.gram_triu_normalize(jnp.asarray(exact), scale=1.0 / 49, interleave=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the trap this guards against: a Gram rounded to bf16 before the triu
    # and the normalize is off by up to 2^-9 relative, far outside TOL
    gram = torch.bmm(xb.float().transpose(1, 2), xb.float()).to(torch.bfloat16).float()
    flat = gram.reshape(2, -1)[:, th.triu_flat_index(16)]
    flat = flat / flat.norm(dim=-1, keepdim=True)
    exact1 = th.gram_triu_normalize(xb, scale=1.0 / 49)
    assert (flat - exact1).abs().max().item() > 1e-4


def test_gram_token():
    jm = jh.GramToken(16, num_groups=2, num_tokens=2, bp_dim=8, out_dim=12)
    tm = th.GramToken(16, num_groups=2, num_tokens=2, bp_dim=8, out_dim=12)
    ref, got = _parity(jm, tm, [_x(2, 4, 4, 16)], jkw={"training": False})
    assert tuple(got.shape) == (2, 2, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert "bp_index" not in tm.state_dict()  # non-persistent, as the export drops it


@pytest.mark.parametrize("interactive", [False, True])
def test_class_attention(interactive):
    jm = jh.ClassAttention(16, 16, num_heads=2, n_tokens=3, embed_dim=8,
                           interactive=interactive)
    tm = th.ClassAttention(16, 16, num_heads=2, n_tokens=3, embed_dim=8,
                           interactive=interactive)
    ref, got = _parity(jm, tm, [_x(2, 10, 16)])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_class_attention_dim_mismatch():
    cls, img = _x(2, 3, 12), _x(2, 10, 16, seed=1)
    jm = jh.ClassAttention(12, 16, num_heads=2, n_tokens=3, embed_dim=8)
    tm = th.ClassAttention(12, 16, num_heads=2, n_tokens=3, embed_dim=8)
    variables = random_variables(init_shapes(jm, (jnp.asarray(cls), jnp.asarray(img))))
    with highest():
        ref = jm.apply(variables, (jnp.asarray(cls), jnp.asarray(img)))
    load_port(tm, variables, prefix="m")
    with torch.no_grad():
        got = tm((torch.from_numpy(cls), torch.from_numpy(img)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _map_head_kwargs(**over):
    kw = dict(multi_scale_level=3, last_dim=16, n_tokens=2, n_groups=2,
              self_distill_token=True, mlp_ratio=4, mlp_groups=2, head_fn="norm",
              num_classes=11, gram=True, bp_dim=8, gram_group=2, ca_dim=16, num_heads=2)
    kw.update(over)
    return kw


_CHANNELS = [8, 8, 8, 16, 16]
_HW = [16, 16, 8, 4, 2]  # a 64 px pyramid: bilinear down to 4x4 and duplication up


@pytest.mark.parametrize("light,pre_logits", [(False, False), (True, False), (False, True)])
def test_map_head_eval_tuple(light, pre_logits):
    feats = [_x(2, hw, hw, c, seed=i) for i, (hw, c) in enumerate(zip(_HW, _CHANNELS))]
    jm = jh.MAPHead(channels=_CHANNELS, non_linearity=jl.gelu, light=light, **_map_head_kwargs())
    tm = th.MAPHead(channels=_CHANNELS, non_linearity=tl.gelu, light=light, **_map_head_kwargs())
    jfeats = [jnp.asarray(f) for f in feats]
    variables = random_variables(init_shapes(jm, jfeats, training=False))
    with highest():
        ref = jm.apply(variables, jfeats, training=False, pre_logits=pre_logits)
    load_port(tm, variables, prefix="m")
    with torch.no_grad():
        got = tm([torch.from_numpy(f) for f in feats], pre_logits=pre_logits)
    assert isinstance(got, tuple) and len(got) == len(ref) == 2
    for r, g in zip(ref, got):
        assert tuple(g.shape) == tuple(r.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    avg = th.average_head_logits(got)
    np.testing.assert_allclose(avg.numpy(), np.asarray(jh.average_head_logits(ref)), **TOL)


# ---------------------------------------------------------------- the heads of every head_fn

_HEAD_KINDS = {
    "Head": (lambda: jh.Head(11, drop=0.3), lambda: th.Head(12, 11, drop=0.3)),
    "NormHead": (lambda: jh.NormHead(11, drop=0.3, nt=3), lambda: th.NormHead(12, 11, 0.3, nt=3)),
    "SplitNormHead": (lambda: jh.SplitNormHead(11, drop=0.3, nt=3),
                      lambda: th.SplitNormHead(12, 11, 0.3, nt=3)),
    "NormMlpHead": (lambda: jh.NormMlpHead(11, drop=0.3), lambda: th.NormMlpHead(12, 11, 0.3)),
}


@pytest.mark.parametrize("pre_logits", [False, True])
@pytest.mark.parametrize("kind", sorted(_HEAD_KINDS))
def test_head_modules_match_jax(kind, pre_logits):
    """Each head at eval (its dropout idle), logits and pre_logits: Head
    returns its input, NormHead per-token logits without the bias,
    SplitNormHead its summed logits (it has no per-token form), NormMlpHead
    the tanh features."""
    jm, tm = (make() for make in _HEAD_KINDS[kind])
    x = _x(5, 12, seed=4)
    variables = random_variables(init_shapes(jm, jnp.asarray(x)), seed=4)
    with highest():
        ref = jm.apply(variables, jnp.asarray(x), pre_logits=pre_logits)
    load_port(tm, variables, prefix="m")
    with torch.no_grad():
        got = tm(torch.from_numpy(x), pre_logits=pre_logits)
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("pre_logits", [False, True])
@pytest.mark.parametrize("head_fn", ["norm", "split_norm", "norm_mlp", "linear"])
def test_map_head_each_head_fn_matches_jax(head_fn, pre_logits):
    """MAPHead with each head_fn and fc_drop 0.3 (idle at eval), the
    interactive class attention of FasterViT's head with "linear"."""
    feats = [_x(2, hw, hw, c, seed=i) for i, (hw, c) in enumerate(zip(_HW, _CHANNELS))]
    kw = _map_head_kwargs(head_fn=head_fn, fc_drop=0.3, n_tokens=3, last_dim=12, bp_dim=6,
                          gram_group=3, interactive=head_fn == "linear")
    jm = jh.MAPHead(channels=_CHANNELS, non_linearity=jl.gelu, **kw)
    tm = th.MAPHead(channels=_CHANNELS, non_linearity=tl.gelu, **kw)
    jfeats = [jnp.asarray(f) for f in feats]
    variables = random_variables(init_shapes(jm, jfeats, training=False), seed=5)
    with highest():
        ref = jm.apply(variables, jfeats, training=False, pre_logits=pre_logits)
    load_port(tm, variables, prefix="m")
    with torch.no_grad():
        got = tm([torch.from_numpy(f) for f in feats], pre_logits=pre_logits)
    assert len(got) == len(ref) == 2
    for r, g in zip(ref, got):
        assert tuple(g.shape) == tuple(r.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("head_fn", ["norm", "split_norm", "norm_mlp", "linear"])
def test_map_head_fc_drop_goes_where_jax_sends_it(head_fn, monkeypatch):
    """In training with fc_drop 0.5 (and a distill token), the heads that
    apply a dropout of that rate are JAX's: the "norm" and "split_norm" org
    heads and every self-distill and distill head, never a "norm_mlp" (built
    with drop 0) or "linear" org head. Each side's dropouts are recorded by
    the head they sit in."""
    import jax
    from flax import linen as fnn

    jax_heads = set()

    def record(self, x, *a, **k):
        if self.rate == 0.5:
            jax_heads.add(self.scope.path[0])
        return x

    monkeypatch.setattr(fnn.Dropout, "__call__", record)
    feats = [_x(2, hw, hw, c, seed=i) for i, (hw, c) in enumerate(zip(_HW, _CHANNELS))]
    kw = _map_head_kwargs(head_fn=head_fn, fc_drop=0.5, distill_tokens=1)
    jm = jh.MAPHead(channels=_CHANNELS, non_linearity=jl.gelu, **kw)
    jfeats = [jnp.asarray(f) for f in feats]
    # JAX's dropouts are recorded as it traces the training forward
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jfeats, training=True))
    # the routing needs no common weights (and the JAX package's reverse
    # rules leave the distill heads' names as Flax's)
    tm = th.MAPHead(channels=_CHANNELS, non_linearity=tl.gelu, **kw).train()
    port_heads = set()
    for name, mod in tm.named_modules():
        if isinstance(mod, torch.nn.Dropout):
            def hook(m, args, out, name=name):
                if m.training and m.p == 0.5:
                    port_heads.add("_".join(name.split(".")[:2]))
            mod.register_forward_hook(hook)
    out = tm([torch.from_numpy(f) for f in feats])
    assert all(len(o) == 3 for o in out)  # (org, distill, avg) per group
    expect = {f"{h}_{i}" for i in range(2) for h in ("self_dt_heads", "distill_heads")}
    if head_fn in ("norm", "split_norm"):
        expect |= {"heads_0", "heads_1"}
    assert jax_heads == port_heads == expect


_SPLIT_NORM_MODELS = {
    # (JAX module, port module, model name of the reverse rules, input side)
    "convnext": ("imagenet_models_tpu.models.convnext:ConvNeXt",
                 "imagenet_models_tpu_torch.models.convnext:ConvNeXt", "map_convnext_tiny",
                 dict(depths=(1, 1, 1, 1), dims=(8, 8, 16, 16), global_pool="mmcap",
                      last_dim=16, n_groups=2, n_tokens=2, gram_group=2, bp_dim=16, ca_dim=16,
                      num_heads=2), 32),
    "resnet": ("imagenet_models_tpu.models.resnet:MAP_ResNet",
               "imagenet_models_tpu_torch.models.resnet:MAP_ResNet", "map_resnet50",
               dict(nblock=(1, 1, 1, 1), channels=(16, 16, 32, 32), last_dim=32, n_groups=2,
                    n_tokens=2, gram_group=16), 32),
    "maxvit": ("imagenet_models_tpu.models.maxvit:MaxxVit",
               "imagenet_models_tpu_torch.models.maxvit:MaxxVit", "map_maxvit_tiny_tf_224",
               dict(embed_dim=(32, 32, 64, 64), depths=(1, 1, 1, 1), stem_width=16,
                    global_pool="mmcap", last_dim=16, n_groups=2, n_tokens=2, gram_group=2,
                    bp_dim=16, gram_dim=16, ca_dim=16, num_heads=2, drop_rate=0.1), 64),
}


@pytest.mark.parametrize("family", sorted(_SPLIT_NORM_MODELS))
def test_models_build_split_norm_heads_as_jax(family):
    """split_norm=True (and MaxViT's drop_rate, JAX's fc_drop there), which
    raised until the heads were ported: a narrow model's eval logits against
    JAX's on the same weights, its per-token `heads.<i>.norm.<t>` keys
    loading with strict=True; MaxViT's fc dropout sits in its org and
    self-distill heads (models/maxvit.py:272)."""
    import importlib

    import jax

    jpath, tpath, name, kw, side = _SPLIT_NORM_MODELS[family]
    jcls, tcls = (getattr(importlib.import_module(p.split(":")[0]), p.split(":")[1])
                  for p in (jpath, tpath))
    kw = dict(kw, num_classes=7, split_norm=True)
    jm = jcls(**kw)
    tkw = dict(kw, img_size=side) if family == "maxvit" else kw
    x = _x(2, side, side, 3, seed=7)
    variables = random_variables(init_shapes(jm, jnp.asarray(x), training=False), seed=7)
    with highest():
        ref = jax.jit(lambda v, x: jm.apply(v, x, training=False))(variables, jnp.asarray(x))
    tm = load_port(tcls(**tkw), variables, name)
    assert all(isinstance(h, th.SplitNormHead) for h in tm.head.heads)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)
    if family == "maxvit":
        assert {tm.head.heads[0].drop.p, tm.head.self_dt_heads[0].drop.p} == {0.1}

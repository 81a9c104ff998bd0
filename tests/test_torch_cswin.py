"""The port's GA-CSWin against the JAX package: LePEAttention on its three
orientations and both routes, CSWinBlock, the GA class-attention block, a
narrow GA_CSWinTransformer's logits in both modes (at 64 px, where every
stripe takes the stripe route, and at 112 px, where stage 1 takes the
composition, stage 2 the stripe route and stages 3-5 the full window), the
full-width ga_cswin_tiny (parameter count, state_dict), and three LAMB steps of
the narrow model against JAX's `make_train_step`.

Weights: every parameter and BN statistic random from numpy, carried over
with `state_dict_from_jax` and loaded with `strict=True`. fp32 tolerance
1e-4, as tests/test_torch_maxvit.py: both sides compute in fp32 (XLA at
highest precision), so only summation order and conv algorithms differ. In
training both sides run without dropout and with drop-path rate 0; JAX's
stripe attention takes its plain twin on the CPU, the port's its own.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

import imagenet_models_tpu.models  # noqa: F401  (registers the JAX factories)
from imagenet_models_tpu import create_model as jax_create_model
from imagenet_models_tpu.core import registry as jreg
from imagenet_models_tpu.models import ga_cswin as jgc
from imagenet_models_tpu.nn import ga_head as jgh
from imagenet_models_tpu.ops import cswin_attention as jca
from imagenet_models_tpu.train import losses as jloss
from imagenet_models_tpu.train import optim as joptim
from imagenet_models_tpu.train import state as jstate
from imagenet_models_tpu_torch import create_model, default_cfg, list_models
from imagenet_models_tpu_torch.ckpt import convert
from imagenet_models_tpu_torch.models import ga_cswin as tgc
from imagenet_models_tpu_torch.nn import ga_head as tgh
from imagenet_models_tpu_torch.ops import cswin_attention as tca
from imagenet_models_tpu_torch.ops import stripe_attention as tsa
from imagenet_models_tpu_torch.train import losses as tloss
from imagenet_models_tpu_torch.train import optim as toptim
from imagenet_models_tpu_torch.train import state as tstate
from imagenet_models_tpu_torch.ops import convnext_block as tcb
from imagenet_models_tpu_torch.ops import flash_attention as tfa
from torch_parity import (
    grads_match_jax,
    highest,
    init_shapes,
    load_port,
    random_variables,
    switch_on,
)

TOL = dict(rtol=1e-4, atol=1e-4)
NAME = "ga_cswin_tiny"
# a narrow GA-CSWin (tests/test_ckpt_roundtrip.py:57-60): gram_dim a multiple
# of 12 (the gram layer's 6 heads over two half-channel orientations) whose
# triangle (1176 entries) splits into the 8 groups of its projection
NARROW = dict(embed_dim=16, depth=(1, 1, 2, 1), dims=(16, 32, 64, 128),
              num_heads=(2, 2, 4, 4, 4), branches=2, gram_dim=48, stage3_naggre=1,
              num_classes=7)
SPLITS = {64: (1, 2, 2, 2, 2), 112: (1, 2, 7, 7, 7)}


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


def _close(got, ref, tol=TOL):
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **tol)


def _launches():
    return tsa.fused_stripe_attention.launches, tsa.fused_stripe_attention_bwd.launches


def _all_launches():
    return _launches() + (tfa.fused_window_attention.launches, tcb.fused_ln_mlp.launches,
                          tcb.fused_ln_mlp_bwd.launches)


def _switch_on(monkeypatch, *names):
    return switch_on(monkeypatch, names, ((tfa, "window_attention"), (tca, "ln_mlp_apply")))


# ---------------------------------------------------------------- layers

def test_partitions_match_jax():
    x = _x(2, 8, 12, 5)
    for hs, ws in ((8, 2), (2, 12), (8, 12), (4, 3)):
        ref = jca.img2windows(jnp.asarray(x), hs, ws)
        got = tca.img2windows(torch.from_numpy(x), hs, ws)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(tca.windows2img(got, hs, ws, 8, 12).numpy(), x)


# (idx, map side, dim, heads, split): the stripe route (idx 0, h <= 16), the
# composition for idx 0 on a map 20 high, idx 1, and the full window (idx -1)
@pytest.mark.parametrize("idx,side,dim,nh,ws", [(0, 14, 64, 2, 2), (0, 20, 64, 2, 2),
                                                (1, 14, 64, 2, 2), (-1, 7, 96, 3, 7)])
def test_lepe_attention_matches_jax(idx, side, dim, nh, ws):
    q, k, v = (_x(2, side, side, dim, seed=s) for s in (1, 2, 3))
    jm = jca.LePEAttention(dim, nh, idx=idx, split_size=ws)
    args = [jnp.asarray(a) for a in (q, k, v)]
    variables = random_variables(init_shapes(jm, *args), seed=1)
    tm = load_port(tca.LePEAttention(dim, nh, idx, ws), variables, NAME, prefix="attns_0")
    assert (idx == 0 and tsa.use_fused_stripe_attn(q.shape, ws, 0.0, False, head_dim=dim // nh)) == \
        (idx == 0 and side <= 16)
    with highest():
        ref = jm.apply(variables, *args)
    before = _launches()
    _close(tm(*(torch.from_numpy(a) for a in (q, k, v))), ref)
    assert _launches() == before  # CPU: the twin


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("side,ws,last,groups", [(14, 7, False, 1), (8, 2, False, 2),
                                                 (7, 7, True, 1)])
def test_cswin_block_matches_jax(side, ws, last, groups, training, no_jax_dropout):
    """Two orientations (the 14x14 stripe route and an 8x8 map with a
    grouped MLP) and the last-stage full window; in training the fast GELU."""
    x = _x(2, side, side, 64, seed=4)
    jm = jca.CSWinBlock(64, 4, split_size=ws, last_stage=last, mlp_groups=groups)
    variables = random_variables(init_shapes(jm, jnp.asarray(x)), seed=4)
    tm = load_port(tca.CSWinBlock(64, 4, split_size=ws, last_stage=last or side == ws,
                                  mlp_groups=groups), variables, NAME, prefix="stage3_0")
    tm.train(training)
    with highest():
        ref = jax.jit(lambda v, x: jm.apply(v, x, training, rngs={"dropout": jax.random.PRNGKey(0)}))(
            variables, jnp.asarray(x))
    _close(tm(torch.from_numpy(x)), ref)
    with pytest.raises(ValueError, match="last_stage"):
        tca.CSWinBlock(64, 4, split_size=side)(torch.zeros(1, side, side, 64))


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("switch,side,ws,last", [("flash", 14, 7, False), ("flash", 7, 7, True),
                                                 ("tlnmlp", 14, 7, False)])
def test_cswin_block_switches_match_jax(switch, side, ws, last, training, monkeypatch,
                                        no_jax_dropout):
    """CSWinBlock with one switch at "1" on both sides: the output at eval,
    and in training the gradients of the input and every parameter. With
    IMTPU_FLASH_ATTN every orientation takes `window_attention` (kernel 12's
    twin here), the idx=0 stripes of the 14x14 map included, which the
    stripe route takes otherwise; with IMTPU_TLNMLP the norm2 + MLP pair is
    `ln_mlp_apply` (eps 1e-6)."""
    calls = _switch_on(monkeypatch, switch)
    x = _x(2, side, side, 64, seed=24)
    jm = jca.CSWinBlock(64, 4, split_size=ws, last_stage=last)
    variables = random_variables(init_shapes(jm, jnp.asarray(x)), seed=24)
    tm = load_port(tca.CSWinBlock(64, 4, split_size=ws, last_stage=last), variables, NAME,
                   prefix="stage3_0").train(training)
    before = _all_launches()
    if training:
        grads_match_jax(jm, variables, tm, x, NAME, "stage3_0",
                        dict(training=True, rngs={"dropout": jax.random.PRNGKey(0)}), TOL)
    else:
        with highest():
            ref = jm.apply(variables, jnp.asarray(x))
        _close(tm(torch.from_numpy(x)), ref)
    assert _all_launches() == before  # CPU: the twins
    assert calls == ({"window_attention": 1 if last else 2} if switch == "flash"
                     else {"ln_mlp_apply": 1})


def test_switches_off_keep_the_routes(monkeypatch):
    """With both switches at "0" (the default) the new routes are never
    entered, and CSWinBlock computes bit for bit what its older routes'
    pieces compute, the idx=0 stripe route included."""
    assert tfa._FLASH_ATTN == "0" and tcb._TLNMLP == "0"

    def refuse(*a, **k):
        raise AssertionError("a switched-off route ran")

    monkeypatch.setattr(tfa, "window_attention", refuse)
    monkeypatch.setattr(tca, "ln_mlp_apply", refuse)
    x = torch.from_numpy(_x(2, 14, 14, 64, seed=25))
    blk = tca.CSWinBlock(64, 4, split_size=7)
    before = _launches()
    with torch.no_grad():
        for training in (False, True):
            blk.train(training)
            got = blk(x)
            q, k, v = blk.qkv(blk.norm1(x)).split(64, dim=-1)
            a0 = tsa.stripe_attention(q[..., :32], k[..., :32], v[..., :32],
                                      blk.attns[0].get_v.weight.reshape(32, 9).t(),
                                      blk.attns[0].get_v.bias.reshape(1, 32), ws=7, num_heads=2,
                                      scale=16 ** -0.5)
            a1 = blk.attns[1](q[..., 32:], k[..., 32:], v[..., 32:])
            y = x + blk.proj(torch.cat([a0, a1], dim=-1))
            assert torch.equal(got, y + blk.mlp(blk.norm2(y))), training
    assert _launches() == before


@pytest.mark.parametrize("training", [False, True])
def test_class_attention_block_matches_jax(training, no_jax_dropout):
    x, cls = _x(2, 10, 64, seed=5), _x(2, 1, 64, seed=6)
    jm = jgh.LayerScaleBlockClassAttn(64, num_heads=8, mlp_block_groups=2, dim_embed=16)
    variables = random_variables(init_shapes(jm, jnp.asarray(x), jnp.asarray(cls)), seed=5)
    tm = load_port(tgh.LayerScaleBlockClassAttn(64, num_heads=8, mlp_block_groups=2,
                                                dim_embed=16), variables, NAME, prefix="ga_0")
    tm.train(training)
    with highest():
        ref = jm.apply(variables, jnp.asarray(x), jnp.asarray(cls), deterministic=not training)
    _close(tm(torch.from_numpy(x), torch.from_numpy(cls)), ref)


# ---------------------------------------------------------------- models

def _narrow(img, seed):
    kw = dict(NARROW, split_size=SPLITS[img])
    jm = jgc.GA_CSWinTransformer(**kw)
    variables = random_variables(init_shapes(jm, jnp.zeros((1, img, img, 3)), training=False),
                                 seed=seed)
    tm = load_port(tgc.GA_CSWinTransformer(**kw, img_size=img), variables, NAME)
    return jm, variables, tm


def _run(jm, variables, x, training):
    if not training:
        return jax.jit(lambda v, x: jm.apply(v, x, training=False))(variables, jnp.asarray(x))
    fn = jax.jit(lambda v, x: jm.apply(v, x, training=True, mutable=["batch_stats"],
                                       rngs={"dropout": jax.random.PRNGKey(0)}))
    return fn(variables, jnp.asarray(x))


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("img", [64, 112])
def test_narrow_ga_cswin_logits(img, training, no_jax_dropout):
    """The branches' logits in both modes, and in training the BN running
    statistics JAX's forward left. At 112 px the model has all three routes:
    stage 1 (28x28, taller than the gate's 16) the composition, stage 2
    (14x14, stripes of 2) the stripe route, stages 3-5 (7x7 and 4x4, split 7)
    the full window. In training the heads' BatchNorms normalise with the
    statistics of this batch of two, which amplifies summation-order noise,
    so the absolute bound there is 5e-4 (as the MaxViT test's)."""
    tol = dict(rtol=1e-4, atol=5e-4) if training else TOL
    jm, variables, tm = _narrow(img, seed=7)
    x = _x(2, img, img, 3, seed=7)
    with highest():
        ref = _run(jm, variables, x, training)
    got = tm.train(training)(torch.from_numpy(x))
    if training:
        ref, mut = ref
        sd = convert.state_dict_from_jax({"params": variables["params"],
                                          "batch_stats": mut["batch_stats"]}, NAME)
        for k, v in tm.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), sd[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
    assert isinstance(got, tuple) and len(got) == len(ref) == 2
    assert tuple(got[0].shape) == (2, 7)
    _close(got, ref, tol)


@pytest.mark.parametrize("training", [False, True])
def test_narrow_ga_cswin_with_both_switches(training, monkeypatch, no_jax_dropout):
    """IMTPU_FLASH_ATTN and IMTPU_TLNMLP at "1" on both sides: the narrow
    model's logits at 64 px in both modes. Every LePEAttention takes
    `window_attention` (none the stripe route), and every CSWinBlock with an
    ungrouped MLP takes `ln_mlp_apply`. Tolerances as the logits test
    above."""
    calls = _switch_on(monkeypatch, "flash", "tlnmlp")
    tol = dict(rtol=1e-4, atol=5e-4) if training else TOL
    jm, variables, tm = _narrow(64, seed=26)
    x = _x(2, 64, 64, 3, seed=26)
    with highest():
        ref = _run(jm, variables, x, training)
    before = _all_launches()
    got = tm.train(training)(torch.from_numpy(x))
    assert _all_launches() == before
    _close(got, ref[0] if training else ref, tol)
    lepe = sum(isinstance(m, tca.LePEAttention) for m in tm.modules())
    mlps = sum(isinstance(m, tca.CSWinBlock) and m.mlp_groups == 1 for m in tm.modules())
    assert calls == {"window_attention": lepe, "ln_mlp_apply": mlps} and lepe > mlps > 0


def test_ga_cswin_tiny_structure():
    """43.43M params, exactly the JAX model's; the state_dict's keys and
    shapes are the JAX export's, and that export loads with strict=True."""
    model = create_model(NAME, device="cpu")
    shapes = init_shapes(jax_create_model(NAME), jnp.zeros((1, 224, 224, 3)), training=False)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax == 43_431_816
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    exported = convert.export_torch_state_dict(zeros, convert.reverse_translator(NAME))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in exported.items()}
    model.load_state_dict(convert.state_dict_from_jax(zeros, NAME), strict=True)
    assert convert.GA_CSWIN_REVERSE == jgc.GA_CSWIN_REVERSE
    assert {"stage1_conv_embed.10.weight", "stage5.2.attns.1.get_v.weight",
            "gram_layer.4.1.qkv.bias", "gram_contraction.0.1.running_var",
            "gram_embedding.3.0.weight", "ga.2.gamma_1", "fc.4.bias"} <= set(exported)
    assert tuple(exported["stage3.0.attns.0.get_v.weight"].shape) == (128, 1, 3, 3)
    # the stripe route at 224 px: the 21 stage-3 blocks, the stage-5 block
    # and the 5 gram layers, 27 in all (stages 1 and 2 are taller than 16)
    routes = [tsa.use_fused_stripe_attn((1, s, s, 1), ws, 0.0, True, head_dim=32)
              for s, ws, n in ((56, 1, 1), (28, 2, 2), (14, 7, 21), (14, 7, 1), (14, 7, 5))
              for _ in range(n)]
    assert sum(routes) == 27


def test_factories_and_default_cfgs_match_jax():
    names = jreg.list_models("ga_cswin*") + jreg.list_models("ga_CSWin*")
    assert sorted(list_models("ga_cswin*") + list_models("ga_CSWin*")) == sorted(names)
    for n in names:
        assert default_cfg(n) == jreg.default_cfg(n), n
    m = create_model("ga_cswin_base_384", device="cpu", num_classes=3, depth=(1, 1, 1, 1),
                     branches=1)
    assert m.img_size == 384 and m.stage3[0].split_size == 12 and m.stage4[0].last_stage


def test_pre_logits_wrong_size_and_use_chk():
    m = tgc.GA_CSWinTransformer(**NARROW, split_size=SPLITS[64], img_size=64, use_chk=True)
    feats = m(torch.zeros(2, 64, 64, 3), pre_logits=True)
    assert len(feats) == 2 and tuple(feats[0].shape) == (2, 128)
    with pytest.raises(ValueError, match="built for 64"):
        m(torch.zeros(1, 96, 96, 3))
    # use_chk's training step runs (tests/test_torch_checkpointing.py holds
    # it bit-equal to the plain step), and deep_stem=False builds
    # (tests/test_torch_finetune.py holds it to JAX)
    outs = m.train()(torch.zeros(2, 64, 64, 3))
    sum(o.square().mean() for o in outs).backward()
    assert m.stage1[0].qkv.weight.grad is not None
    shallow = tgc.GA_CSWinTransformer(**NARROW, split_size=SPLITS[64], img_size=64,
                                      deep_stem=False)
    assert tuple(shallow(torch.zeros(1, 64, 64, 3))[0].shape) == (1, 7)
    # stage5="bottleneck" builds (tests/test_torch_ga_convnext.py holds it to JAX)
    m5 = tgc.GA_CSWinTransformer(**NARROW, split_size=SPLITS[64], img_size=64, stage5="bottleneck")
    assert "1" not in m5.stage5 and tuple(m5(torch.zeros(1, 64, 64, 3))[0].shape) == (1, 7)


# ---------------------------------------------------------------- the train step

def _zero_grad_leaf(k: str) -> bool:
    """Leaves whose true gradient is zero and which hold rounding noise only,
    which Adam's per-element normalisation turns into steps of O(lr) that
    differ between any two implementations: the grouped projections' biases
    (each feeds a train-mode BatchNorm, which removes any shift), and with
    them those BatchNorms' running means."""
    return k.startswith(("gram_contraction.", "gram_embedding.")) and \
        k.endswith((".0.bias", ".1.running_mean"))


def test_train_trajectory_matches_jax(no_jax_dropout):
    """3 LAMB steps with the benchkit recipe of ga_cswin_tiny
    (imagenet_models_tpu/utils/benchkit.py:36-40: lr 5e-3, wd 0.05, BCE with
    smoothing 0.1 on dense targets, dec_lam -0.8), EMA 0.9 (the recipe's
    0.9999 would leave the shadow within 1e-3 of its start in three steps),
    the narrow model at 64 px, B=4, fp32. The port's stripe attention takes
    its twin with autograd, JAX's its own twin. The tolerances are those of
    the ConvNeXt trajectory test (tests/test_torch_train.py:329-346)."""
    kw = dict(NARROW, split_size=SPLITS[64])
    jm = jgc.GA_CSWinTransformer(**kw)
    variables = random_variables(init_shapes(jm, jnp.zeros((1, 64, 64, 3)), training=False),
                                 seed=8)
    rng = np.random.default_rng(8)
    batches = [(rng.standard_normal((4, 64, 64, 3)).astype(np.float32),
                rng.random((4, 7)).astype(np.float32)) for _ in range(3)]
    opt = dict(learning_rate=5e-3, weight_decay=0.05)
    loss = dict(bce_loss=True, smoothing=0.1, mixup_active=True)

    tx = joptim.create_optimizer("lamb", **opt)
    jst = jstate.create_train_state(jax.tree.map(jnp.asarray, variables), tx, ema_decay=0.9)
    # committed like the step's outputs, so the step compiles once, not twice
    jst = jax.device_put(jst, jax.devices()[0])
    jstep = jstate.make_train_step(jm, tx, jloss.create_loss_fn(**loss), dec_lam=-0.8,
                                   ema_decay=0.9)
    ref_losses = []
    with highest():
        for images, targets in batches:
            jst, m = jstep(jst, jnp.asarray(images), jnp.asarray(targets), jax.random.PRNGKey(0))
            ref_losses.append(float(m["loss"]))

    model = load_port(tgc.GA_CSWinTransformer(**kw, img_size=64), variables, NAME)
    topt = toptim.create_optimizer("lamb", **opt)
    st = tstate.create_train_state(model, topt, ema_decay=0.9, device="cpu")
    step = tstate.make_train_step(model, topt, tloss.create_loss_fn(**loss), dec_lam=-0.8,
                                  ema_decay=0.9)
    before = _launches()
    losses = []
    for images, targets in batches:
        st, m = step(st, torch.from_numpy(images), torch.from_numpy(targets))
        losses.append(m["loss"].item())
        assert np.isfinite(m["grad_norm"].item())
    assert _launches() == before  # CPU: the twin
    for got, ref in zip(losses, ref_losses):
        assert abs(got - ref) <= 1e-3 * abs(ref) + 1e-5, (losses, ref_losses)

    def export(params, stats):
        return convert.state_dict_from_jax({"params": jax.tree.map(np.asarray, params),
                                            "batch_stats": jax.tree.map(np.asarray, stats)}, NAME)

    ref_live, ref_ema = export(jst.params, jst.batch_stats), export(jst.ema_params,
                                                                    jst.ema_batch_stats)
    live, ema = st.model.state_dict(), {**st.ema_params, **st.ema_batch_stats}
    assert set(ref_live) == set(live) and set(ref_ema) == set(ema)
    assert any(k.endswith("running_var") for k in ema) and any(map(_zero_grad_leaf, ema))
    for got, ref in ((live, ref_live), (ema, ref_ema)):
        for k, r in ref.items():
            if _zero_grad_leaf(k):
                continue
            g, r = got[k].numpy(), r.numpy()
            if k.endswith("qkv.bias"):  # the key third: softmax ignores a shift of k
                c = r.shape[0] // 3
                g, r = np.concatenate([g[:c], g[2 * c:]]), np.concatenate([r[:c], r[2 * c:]])
            err = np.abs(g - r).max()
            assert err <= 1e-3 * (np.abs(r).max() + 1), (k, err)

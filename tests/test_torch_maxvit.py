"""The port's MaxViT against the JAX package: the window-attention layer, the
blocks, a narrow model's logits in both modes, the full-width
map_maxvit_tiny_tf_224 (parameter count and logits), and three LAMB steps of a
tiny mmcap MaxViT against JAX's `make_train_step`.

Weights: every parameter and BN statistic random from numpy, carried over
with `state_dict_from_jax` and loaded with `strict=True`. fp32 tolerance
1e-4, as tests/test_torch_convnext.py: both sides compute in fp32 (XLA at
highest precision), so only summation order and conv algorithms differ. In
training mode both sides run without dropout and with drop-path rate 0, so
the forward is deterministic; JAX's attention takes its plain partition twin
there, the port's its own.
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
from imagenet_models_tpu.models import maxvit as jmv
from imagenet_models_tpu.ops import window_attention as jwa
from imagenet_models_tpu.train import losses as jloss
from imagenet_models_tpu.train import optim as joptim
from imagenet_models_tpu.train import state as jstate
from imagenet_models_tpu_torch import create_model, default_cfg, list_models
from imagenet_models_tpu_torch.ckpt import convert
from imagenet_models_tpu_torch.models import maxvit as tmv
from imagenet_models_tpu_torch.ops import partition_attention as tpa
from imagenet_models_tpu_torch.ops import window_attention as twa
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
NAME = "map_maxvit_tiny_tf_224"
# a narrow, shallow MaxViT: heads of 32 channels, one block per stage
TINY = dict(embed_dim=(32, 32, 64, 64), depths=(1, 1, 1, 1), stem_width=16, num_classes=11,
            head_hidden_size=24, last_dim=16, n_groups=2, n_tokens=2, gram_group=2, bp_dim=16,
            gram_dim=16, ca_dim=16, num_heads=2)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


def _no_dropout(module):
    for m in module.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return module


def _run(jm, variables, x, training, **kw):
    """The JAX forward, jitted; in training with the batch statistics updated."""
    if not training:
        return jax.jit(lambda v, x: jm.apply(v, x, training=False, **kw))(variables,
                                                                         jnp.asarray(x))
    fn = jax.jit(lambda v, x: jm.apply(v, x, training=True, mutable=["batch_stats"],
                                       rngs={"dropout": jax.random.PRNGKey(0)}, **kw))
    return fn(variables, jnp.asarray(x))[0]


def _close(got, ref, tol=TOL):
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **tol)


def _switch_on(monkeypatch, *names):
    return switch_on(monkeypatch, names, ((tfa, "window_attention"),
                                          (tfa, "window_attention_heads"),
                                          (tmv, "ln_mlp_apply")))


def _launches():
    return (tfa.fused_window_attention.launches, tfa.fused_window_attention_heads.launches,
            tcb.fused_ln_mlp.launches, tcb.fused_ln_mlp_bwd.launches)


def _grads_match_jax(jm, variables, tm, x, prefix, apply_kw):
    before = _launches()
    grads_match_jax(jm, variables, tm, x, NAME, prefix, apply_kw, TOL)
    assert _launches() == before  # CPU: the twins


# ---------------------------------------------------------------- layers

def test_partitions_rel_pos_and_gate_match_jax():
    x = _x(2, 14, 21, 5)
    for part, rev in (("window_partition", "window_reverse"), ("grid_partition", "grid_reverse")):
        ref = getattr(jwa, part)(jnp.asarray(x), (7, 7))
        got = getattr(twa, part)(torch.from_numpy(x), (7, 7))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(getattr(twa, rev)(got, (7, 7), (14, 21)).numpy(), x)
    np.testing.assert_array_equal(twa._rel_pos_index(7, 5), jwa._rel_pos_index(7, 5))
    for cls in ("RelPosBiasTf", "RelPosBias"):
        jm = getattr(jwa, cls)((7, 5), 3)
        variables = random_variables(init_shapes(jm), seed=1)
        table = variables["params"]["relative_position_bias_table"]
        tm = getattr(twa, cls)((7, 5), 3)
        tm.relative_position_bias_table.data = torch.from_numpy(table)
        np.testing.assert_array_equal(tm().detach().numpy(), np.asarray(jm.apply(variables)))
    # the gate: eval never takes the kernels; training does unless attention
    # dropout is on, the map does not split, or it is a single window
    for shape, drop, det in [((2, 56, 56, 64), 0.0, True), ((2, 56, 56, 64), 0.0, False),
                             ((2, 56, 56, 64), 0.1, False), ((2, 14, 21, 64), 0.0, False),
                             ((2, 15, 14, 64), 0.0, False), ((2, 7, 7, 512), 0.0, False)]:
        for part in ("block", "grid"):
            assert twa.use_fused_partition_attn(shape, (7, 7), part, drop, det) == \
                jwa.use_fused_partition_attn(shape, (7, 7), part, drop, det), (shape, drop, det)


@pytest.mark.parametrize("partition", [None, "block", "grid"])
def test_attention_cl_matches_jax(partition):
    """AttentionCl on a partitioned batch (the composition) and on the
    unpartitioned map through `partition_attention` (both partition types)."""
    jm = jwa.AttentionCl(64, 64, rel_pos_type="bias_tf", window_size=(7, 7),
                         partition=None if partition is None else (partition, (7, 7)))
    x = _x(2, 14, 14, 64, seed=2) if partition else _x(8, 7, 7, 64, seed=2)
    variables = random_variables(init_shapes(jm, jnp.asarray(x)), seed=2)
    tm = load_port(twa.AttentionCl(64, 64, rel_pos_type="bias_tf", window_size=(7, 7)),
                   variables, NAME, prefix="attn")
    with highest():
        ref = jm.apply(variables, jnp.asarray(x))
    got = tm(torch.from_numpy(x), partition=None if partition is None else (partition, (7, 7)))
    _close(got, ref)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("in_chs,out_chs,stride", [(16, 32, 2), (32, 32, 2), (32, 32, 1),
                                                   (16, 32, 1)])
def test_mbconv_block_matches_jax(in_chs, out_chs, stride, training):
    """MBConv with each shortcut: pool + expand, pool alone (stage 0 block 0
    of the real model, in == out), identity, and conv + BN (eps 1e-5). On the
    16 px map the stride-2 depthwise conv pads (0, 1), as flax's SAME does."""
    x = _x(2, 16, 16, in_chs, seed=3)
    jm = jmv.MbConvBlock(out_chs, stride=stride)
    variables = random_variables(init_shapes(jm, jnp.asarray(x)), seed=3)
    tm = load_port(tmv.MbConvBlock(in_chs, out_chs, stride=stride), variables, NAME,
                   prefix="conv")
    tm.train(training)
    with highest():
        ref = _run(jm, variables, x, training)
    _close(tm(torch.from_numpy(x)), ref)
    if training:  # the running statistics moved as JAX's did
        _, mut = jm.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
        sd = load_port(tmv.MbConvBlock(in_chs, out_chs, stride=stride),
                       {"params": variables["params"], "batch_stats": mut["batch_stats"]},
                       NAME, prefix="conv").state_dict()
        for k, v in tm.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), sd[k].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("route", ["composition", "partition"])
@pytest.mark.parametrize("part", ["block", "grid"])
def test_partition_attention_matches_jax(part, route, training, monkeypatch, no_jax_dropout):
    """PartitionAttention on both routes in both modes: the gate picks the
    composition at eval and the partition route in training; each side is
    forced onto the other route through its gate (the JAX package's
    IMTPU_PART_ATTN knob, a monkeypatched gate in the port)."""
    fused = route == "partition"
    if fused != training:
        monkeypatch.setenv("IMTPU_PART_ATTN", "all" if fused else "xla")
        monkeypatch.setattr(twa, "use_fused_partition_attn", lambda *a: fused)
    x = _x(2, 14, 21, 64, seed=4)
    jm = jmv.PartitionAttention(64, part, (7, 7))
    variables = random_variables(init_shapes(jm, jnp.asarray(x)), seed=4)
    tm = load_port(tmv.PartitionAttention(64, part, (7, 7)), variables, NAME,
                   prefix="attn_block").train(training)
    with highest():
        ref = _run(jm, variables, x, training)
    _close(tm(torch.from_numpy(x)), ref)


@pytest.mark.parametrize("rel_pos", ["bias_tf", None])
def test_attention_cl_flash_route_matches_jax(rel_pos, monkeypatch):
    """With IMTPU_FLASH_ATTN at "1" on both sides, AttentionCl on a
    partitioned batch takes the flash route: `window_attention_heads` with
    the rel-pos table (kernel 13's twin here), `window_attention` on the
    flattened heads without one (kernel 12's); eval output and the training
    gradients of the input and every parameter, the rel-pos table's
    included."""
    calls = _switch_on(monkeypatch, "flash")
    jm = jwa.AttentionCl(64, 64, rel_pos_type=rel_pos, window_size=(7, 7))
    x = _x(8, 7, 7, 64, seed=20)
    variables = random_variables(init_shapes(jm, jnp.asarray(x)), seed=20)
    tm = load_port(twa.AttentionCl(64, 64, rel_pos_type=rel_pos, window_size=(7, 7)),
                   variables, NAME, prefix="attn")
    with highest():
        ref = jm.apply(variables, jnp.asarray(x))
    _close(tm(torch.from_numpy(x)), ref)
    _grads_match_jax(jm, variables, tm.train(), x, "attn", dict(deterministic=False))
    assert calls == {"window_attention_heads" if rel_pos else "window_attention": 2}


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("switch", ["flash", "tlnmlp"])
def test_partition_attention_switches_match_jax(switch, training, monkeypatch):
    """PartitionAttention with one switch at "1" on both sides, the output
    and in training the gradients of the input and every parameter. At eval
    on a 14x21 map (the composition's place, so the flash route); in training
    on a single 7x7 window, where the flash route runs in training too (larger
    maps keep the partition route). IMTPU_TLNMLP's norm2 + MLP pair is
    `ln_mlp_apply` on the Mlp's parameters: exact GELU at eval, the fast one
    in training."""
    calls = _switch_on(monkeypatch, switch)
    x = _x(2, 7, 7, 64, seed=21) if training else _x(2, 14, 21, 64, seed=21)
    jm = jmv.PartitionAttention(64, "grid", (7, 7))
    variables = random_variables(init_shapes(jm, jnp.asarray(x)), seed=21)
    tm = load_port(tmv.PartitionAttention(64, "grid", (7, 7)), variables, NAME,
                   prefix="attn_grid")
    if not training:
        before = _launches()
        with highest():
            ref = jm.apply(variables, jnp.asarray(x))
        _close(tm(torch.from_numpy(x)), ref)
        assert _launches() == before
    else:
        _grads_match_jax(jm, variables, tm.train(), x, "attn_grid",
                         dict(training=True, rngs={"dropout": jax.random.PRNGKey(0)}))
    route = "window_attention_heads" if switch == "flash" else "ln_mlp_apply"
    assert calls == {route: 1}


def test_switches_off_keep_the_routes(monkeypatch):
    """With both switches at "0" (the default) the new routes are never
    entered, and AttentionCl and PartitionAttention compute bit for bit what
    their older routes' pieces compute."""
    assert tfa._FLASH_ATTN == "0" and tcb._TLNMLP == "0"

    def refuse(*a, **k):
        raise AssertionError("a switched-off route ran")

    for name in ("window_attention", "window_attention_heads"):
        monkeypatch.setattr(tfa, name, refuse)
    monkeypatch.setattr(tmv, "ln_mlp_apply", refuse)
    x = torch.from_numpy(_x(2, 14, 14, 64, seed=22))
    pa = tmv.PartitionAttention(64, "block", (7, 7))
    torch.nn.init.normal_(pa.attn.rel_pos.relative_position_bias_table)
    with torch.no_grad():
        for training in (False, True):
            pa.train(training)
            got = pa(x)
            n1 = pa.norm1(x)
            if training:  # the partition route
                a = pa.attn(n1, partition=("block", (7, 7)))
            else:  # the composition
                qkv = pa.attn.qkv(twa.window_partition(n1, (7, 7)))
                att = twa.slice_attention(qkv, pa.attn.rel_pos(), pa.attn.num_heads)
                a = twa.window_reverse(pa.attn.proj(att), (7, 7), (14, 14))
            y = x + a
            assert torch.equal(got, y + pa.mlp(pa.norm2(y))), training


# ---------------------------------------------------------------- models

def _tiny(global_pool, seed=0, dtype=None):
    jm = jmv.MaxxVit(**TINY, global_pool=global_pool,
                     dtype=None if dtype is None else jnp.bfloat16)
    variables = random_variables(init_shapes(jm, jnp.zeros((1, 224, 224, 3)), training=False),
                                 seed=seed)
    tm = load_port(tmv.MaxxVit(**TINY, global_pool=global_pool, dtype=dtype), variables, NAME)
    return jm, variables, _no_dropout(tm)


@pytest.mark.parametrize("training", [False, True])
def test_tiny_maxvit_logits_per_head(training, no_jax_dropout):
    """224 px (7x7 windows; stage maps 56, 28, 14, 7): the MAP head's
    per-group logits, (org, avg) pairs in training, and the avg head.

    In training, BatchNorm normalises with the statistics of this batch of
    two, which amplifies summation-order noise: the blocks' outputs agree
    within 1.3e-5 of their largest value, the MAP head's logits within 1.4e-4
    (at |logit| up to 2.2), so the absolute bound there is 5e-4."""
    tol = dict(rtol=1e-4, atol=5e-4) if training else TOL
    x = _x(2, 224, 224, 3, seed=5)
    for pool in ("mmcap", "avg"):
        jm, variables, tm = _tiny(pool, seed=5)
        tm.train(training)
        with highest():
            ref = _run(jm, variables, x, training)
        got = tm(torch.from_numpy(x))
        if pool == "mmcap":
            assert len(got) == len(ref) == 2
            assert all(isinstance(g, tuple) and len(g) == 2 for g in got) == training
        else:
            assert tuple(got.shape) == (2, 11)
        _close(got, ref, tol)


@pytest.mark.parametrize("training", [False, True])
def test_tiny_maxvit_with_both_switches(training, monkeypatch, no_jax_dropout):
    """IMTPU_FLASH_ATTN and IMTPU_TLNMLP at "1" on both sides: the MAP head's
    per-group logits of the narrow model at 224 px. At eval every attention
    takes the flash route (22 of them in the full model); in training only
    the 7x7 stage does, the others the partition route. Every MLP takes the
    LN+MLP. Tolerances as the logits test above."""
    calls = _switch_on(monkeypatch, "flash", "tlnmlp")
    tol = dict(rtol=1e-4, atol=5e-4) if training else TOL
    x = _x(2, 224, 224, 3, seed=23)
    jm, variables, tm = _tiny("mmcap", seed=23)
    tm.train(training)
    before = _launches()
    with highest():
        ref = _run(jm, variables, x, training)
    _close(tm(torch.from_numpy(x)), ref, tol)
    assert _launches() == before
    # 4 blocks of a block and a grid attention; in training only stage 3's take the flash route
    assert calls == {"window_attention_heads": 2 if training else 8, "ln_mlp_apply": 8}


@pytest.mark.parametrize("training,pool", [(False, "mmcap"), (True, "avg")])
def test_tiny_maxvit_bf16_compute(training, pool, no_jax_dropout):
    """dtype=bf16 on both sides: the casts sit at the same places, the eval
    composition's q scale and the training route's scale vector round to bf16
    as JAX's do. bf16 rounds differently in XLA and ATen kernels, so the bound
    is a bf16-level one: 5e-2 of the largest |logit|. Training runs the avg
    head: the MAP head's train-mode BatchNorms over a batch of two amplify
    bf16 noise (its logits measured up to 22% apart while every block's
    output agreed within 2.3%); the fp32 test above holds it in training."""
    jm, variables, tm = _tiny(pool, seed=6, dtype=torch.bfloat16)
    tm.train(training)
    x = _x(2, 224, 224, 3, seed=6)
    ref = _run(jm, variables, x, training)
    got = tm(torch.from_numpy(x))
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert g.dtype == torch.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        assert np.abs(g.detach().float().numpy() - r).max() <= 5e-2 * np.abs(r).max()


def test_map_maxvit_tiny_structure():
    """49.96M params, exactly the JAX model's; the state_dict's keys and
    shapes are the JAX export's, and that export loads with strict=True."""
    model = create_model(NAME, device="cpu")
    jm = jax_create_model(NAME)
    shapes = init_shapes(jm, jnp.zeros((1, 224, 224, 3)), training=False)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax == 49_958_408
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    exported = convert.export_torch_state_dict(zeros, convert.reverse_translator(NAME))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in exported.items()}
    model.load_state_dict(convert.state_dict_from_jax(zeros, NAME), strict=True)
    assert convert.MAXVIT_REVERSE == jmv.MAXVIT_REVERSE


def test_map_maxvit_tiny_logits_64px():
    """Full width at 64 px: 2x2 windows, stage maps 16, 8, 4 and 2."""
    jm = jax_create_model(NAME)
    variables = random_variables(init_shapes(jm, jnp.zeros((1, 64, 64, 3)), training=False),
                                 seed=7)
    x = _x(2, 64, 64, 3, seed=7)
    with highest():
        ref = _run(jm, variables, x, False)
    tm = load_port(create_model(NAME, img_size=64, device="cpu"), variables, NAME)
    got = tm(torch.from_numpy(x))
    assert len(got) == len(ref) == 4 and tuple(got[0].shape) == (2, 1000)
    _close(got, ref)


def test_factories_and_default_cfgs_match_jax():
    names = [n for n in jreg.list_models("*maxvit*")]
    assert list_models("*maxvit*") == sorted(names)
    for n in names:
        assert default_cfg(n) == jreg.default_cfg(n), n
    m = create_model("maxvit_tiny_tf_384", device="cpu", num_classes=3)
    assert m.partition_size == (12, 12)
    assert m.stages[0].blocks[0].attn_grid.attn.rel_pos.relative_position_bias_table.shape == \
        (2, 23, 23)


def test_wrong_input_size_and_grad_checkpointing_raise():
    m = tmv.MaxxVit(**TINY, global_pool="avg", img_size=64, grad_checkpointing=True)
    with pytest.raises(ValueError, match="sized for"):
        m(torch.zeros(1, 96, 96, 3))
    m(torch.zeros(1, 64, 64, 3))  # eval is unaffected
    with pytest.raises(NotImplementedError, match="grad_checkpointing"):
        m.train()(torch.zeros(2, 64, 64, 3))


# ---------------------------------------------------------------- the train step

def test_train_trajectory_matches_jax(no_jax_dropout):
    """3 LAMB steps with the maxvit_tiny recipe (train_with_script.py:24: lr
    8e-3, wd 0.05, BCE with smoothing 0.1, clip 1.0 by norm; dec_lam -0.8,
    no EMA), tiny mmcap MaxViT at 64 px (2x2 windows), B=4, fp32. The port's
    attention takes the partition twin with autograd, JAX's its own twin.

    The tolerances are those of the ConvNeXt trajectory test
    (tests/test_torch_train.py:296)."""
    kw = dict(TINY, global_pool="mmcap")
    jm = jmv.MaxxVit(**kw)
    variables = random_variables(init_shapes(jm, jnp.zeros((1, 64, 64, 3)), training=False),
                                 seed=8)
    rng = np.random.default_rng(8)
    batches = [(rng.standard_normal((4, 64, 64, 3)).astype(np.float32), rng.integers(0, 11, 4))
               for _ in range(3)]
    opt = dict(learning_rate=8e-3, weight_decay=0.05, clip_grad=1.0)
    loss = dict(bce_loss=True, smoothing=0.1)

    tx = joptim.create_optimizer("lamb", **opt)
    jst = jstate.create_train_state(jax.tree.map(jnp.asarray, variables), tx)
    # committed like the step's outputs, so the step compiles once, not twice
    jst = jax.device_put(jst, jax.devices()[0])
    jstep = jstate.make_train_step(jm, tx, jloss.create_loss_fn(**loss), dec_lam=-0.8)
    ref_losses = []
    with highest():
        for images, targets in batches:
            jst, m = jstep(jst, jnp.asarray(images), jnp.asarray(targets), jax.random.PRNGKey(0))
            ref_losses.append(float(m["loss"]))

    model = _no_dropout(load_port(tmv.MaxxVit(**kw, img_size=64), variables, NAME))
    topt = toptim.create_optimizer("lamb", **opt)
    st = tstate.create_train_state(model, topt, device="cpu")
    step = tstate.make_train_step(model, topt, tloss.create_loss_fn(**loss), dec_lam=-0.8)
    before = tpa.fused_partition_attention.launches
    losses = []
    for images, targets in batches:
        st, m = step(st, torch.from_numpy(images), torch.from_numpy(targets))
        losses.append(m["loss"].item())
        assert np.isfinite(m["grad_norm"].item())
    assert tpa.fused_partition_attention.launches == before  # CPU: the twin
    for got, ref in zip(losses, ref_losses):
        assert abs(got - ref) <= 1e-3 * abs(ref) + 1e-5, (losses, ref_losses)

    ref_sd = convert.state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jst.params),
         "batch_stats": jax.tree.map(np.asarray, jst.batch_stats)}, NAME)
    live = st.model.state_dict()
    assert set(ref_sd) == set(live)
    assert any(k.endswith("relative_position_bias_table") for k in ref_sd)
    # the stem conv's bias feeds a train-mode BatchNorm, which removes any
    # shift: its true gradient is 0 and it holds rounding noise, which Adam's
    # per-element normalisation turns into steps of O(lr) (1.6e-3 apart here)
    for k, r in ref_sd.items():
        if k == "stem.conv1.bias":
            continue
        r = r.numpy()
        err = np.abs(live[k].numpy() - r).max()
        assert err <= 1e-3 * (np.abs(r).max() + 1), (k, err)

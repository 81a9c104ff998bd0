"""The port's GA-ConvNeXt against the JAX package: the SE `Bottleneck` in both
modes, a narrow GA_ConvNeXt's logits of every branch (eval and training), the
full-width parameter counts and state_dicts, every factory and alias, three
LAMB steps of the narrow model against JAX's `make_train_step` with the dw
weight-gradient switch at "0" and at "1" (its twin, on the CPU), and
GA-CSWin with `stage5="bottleneck"`.

Weights: every parameter and BN statistic random from numpy, carried over
with `state_dict_from_jax` and loaded with `strict=True`. fp32 tolerance
1e-4, as tests/test_torch_cswin.py: both sides compute in fp32 (XLA at
highest precision), so only summation order and conv algorithms differ. In
training both sides run with drop-path rate 0 (the models have no dropout).
JAX's ConvNeXt blocks take their plain path on the CPU, the port's its twins.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import imagenet_models_tpu.models  # noqa: F401  (registers the JAX factories)
from imagenet_models_tpu import create_model as jax_create_model
from imagenet_models_tpu.core import registry as jreg
from imagenet_models_tpu.models import ga_convnext as jgx
from imagenet_models_tpu.models import ga_cswin as jgc
from imagenet_models_tpu.nn import ga_head as jgh
from imagenet_models_tpu.train import losses as jloss
from imagenet_models_tpu.train import optim as joptim
from imagenet_models_tpu.train import state as jstate
from imagenet_models_tpu_torch import create_model, default_cfg, list_models
from imagenet_models_tpu_torch.ckpt import convert
from imagenet_models_tpu_torch.models import ga_convnext as tgx
from imagenet_models_tpu_torch.models import ga_cswin as tgc
from imagenet_models_tpu_torch.nn import ga_head as tgh
from imagenet_models_tpu_torch.ops import dw_conv as tdc
from imagenet_models_tpu_torch.train import losses as tloss
from imagenet_models_tpu_torch.train import optim as toptim
from imagenet_models_tpu_torch.train import state as tstate
from torch_parity import highest, init_shapes, load_port, random_variables

TOL = dict(rtol=1e-4, atol=1e-4)
NAME = "ga_convnext_tiny"
IMG = 64
# a narrow GA-ConvNeXt at 64 px: stage 2 deeper than 5, so it gives its two
# taps (every 6 // 3 = 2 blocks); a gram dim whose triangle (136 entries) and
# a width that split into the 8 groups of the embedding; 8 heads of 2
NARROW = dict(depths=(1, 1, 6, 1, 1), dims=(16, 32, 48, 64, 64), dim_embed=16, gram_dim=16,
              branches=2, stage3_naggre=2, num_classes=7)
# the kernels' widths: kernels 1 and 2 take C % 16 == 0, C <= 1024
# (csrc/ln_mlp_fwd.cu:340-343, ln_mlp_bwd.cu:713-716); kernel 9 C % 8 == 0
LN_MLP_WIDTH = lambda c: c % 16 == 0 and c <= 1024  # noqa: E731


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, ref, tol=TOL):
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), **tol)


def _run(jm, variables, x, training):
    if not training:
        return jax.jit(lambda v, x: jm.apply(v, x, training=False))(variables, jnp.asarray(x))
    fn = jax.jit(lambda v, x: jm.apply(v, x, training=True, mutable=["batch_stats"],
                                       rngs={"dropout": jax.random.PRNGKey(0)}))
    return fn(variables, jnp.asarray(x))


def _check_stats(tm, variables, mut, name):
    """The BN running statistics the port's training forward left, against
    those JAX's returned."""
    sd = convert.state_dict_from_jax({"params": variables["params"],
                                      "batch_stats": mut["batch_stats"]}, name)
    for k, v in tm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), sd[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def narrow():
    jm = jgx.GA_ConvNeXt(**NARROW)
    variables = random_variables(init_shapes(jm, jnp.zeros((1, IMG, IMG, 3)), training=False),
                                 seed=9)
    return jm, variables


# ---------------------------------------------------------------- layers

@pytest.mark.parametrize("training", [False, True])
def test_bottleneck_matches_jax(training):
    """The SE bottleneck (nn/ga_head.py:132-163) on a 6x6 map: output, and
    in training the running statistics of its four BatchNorms."""
    x = _x(2, 6, 6, 40, seed=3)
    jm = jgh.Bottleneck(planes=16, outplanes=48)
    variables = random_variables(init_shapes(jm, jnp.asarray(x)), seed=3)
    def port_sd(params, stats):  # the model's `stage4` is the torch `stages.4`
        sd = convert.state_dict_from_jax({"params": {"stage4": params},
                                          "batch_stats": {"stage4": stats}}, NAME)
        return {k[len("stages.4."):]: v for k, v in sd.items()}

    tm = tgh.Bottleneck(40, 16, 48)
    tm.load_state_dict(port_sd(variables["params"], variables["batch_stats"]), strict=True)
    assert {"conv2.weight", "se.fc1.bias", "downsample.0.bias", "downsample.1.running_var",
            "bn3.weight"} <= set(tm.state_dict())
    with highest():
        if training:
            ref, mut = jm.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
        else:
            ref = jm.apply(variables, jnp.asarray(x), training=False)
    got = tm.train(training)(torch.from_numpy(x))
    _close(got, ref)
    if training:
        sd = port_sd(variables["params"], mut["batch_stats"])
        for k, v in tm.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), sd[k].numpy(), rtol=1e-4, atol=1e-5,
                                           err_msg=k)


# ---------------------------------------------------------------- models

@pytest.mark.parametrize("training", [False, True])
def test_narrow_ga_convnext_logits(narrow, training):
    """Every branch's logits in both modes, and in training the BN running
    statistics JAX's forward left. In training the heads' BatchNorms
    normalise with the statistics of this batch of two, which amplifies
    summation-order noise, so the absolute bound there is 5e-4 (as in
    tests/test_torch_cswin.py)."""
    jm, variables = narrow
    tol = dict(rtol=1e-4, atol=5e-4) if training else TOL
    tm = load_port(tgx.GA_ConvNeXt(**NARROW), variables, NAME)
    assert len(tm.stages[2].blocks) == 6 and tm.stages[2].interval == 2
    x = _x(2, IMG, IMG, 3, seed=9)
    with highest():
        ref = _run(jm, variables, x, training)
    got = tm.train(training)(torch.from_numpy(x))
    if training:
        ref, mut = ref
        _check_stats(tm, variables, mut, NAME)
    assert isinstance(got, tuple) and len(got) == len(ref) == 2
    assert tuple(got[0].shape) == (2, 7)
    _close(got, ref, tol)


@pytest.mark.parametrize("name,count", [("ga_convnext_tiny_688", 47_821_324),
                                        ("ga_convnext_tiny_768", 54_354_584)])
def test_full_width_structure_matches_jax(name, count):
    """The parameter count equals JAX's exactly (tests/test_model_zoo.py:31:
    47.82 M for _688); the state_dict's keys and shapes are the JAX
    export's, and that export loads with strict=True."""
    model = create_model(name, device="cpu")
    shapes = init_shapes(jax_create_model(name), jnp.zeros((1, 224, 224, 3)), training=False)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax == count
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    exported = convert.export_torch_state_dict(zeros, convert.reverse_translator(name))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in exported.items()}
    model.load_state_dict(convert.state_dict_from_jax(zeros, name), strict=True)
    from imagenet_models_tpu.ckpt import reverse_rules as jrr
    assert convert.GA_CONVNEXT_REVERSE == jrr.GA_CONVNEXT_REVERSE
    assert {"stem.0.weight", "stages.1.downsample.1.weight", "stages.2.blocks.8.mlp.fc1.weight",
            "stages.3.blocks.2.gamma", "stages.4.downsample.0.bias", "stages.4.se.fc2.weight",
            "gram_contraction.4.1.running_var", "gram_layer.3.blocks.0.conv_dw.weight",
            "gram_embedding.0.0.weight", "ga.2.gamma_1", "fc.4.bias"} <= set(exported)


def test_factories_widths_and_default_cfgs_match_jax():
    """Every factory and alias of JAX's registry is the port's, with its
    default cfg, and builds (on the meta device, so no weights are drawn);
    each of its ConvNeXt block widths (backbone and gram layers) is one
    kernels 1, 2 and 9 take, so none raises on the card."""
    names = jreg.list_models("ga_convnext*")
    assert sorted(list_models("ga_convnext*")) == sorted(names) and len(names) == 9
    for n in names:
        assert default_cfg(n) == jreg.default_cfg(n), n
        with torch.device("meta"):
            m = create_model(n, device="meta", num_classes=10, drop_rate=0.1, in_22k=True)
        widths = {blk.conv_dw.weight.shape[0] for stage in list(m.stages[:4]) + list(m.gram_layer)
                  for blk in stage.blocks}
        assert all(LN_MLP_WIDTH(c) and c % 8 == 0 for c in widths), (n, widths)
        assert m.fc[0].weight.device.type == "meta"
    with torch.device("meta"):
        assert create_model("ga_convnext_tiny", device="meta").stages[3].blocks[0].conv_dw \
            .weight.shape[0] == 768
        assert create_model("ga_convnext_base", device="meta").fc[0].in_features == 1024


def test_pre_logits_and_no_layer_scale():
    m = tgx.GA_ConvNeXt(**{**NARROW, "ls_init_value": 0.0})
    assert m.stages[0].blocks[0].gamma is None
    feats = m(torch.zeros(2, IMG, IMG, 3), pre_logits=True)
    assert len(feats) == 2 and tuple(feats[0].shape) == (2, 64)


# ---------------------------------------------------------------- the train step

def _zero_grad_leaf(k: str) -> bool:
    """Leaves whose true gradient is zero and which hold rounding noise only,
    which Adam's per-element normalisation turns into steps of O(lr) that
    differ between any two implementations: the biases of the convs and
    projections that feed a train-mode BatchNorm (which removes any shift),
    and with them those BatchNorms' running means."""
    return k.startswith(("gram_contraction.", "gram_embedding.", "stages.4.downsample.")) and \
        k.endswith((".0.bias", ".1.running_mean"))


OPT = dict(learning_rate=5e-3, weight_decay=0.05)
LOSS = dict(bce_loss=True, smoothing=0.1, mixup_active=True)


@pytest.fixture(scope="module")
def jax_trajectory(narrow):
    """3 LAMB steps of the GA recipe (README.md:51: lr 5e-3, wd 0.05, BCE with
    smoothing 0.1 on dense targets, dec_lam -0.8 over the plain branch
    outputs, tests/test_trajectory.py:427-431), EMA 0.9 (the recipe's 0.9999
    would leave the shadow within 1e-3 of its start in three steps), the
    narrow model at 64 px, B=4, fp32, JAX side."""
    jm, variables = narrow
    rng = np.random.default_rng(10)
    batches = [(rng.standard_normal((4, IMG, IMG, 3)).astype(np.float32),
                rng.random((4, 7)).astype(np.float32)) for _ in range(3)]
    tx = joptim.create_optimizer("lamb", **OPT)
    jst = jstate.create_train_state(jax.tree.map(jnp.asarray, variables), tx, ema_decay=0.9)
    # committed like the step's outputs, so the step compiles once, not twice
    jst = jax.device_put(jst, jax.devices()[0])
    jstep = jstate.make_train_step(jm, tx, jloss.create_loss_fn(**LOSS), dec_lam=-0.8,
                                   ema_decay=0.9)
    losses = []
    with highest():
        for images, targets in batches:
            jst, m = jstep(jst, jnp.asarray(images), jnp.asarray(targets), jax.random.PRNGKey(0))
            losses.append(float(m["loss"]))

    def export(params, stats):
        return convert.state_dict_from_jax({"params": jax.tree.map(np.asarray, params),
                                            "batch_stats": jax.tree.map(np.asarray, stats)}, NAME)

    return (batches, losses, export(jst.params, jst.batch_stats),
            export(jst.ema_params, jst.ema_batch_stats))


@pytest.mark.parametrize("switch", ["0", "1"])
def test_train_trajectory_matches_jax(narrow, jax_trajectory, switch, monkeypatch):
    """The port's three steps from the same weights and batches, with
    IMTPU_DW_WGRAD at "0" (autograd's conv weight gradient) and at "1"
    (`DwConv7Function`, its twin on the CPU): losses within 1e-3 relative,
    every live and EMA parameter within 1e-3 of its scale (the tolerances of
    tests/test_torch_cswin.py)."""
    monkeypatch.setattr(tdc, "_DW_WGRAD", switch)
    _, variables = narrow
    batches, ref_losses, ref_live, ref_ema = jax_trajectory
    model = load_port(tgx.GA_ConvNeXt(**NARROW), variables, NAME)
    topt = toptim.create_optimizer("lamb", **OPT)
    st = tstate.create_train_state(model, topt, ema_decay=0.9, device="cpu")
    step = tstate.make_train_step(model, topt, tloss.create_loss_fn(**LOSS), dec_lam=-0.8,
                                  ema_decay=0.9)
    calls = []
    real = tdc.dw7_wgrad
    monkeypatch.setattr(tdc, "dw7_wgrad", lambda a, b: calls.append(a.shape) or real(a, b))
    losses = []
    for images, targets in batches:
        st, m = step(st, torch.from_numpy(images), torch.from_numpy(targets))
        losses.append(m["loss"].item())
        assert np.isfinite(m["grad_norm"].item())
    # 9 backbone blocks and 2 gram-layer blocks per backward at "1", none at "0"
    assert len(calls) == (3 * 11 if switch == "1" else 0)
    assert tdc.fused_dw7_wgrad.launches == 0   # CPU: the twin
    for got, ref in zip(losses, ref_losses):
        assert abs(got - ref) <= 1e-3 * abs(ref) + 1e-5, (losses, ref_losses)
    live, ema = st.model.state_dict(), {**st.ema_params, **st.ema_batch_stats}
    assert set(ref_live) == set(live) and set(ref_ema) == set(ema)
    assert any(map(_zero_grad_leaf, ema))
    for got, ref in ((live, ref_live), (ema, ref_ema)):
        for k, r in ref.items():
            if _zero_grad_leaf(k):
                continue
            err = np.abs(got[k].numpy() - r.numpy()).max()
            assert err <= 1e-3 * (np.abs(r.numpy()).max() + 1), (k, err)


# ---------------------------------------------------------------- GA-CSWin's bottleneck stage 5

CSWIN_NARROW = dict(embed_dim=16, depth=(1, 1, 2, 1), dims=(16, 32, 64, 128),
                    num_heads=(2, 2, 4, 4, 4), branches=2, gram_dim=48, stage3_naggre=1,
                    num_classes=7, split_size=(1, 2, 2, 2, 2), stage5="bottleneck")


@pytest.mark.parametrize("training", [False, True])
def test_ga_cswin_bottleneck_stage5_matches_jax(training):
    """GA-CSWin with stage5="bottleneck" (models/ga_cswin.py:181-184) at
    narrow width and 64 px: the Bottleneck is `stage5.2.` with its shortcut
    at `downsample.{0,1}`, the JAX export loads with strict=True, and the
    logits (and in training the running statistics) match JAX's."""
    jm = jgc.GA_CSWinTransformer(**CSWIN_NARROW)
    variables = random_variables(init_shapes(jm, jnp.zeros((1, IMG, IMG, 3)), training=False),
                                 seed=11)
    tm = load_port(tgc.GA_CSWinTransformer(**CSWIN_NARROW, img_size=IMG), variables,
                   "ga_cswin_tiny")
    assert {"stage5.2.conv1.weight", "stage5.2.se.fc1.weight", "stage5.2.downsample.0.weight",
            "stage5.2.downsample.1.running_mean"} <= set(tm.state_dict())
    assert not any(k.startswith("stage5.1.") for k in tm.state_dict())
    x = _x(2, IMG, IMG, 3, seed=11)
    with highest():
        ref = _run(jm, variables, x, training)
    got = tm.train(training)(torch.from_numpy(x))
    if training:
        ref, mut = ref
        _check_stats(tm, variables, mut, "ga_cswin_tiny")
    _close(got, ref, dict(rtol=1e-4, atol=5e-4) if training else TOL)

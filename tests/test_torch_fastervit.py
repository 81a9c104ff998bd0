"""The port's FasterViT against the JAX package: the window and carrier-token
helpers, the log-CPB bias, the TokenInitializer, and a narrow FasterViT
(160 px, dim 8, windows of 5) whose HAT stage has carrier tokens (a 10x10 map
of four windows: sr_ratio 2, 2x2 carrier tokens a window, pooled 4x4 by a
stride-2 window of 4 that overlaps) and propagates them in its last block,
with layer scales and the interactive MAP head: eval logits of both heads
and the first step's gradients; a reference-format state_dict (both keys of
the TokenInitializer's conv, the coordinate tables) loading with
`strict=True`; the EMA weights under both of the conv's keys; the full-size factories' parameter counts.

Weights: every parameter and BN statistic random from numpy, carried over
with `state_dict_from_jax` and loaded with `strict=True`. fp32 on both sides
(XLA at highest precision): eval within rtol = atol = 1e-4; training (batch
statistics over a batch of two in the MAP head) within 5e-4, as the other
families. Both sides run without dropout in training.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

import imagenet_models_tpu.models  # noqa: F401  (registers the JAX factories)
from imagenet_models_tpu.ckpt import reverse_rules as jrr
from imagenet_models_tpu.core import registry as jreg
from imagenet_models_tpu.models import fastervit as jfv
from imagenet_models_tpu_torch import default_cfg, list_models
from imagenet_models_tpu_torch.ckpt import convert
from imagenet_models_tpu_torch.core.reinit import reference_init
from imagenet_models_tpu_torch.models import fastervit as tfv
from torch_parity import grads_match_jax, highest, init_shapes, load_port, random_variables

NAME = "map_faster_vit_3_224"
TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN_TOL = dict(rtol=5e-4, atol=5e-4)
SIDE = 160  # stage maps 40, 20, 10 and 5
NARROW = dict(dim=8, in_dim=8, depths=(1, 1, 2, 1), window_size=(5, 5, 5, 5), ct_size=2,
              num_heads=(1, 2, 2, 4), resolution=SIDE, drop_path_rate=0.0, num_classes=11,
              layer_scale=1e-5, layer_scale_conv=1e-5, do_propagation=True)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _no_dropout(module):
    for m in module.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return module


@pytest.fixture(scope="module")
def narrow():
    """The narrow FasterViT of each head: JAX module and random variables."""
    out = {}
    for use_map in (True, False):
        jm = jfv.FasterViT(**NARROW, use_map=use_map)
        shapes = init_shapes(jm, jnp.zeros((1, SIDE, SIDE, 3)), training=False)
        out[use_map] = jm, random_variables(shapes, seed=11 if use_map else 12)
    return out


def _port(variables, use_map=True):
    return load_port(tfv.FasterViT(**NARROW, use_map=use_map), variables, NAME)


def test_window_and_carrier_token_helpers_match_jax():
    x = _x(2, 10, 15, 3)
    got = tfv.window_partition_tokens(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfv.window_partition_tokens(x, 5)))
    np.testing.assert_array_equal(tfv.window_reverse_tokens(got, 5, 10, 15).numpy(), x)
    ct = _x(2, 36, 3, seed=1)
    for fn in ("ct_dewindow", "ct_window"):
        np.testing.assert_array_equal(getattr(tfv, fn)(torch.from_numpy(ct), 6, 2).numpy(),
                                      np.asarray(getattr(jfv, fn)(jnp.asarray(ct), 6, 2)))


@pytest.mark.parametrize("ws,seq", [(7, 53), (5, 25), (4, 16)])
def test_log_cpb_bias_and_its_gradient_match_jax(ws, seq):
    """The (heads, seq, seq) bias, zero-padded at the front for the carrier
    tokens (49 + 4 = 53 at full size), and the gradient of the coordinate
    MLP through the one-hot product that replaces the gather's scatter."""
    jm = jfv.PosEmbMLPSwinv2D(ws, 3, seq)
    variables = random_variables(init_shapes(jm), seed=2)
    tm = load_port(tfv.PosEmbMLPSwinv2D(ws, 3, seq), variables, NAME, prefix="pos_emb_funct")
    g = _x(3, seq, seq, seed=3)
    with highest():
        ref, vjp = jax.vjp(lambda p: jm.apply({"params": p}), variables["params"])
        (gp,) = vjp(jnp.asarray(g))
    got = tm()
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    pad = seq - ws * ws
    assert not got[:, :pad].any() and not got[:, :, :pad].any()
    for k, v in convert.state_dict_from_jax({"params": {"pos_emb_funct": gp}}, NAME).items():
        p = dict(tm.named_parameters())[k[len("pos_emb_funct."):]]
        np.testing.assert_allclose(p.grad.numpy(), v.numpy(), err_msg=k, **TOL)


def test_token_initializer_matches_jax():
    """The depthwise conv and the overlapping 5x5 / stride-3 average pool of
    the full-size stage-2 map (14x14, windows of 7, 2x2 carrier tokens each)."""
    jm = jfv.TokenInitializer(16, 14, 7, ct_size=2)
    x = _x(2, 14, 14, 16, seed=4)
    variables = random_variables(init_shapes(jm, jnp.asarray(x)), seed=4)
    tm = load_port(tfv.TokenInitializer(16, 14, 7, ct_size=2), variables, NAME,
                   prefix="levels_2_global_tokenizer")
    assert tm.to_global_feature.pool.kernel_size == 5 and tm.to_global_feature.pool.stride == 3
    with highest():
        ref = jm.apply(variables, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 16, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_narrow_fastervit_eval_logits(narrow):
    """Both heads at eval: the MAP head's five per-group logits (interactive
    class attention, "linear" heads) and the BN + GAP head's."""
    x = _x(2, SIDE, SIDE, 3, seed=5)
    for use_map in (True, False):
        jm, variables = narrow[use_map]
        with highest():
            ref = jax.jit(lambda v, x: jm.apply(v, x, training=False))(variables, jnp.asarray(x))
        with torch.no_grad():
            got = _port(variables, use_map)(torch.from_numpy(x))
        if use_map:
            assert len(got) == len(ref) == 5 and tuple(got[0].shape) == (2, 11)
        for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_narrow_fastervit_first_step_gradients(narrow, monkeypatch):
    """Training mode (batch statistics, the fast GELU, (org, avg) pairs):
    outputs, the input's and every parameter's gradient against jax.vjp's."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    jm, variables = narrow[True]
    tm = _no_dropout(_port(variables)).train()
    grads_match_jax(jm, variables, tm, _x(2, SIDE, SIDE, 3, seed=6), NAME, "",
                    dict(training=True, mutable=["batch_stats"],
                         rngs={"dropout": jax.random.PRNGKey(0)}), TRAIN_TOL)


def test_training_after_serving_uses_the_cached_tables():
    """The coordinate tables are cached per device, and the first call may
    come under torch.inference_mode (serving): a training step after it
    must still be able to save them for its backward."""
    tfv._log_cpb_tables.cache_clear()
    tfv._grid_coords.cache_clear()
    model = tfv.FasterViT(**NARROW, use_map=False)
    x = torch.from_numpy(_x(2, SIDE, SIDE, 3, seed=8))
    with torch.inference_mode():
        model(x)
    model.train()(x).sum().backward()
    assert model.levels[2].blocks[0].attn.pos_emb_funct.cpb_mlp[0].weight.grad is not None


def test_reference_state_dict_loads(narrow, tmp_path):
    """A reference-format checkpoint: the export writes the TokenInitializer's
    conv under both of its keys, as the reference registers it twice; the
    reference's coordinate tables, bias index and BN step counters are
    dropped on load; the file loads with strict=True and gives the same
    logits as the JAX variables."""
    jm, variables = narrow[True]
    sd = convert.export_torch_state_dict(variables, convert.reverse_translator(NAME))
    alias = "levels.2.global_tokenizer.to_global_feature.pos.weight"
    assert np.array_equal(sd[alias], sd["levels.2.global_tokenizer.pos_embed.weight"])
    model = tfv.FasterViT(**NARROW, use_map=True)
    assert alias in model.state_dict() and set(model.state_dict()) == set(sd)
    ref_sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    ref_sd["levels.2.blocks.0.attn.pos_emb_funct.relative_coords_table"] = torch.zeros(1, 9, 9, 2)
    ref_sd["levels.2.blocks.0.attn.pos_emb_funct.relative_position_index"] = torch.zeros(25, 25)
    ref_sd["levels.2.blocks.0.attn.pos_emb_funct.relative_bias"] = torch.zeros(1, 2, 29, 29)
    ref_sd["levels.2.blocks.0.pos_embed.relative_coords_table"] = torch.zeros(1, 25, 2)
    ref_sd["patch_embed.conv_down.1.num_batches_tracked"] = torch.tensor(3)
    torch.save({"state_dict": ref_sd, "epoch": 1}, tmp_path / "ref.pth.tar")
    model.load_state_dict(convert.state_dict_from_checkpoint(str(tmp_path / "ref.pth.tar")),
                          strict=True)
    x = _x(2, SIDE, SIDE, 3, seed=7)
    with highest():
        ref = jax.jit(lambda v, x: jm.apply(v, x, training=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_ema_weights_cover_the_tokenizer_alias(narrow, tmp_path):
    """The EMA shadow holds the TokenInitializer's conv under its first key
    alone (`named_parameters()`); every EMA read of a train state writes it
    under both. `export_pth_tar(use_ema=True)` of the state and of its saved
    checkpoint, and `resume_checkpoint(module, use_ema=True)`, give the EMA
    conv under both keys and in the loaded module; JAX's loader reads the
    exported file to the same weights."""
    from imagenet_models_tpu.ckpt.pretrained import load_variables_from_torch
    from imagenet_models_tpu_torch.ckpt import saver as tsaver
    from imagenet_models_tpu_torch.train import optim as toptim
    from imagenet_models_tpu_torch.train.state import create_train_state

    _, variables = narrow[True]
    state = create_train_state(_port(variables), toptim.create_optimizer("sgd"), ema_decay=0.9,
                               device="cpu")
    state.ema_params = {k: v * 0.5 + 1 for k, v in state.ema_params.items()}
    first, alias = ("levels.2.global_tokenizer.pos_embed.weight",
                    "levels.2.global_tokenizer.to_global_feature.pos.weight")
    assert tsaver.aliases(state.model) == {alias: first, alias[:-6] + "bias": first[:-6] + "bias"}
    ema = state.ema_params[first]
    assert alias not in state.ema_params and not torch.equal(ema, state.params()[first])
    want = {**state.model.state_dict(), **state.ema_params, **state.ema_batch_stats,
            alias: ema, alias[:-6] + "bias": state.ema_params[first[:-6] + "bias"]}
    saved = str(tmp_path / "state.pt")
    torch.save(tsaver.snapshot(state), saved)
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), variables)
    for source in (state, saved):
        path = str(tmp_path / f"ema-{source is state}.pth.tar")
        tsaver.export_pth_tar(source, path, use_ema=True)
        sd = convert.state_dict_from_checkpoint(path)
        assert set(sd) == set(want)
        for k, v in want.items():
            assert torch.equal(sd[k], v), k
        fresh = tfv.FasterViT(**NARROW, use_map=True)
        fresh.load_state_dict(sd, strict=True)
        assert torch.equal(fresh.levels[2].global_tokenizer.to_global_feature.pos.weight, ema)
        jvars = load_variables_from_torch(NAME, template, path, strict=True)
        back = convert.state_dict_from_jax(jax.tree.map(np.asarray, jvars), NAME)
        for k, v in want.items():
            assert torch.equal(back[k], v), k
    resumed, _ = tsaver.resume_checkpoint(saved, tfv.FasterViT(**NARROW, use_map=True),
                                          use_ema=True)
    assert torch.equal(resumed.levels[2].global_tokenizer.pos_embed.weight, ema)
    assert torch.equal(resumed.state_dict()[alias], ema)


def test_fastervit_factories_match_jax(narrow):
    """Full width (built on the meta device: the count needs no values):
    faster_vit_3_224 159.55 M and map_faster_vit_3_224 187.34 M parameters,
    exactly the JAX models' (tests/test_model_zoo.py:22, :26); the reverse
    rules and alias are JAX's, the data configs too; the layer scales start
    at 1e-5, and `reference_init` (torch's default init of the convs) runs
    on the family."""
    assert convert.FASTERVIT_REVERSE == jfv.FASTERVIT_REVERSE
    assert convert._ALIASES["*faster_vit*"] == jrr._ALIASES["*faster_vit*"]
    names = ["faster_vit_3_224", "map_faster_vit_3_224"]
    assert list_models("*faster_vit*") == sorted(jreg.list_models("*faster_vit*")) == names
    for name, count, golden in zip(names, (159_547_944, 187_338_000), (159.55, 187.34)):
        assert default_cfg(name) == jreg.default_cfg(name)
        with torch.device("meta"):
            model = getattr(tfv, name)()
        assert sum(p.numel() for p in model.parameters()) == count
        assert abs(count / 1e6 - golden) <= 0.01
    model = tfv.FasterViT(**NARROW, use_map=True)
    assert all(getattr(b, f"gamma{i}").eq(1e-5).all() for b in model.levels[2].blocks
               for i in range(1, 5))
    assert model.levels[0].blocks[0].gamma.eq(1e-5).all()
    conv = model.levels[0].blocks[0].conv1
    before = conv.weight.clone()
    reference_init(NAME, model, seed=1)
    bound = 1 / np.sqrt(before[0].numel())
    assert not torch.equal(conv.weight, before) and conv.weight.abs().max() <= bound
    with pytest.raises(ValueError, match="160 px"):
        model(torch.zeros(1, 64, 64, 3))

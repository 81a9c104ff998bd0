"""The port's PiT against the JAX package: the ViT block and a narrow PiT
(64 px, base_dims 8, depth (1, 2, 1)) with the MAP and the GAP head, eval
logits and first-step gradients, at both IMTPU_TLNMLP arms (at "1" every
block's norm2 + MLP is `ln_mlp_apply`: kernel 1 and 2's twin on the CPU);
the full-size factories' parameter counts, reverse rules and data configs.

Weights: every parameter and BN statistic random from numpy, carried over
with `state_dict_from_jax` and loaded with `strict=True`. fp32 on both sides
(XLA at highest precision): eval within rtol = atol = 1e-4, as the other
families; in training the MAP head's BatchNorms normalise over a batch of
two, which amplifies summation-order noise, so gradients are held within
5e-4. Both sides run without dropout in training.
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
from imagenet_models_tpu.models import pit as jpit
from imagenet_models_tpu.nn import vit as jvit
from imagenet_models_tpu_torch import create_model, default_cfg, list_models
from imagenet_models_tpu_torch.ckpt import convert
from imagenet_models_tpu_torch.core.reinit import reference_init
from imagenet_models_tpu_torch.models import pit as tpit
from imagenet_models_tpu_torch.nn import vit as tvit
from imagenet_models_tpu_torch.ops import convnext_block as tcb
from torch_parity import (
    grads_match_jax,
    highest,
    init_shapes,
    load_port,
    random_variables,
    switch_on,
)

NAME = "map_pit_s"
TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN_TOL = dict(rtol=5e-4, atol=5e-4)
NARROW = dict(patch_size=16, stride=8, base_dims=(8, 8, 8), depth=(1, 2, 1), heads=(1, 2, 4),
              num_classes=11, last_dim=24, n_groups=2, n_tokens=2, gram_group=12)
SIDE = 64  # a 7x7 token map, pooled to 4x4 and 2x2


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


def _arm(monkeypatch, tlnmlp):
    """IMTPU_TLNMLP on both sides at "1", or left at "0"; the calls of the
    port's `ln_mlp_apply` counted."""
    return switch_on(monkeypatch, ["tlnmlp"] if tlnmlp else [], ((tvit, "ln_mlp_apply"),))


def _launches():
    return tcb.fused_ln_mlp.launches, tcb.fused_ln_mlp_bwd.launches


@pytest.fixture(scope="module")
def narrow():
    """The narrow PiT of each head, JAX module and random variables."""
    out = {}
    for pool in ("map", "gap"):
        jm = jpit.PoolingTransformer(image_size=SIDE, pool_type=pool, **NARROW)
        shapes = init_shapes(jm, jnp.zeros((1, SIDE, SIDE, 3)), training=False)
        out[pool] = jm, random_variables(shapes, seed=3 if pool == "map" else 4)
    return out


@pytest.mark.parametrize("tlnmlp", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_vit_block_matches_jax(training, tlnmlp, monkeypatch):
    """One ViT block (C = 48, 3 heads), eval output and, in training, the
    gradients of the input and every parameter."""
    calls = _arm(monkeypatch, tlnmlp)
    jm = jvit.ViTBlock(48, num_heads=3)
    x = _x(2, 10, 48, seed=1)
    variables = random_variables(init_shapes(jm, jnp.asarray(x)), seed=1)
    tm = load_port(tvit.ViTBlock(48, 3), variables, NAME, prefix="transformers_0_blocks_0")
    before = _launches()
    if training:
        grads_match_jax(jm, variables, tm.train(), x, NAME, "transformers_0_blocks_0",
                        dict(deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)}), TOL)
    else:
        with highest():
            ref = jm.apply(variables, jnp.asarray(x))
        np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), np.asarray(ref),
                                   **TOL)
    assert _launches() == before  # CPU: the twin
    assert calls == ({"ln_mlp_apply": 1} if tlnmlp else {})


@pytest.mark.parametrize("tlnmlp", [False, True])
def test_narrow_pit_eval_logits(narrow, tlnmlp, monkeypatch):
    """Eval logits of both heads: the MAP head's per-group tuple and the GAP
    head's logits."""
    calls = _arm(monkeypatch, tlnmlp)
    x = _x(2, SIDE, SIDE, 3, seed=5)
    for pool in ("map", "gap"):
        jm, variables = narrow[pool]
        with highest():
            ref = jax.jit(lambda v, x: jm.apply(v, x, training=False))(variables, jnp.asarray(x))
        tm = load_port(tpit.PoolingTransformer(img_size=SIDE, pool_type=pool, **NARROW),
                       variables, NAME)
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
        if pool == "map":
            assert len(got) == len(ref) == 2 and tuple(got[0].shape) == (2, 11)
        for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    assert calls == ({"ln_mlp_apply": 8} if tlnmlp else {})  # 4 blocks, two models


@pytest.mark.parametrize("tlnmlp", [False, True])
def test_narrow_pit_first_step_gradients(narrow, tlnmlp, monkeypatch, no_jax_dropout):
    """Training mode (batch statistics, the fast GELU, (org, avg) pairs): the
    MAP PiT's outputs, the input's and every parameter's gradient against
    jax.vjp's."""
    calls = _arm(monkeypatch, tlnmlp)
    jm, variables = narrow["map"]
    tm = _no_dropout(load_port(tpit.PoolingTransformer(img_size=SIDE, pool_type="map",
                                                       **NARROW), variables, NAME))
    before = _launches()
    grads_match_jax(jm, variables, tm.train(), _x(2, SIDE, SIDE, 3, seed=6), NAME, "",
                    dict(training=True, mutable=["batch_stats"],
                         rngs={"dropout": jax.random.PRNGKey(0)}), TRAIN_TOL)
    assert _launches() == before
    assert calls == ({"ln_mlp_apply": 4} if tlnmlp else {})


def test_pit_factories_match_jax():
    """Full width on the CPU: pit_s and map_pit_s have the JAX models'
    parameter counts (map_pit_s: 36.15 M, tests/test_model_zoo.py:18), the
    reverse rules are JAX's, the data configs too, and `reference_init`
    (torch's default init of every conv and Linear) runs on the family."""
    assert convert.PIT_REVERSE == jrr.PIT_REVERSE
    assert list_models("*pit*") == sorted(jreg.list_models("*pit*")) == ["map_pit_s", "pit_s"]
    for name, count in (("pit_s", 23_252_392), ("map_pit_s", 36_147_424)):
        assert default_cfg(name) == jreg.default_cfg(name)
        model = create_model(name, device="cpu")
        assert sum(p.numel() for p in model.parameters()) == count
        before = model.patch_embed.conv.weight.clone()
        pos = model.pos_embed.detach().clone()
        reference_init(name, model, seed=1)
        bound = 1 / np.sqrt(before[0].numel())
        w = model.patch_embed.conv.weight
        assert not torch.equal(w, before) and w.abs().max() <= bound
        assert torch.equal(model.pos_embed, pos)  # a parameter of its own keeps its init
    assert abs(count / 1e6 - 36.15) <= 0.01
    with pytest.raises(ValueError, match="sized for 224"):
        model(torch.zeros(1, 64, 64, 3))

"""The port's map_convnext_tiny against the JAX package: structure, eval
logits, the serving function and the eval step.

Weights: every parameter and BN statistic random from numpy, carried over
with `state_dict_from_jax`. fp32 tolerance 1e-4: both sides compute in fp32
(XLA at highest precision), so only summation order and conv algorithms
differ, ~1e-7 relative per op; through the blocks and the head that grows to
~1e-6 at the logits (measured up to 5e-6 on the 64 px full-width model), while
a wrong op is off by O(1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import imagenet_models_tpu.models  # noqa: F401  (registers the JAX factories)
from imagenet_models_tpu import create_model as jax_create_model
from imagenet_models_tpu.ckpt.reverse_rules import reverse_translator
from imagenet_models_tpu.ckpt.torch_convert import export_torch_state_dict
from imagenet_models_tpu.models.convnext import ConvNeXt as JConvNeXt
from imagenet_models_tpu.serving import make_serving_fn as jax_serving_fn
from imagenet_models_tpu.train.state import TrainState
from imagenet_models_tpu.train.state import make_eval_step as jax_eval_step
from imagenet_models_tpu_torch import create_model
from imagenet_models_tpu_torch.ckpt import state_dict_from_jax
from imagenet_models_tpu_torch.models.convnext import ConvNeXt
from imagenet_models_tpu_torch.serving import make_serving_fn
from imagenet_models_tpu_torch.train.state import make_eval_step
from torch_parity import highest, init_shapes, load_port, random_variables

TOL = dict(rtol=1e-4, atol=1e-4)
# the tiny MAP ConvNeXt of __graft_entry__.dryrun_multichip
TINY = dict(depths=(1, 1, 1, 1), dims=(8, 8, 16, 16), num_classes=11, global_pool="mmcap",
            last_dim=16, n_groups=2, n_tokens=2, gram_group=2, bp_dim=16, ca_dim=16,
            num_heads=2)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _tiny(seed=0, dtype=None, hw=32):
    jm = JConvNeXt(**TINY, dtype=None if dtype is None else jnp.bfloat16)
    variables = random_variables(init_shapes(jm, jnp.zeros((1, hw, hw, 3)), training=False),
                                 seed=seed)
    tm = load_port(ConvNeXt(**TINY, dtype=dtype), variables)
    return jm, variables, tm


def _apply(jm, variables, x):
    """The JAX eval forward, jitted: one compile instead of one per op."""
    return jax.jit(lambda v, x: jm.apply(v, x, training=False))(variables, jnp.asarray(x))


def _images(b, hw, seed=0):
    return np.random.default_rng(seed).standard_normal((b, hw, hw, 3)).astype(np.float32)


# 40 px gives odd maps (10 -> 5 -> 3), where flax's SAME padding pads the
# stride-2 downsample convs and the pyramid resizes by uneven factors
@pytest.mark.parametrize("hw", [32, 40])
def test_tiny_map_convnext_logits_per_head(hw):
    jm, variables, tm = _tiny(hw=hw)
    x = _images(2, hw)
    with highest():
        ref = _apply(jm, variables, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert len(got) == len(ref) == 2
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_tiny_map_convnext_bf16_compute():
    """dtype=bf16 on both sides: the casts sit at the same places. bf16 rounds
    differently in XLA and ATen kernels, so the bound is a bf16-level one:
    5e-2 of the largest |logit| (about 13 bf16 ulps)."""
    jm, variables, tm = _tiny(seed=1, dtype=torch.bfloat16)
    x = _images(2, 32, seed=1)
    ref = _apply(jm, variables, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for r, g in zip(ref, got):
        assert g.dtype == torch.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        assert np.abs(g.float().numpy() - r).max() <= 5e-2 * np.abs(r).max()


def test_map_convnext_tiny_structure():
    """47.83M params; the state_dict's keys and shapes are the JAX export's,
    and that export loads with strict=True."""
    model = create_model("map_convnext_tiny", device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 47_833_760
    jm = jax_create_model("map_convnext_tiny")
    shapes = init_shapes(jm, jnp.zeros((1, 224, 224, 3)), training=False)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    exported = export_torch_state_dict(zeros, reverse_translator("map_convnext_tiny"))
    port = model.state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(v.shape) for k, v in exported.items()}
    model.load_state_dict(state_dict_from_jax(zeros, "map_convnext_tiny"), strict=True)
    assert model.head.mmcap.mmcap[0].gram_token_extraction.bp_index.numel() == 384 * 385 // 2


def test_map_convnext_tiny_logits_64px():
    jm = jax_create_model("map_convnext_tiny")
    variables = random_variables(init_shapes(jm, jnp.zeros((1, 64, 64, 3)), training=False),
                                 seed=2)
    x = _images(2, 64, seed=2)
    with highest():
        ref = _apply(jm, variables, x)
    tm = load_port(create_model("map_convnext_tiny", device="cpu"), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert len(got) == len(ref) == 4
    for r, g in zip(ref, got):
        assert tuple(g.shape) == (2, 1000)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_serving_fn_matches_jax():
    jm, variables, tm = _tiny(seed=3)
    u8 = np.random.default_rng(3).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    with highest():
        ref = jax.jit(jax_serving_fn(jm, variables))(jnp.asarray(u8), jnp.asarray(MEAN),
                                                     jnp.asarray(STD))
    got = make_serving_fn(tm, MEAN, STD)(torch.from_numpy(u8))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_reference_checkpoint_loads(tmp_path):
    """A reference-format .pth.tar (EMA wrapper, DDP prefix, BN step counters,
    the triu index buffer) loads into the port with strict=True."""
    from imagenet_models_tpu_torch.ckpt import state_dict_from_checkpoint

    _, variables, tm = _tiny(seed=5)
    sd = {f"module.{k}": v.clone() for k, v in tm.state_dict().items()}
    sd["module.head.mmcap.mmcap.0.gram_token_extraction.bp_index"] = torch.arange(3)
    sd["module.head.mmcap.multi_scale.concat_conv.1.num_batches_tracked"] = torch.tensor(7)
    path = tmp_path / "model_best.pth.tar"
    torch.save({"state_dict": {}, "state_dict_ema": sd, "epoch": 3}, path)
    fresh = ConvNeXt(**TINY)
    fresh.load_state_dict(state_dict_from_checkpoint(str(path), use_ema=True), strict=True)
    x = torch.from_numpy(_images(1, 32, seed=5))
    with torch.no_grad():
        for a, b in zip(fresh(x), tm(x)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("tta", [0, 2])
def test_eval_step_matches_jax(tta):
    jm, variables, tm = _tiny(seed=4)
    x = _images(8, 32, seed=4)
    targets = np.random.default_rng(4).integers(0, 11, (8,))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=())
    with highest():
        ref = jax_eval_step(jm, tta=tta)(state, jnp.asarray(x), jnp.asarray(targets))
    got = make_eval_step(tm, tta=tta)(torch.from_numpy(x), torch.from_numpy(targets))
    logits, top1, top5 = (g.numpy() for g in got)
    np.testing.assert_allclose(logits, np.asarray(ref[0]), **TOL)
    np.testing.assert_array_equal(top1, np.asarray(ref[1]))
    np.testing.assert_array_equal(top5, np.asarray(ref[2]))
    assert top1.shape == ((8 // tta,) if tta else (8,))


# ---------------------------------------------------------------- drop_rate and split_norm

def test_convnext_takes_drop_rate_and_refuses_split_norm():
    """train.py passes drop_rate to every model (train.py:369-371): both
    heads build with it. split_norm, which raised until the MAP head's
    SplitNormHead was ported, builds one per group, as JAX's
    (models/convnext.py:143); the avg head ignores it."""
    from imagenet_models_tpu_torch.nn.heads import SplitNormHead

    for name in ("map_convnext_tiny", "convnext_tiny"):
        m = create_model(name, device="cpu", drop_rate=0.1, num_classes=10)
        assert m.drop_rate == 0.1
        split = create_model(name, device="cpu", split_norm=True, num_classes=10)
        if name.startswith("map_"):
            assert all(isinstance(h, SplitNormHead) for h in split.head.heads)
            assert "head.heads.0.norm.1.weight" in split.state_dict()


def test_avg_head_dropout_matches_jax(monkeypatch):
    """A narrow avg-head ConvNeXt in training with drop_rate 0.5: the port
    draws the head's dropout mask from the explicit generator, and JAX's
    nn.Dropout is handed that same mask (models/convnext.py:152); the logits
    then match within the fp32 tolerance. The mmcap head ignores drop_rate,
    as JAX's passes fc_drop=0.0."""
    from flax import linen as fnn

    kw = dict(depths=(1, 1, 1, 1), dims=(8, 8, 16, 16), num_classes=11, global_pool="avg",
              drop_rate=0.5)
    jm = JConvNeXt(**kw)
    x = _images(4, 32, seed=8)
    variables = random_variables(init_shapes(jm, jnp.zeros((1, 32, 32, 3)), training=False),
                                 seed=8)
    tm = load_port(ConvNeXt(**kw), variables, "convnext_tiny").train()
    mask = (torch.rand((4, 16), generator=torch.Generator().manual_seed(3)) < 0.5).numpy()
    assert 0 < mask.sum() < mask.size

    def fixed_mask(self, y, deterministic=None, rng=None):
        assert y.shape == mask.shape and self.rate == 0.5
        return jnp.where(mask, y / 0.5, 0.0)

    monkeypatch.setattr(fnn.Dropout, "__call__", fixed_mask)
    with highest():
        ref = jax.jit(lambda v, x: jm.apply(v, x, training=True,
                                            rngs={"dropout": jax.random.PRNGKey(0)}))(
            variables, jnp.asarray(x))
    got = tm(torch.from_numpy(x), generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    eval_logits = tm.eval()(torch.from_numpy(x))
    assert not np.allclose(got.detach().numpy(), eval_logits.detach().numpy(), atol=1e-3)
    tiny = ConvNeXt(**{**TINY, "drop_rate": 0.5}).train()
    gen = torch.Generator().manual_seed(0)
    out = tiny(torch.zeros(2, 32, 32, 3), generator=gen)
    assert len(out) == 2 and torch.equal(gen.get_state(),
                                         torch.Generator().manual_seed(0).get_state())

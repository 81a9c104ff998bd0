"""The port's fine-tune and load paths against the JAX package: the
fine-tune surgery (`-fp`, `-pt`), the re-resolution of rel-pos tables on
load, logit extraction (`--extract-logits`) and GA-CSWin's 7x7 stem.

Weights: random from numpy, carried over with `state_dict_from_jax` or
written as a reference-format `.pth.tar` by the JAX exporter, which both
packages then load. Tolerances: the surgery and the loaded weights are
compared exactly (both sides run the same numpy operations on the same
file); a re-resolved table within 1e-6 of its largest |value| (a bilinear
resize in fp32 by two libraries, whose interpolation weights round apart by
a few ulps: 1.1e-6 on unit-normal tables, where each is 2.4e-6 from a float64
resize); forward logits within
1e-4, as tests/test_torch_maxvit.py (fp32 on both sides, XLA at highest
precision: only summation order and conv algorithms differ).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import imagenet_models_tpu.models  # noqa: F401  (registers the JAX factories)
from imagenet_models_tpu.ckpt import finetune as jft
from imagenet_models_tpu.ckpt import torch_convert as jtc
from imagenet_models_tpu.ckpt.pretrained import load_variables_from_torch
from imagenet_models_tpu.ckpt.reverse_rules import reverse_translator
from imagenet_models_tpu.core import registry as jreg
from imagenet_models_tpu.models import convnext as jcx
from imagenet_models_tpu.models import ga_convnext as jgx
from imagenet_models_tpu.models import ga_cswin as jgc
from imagenet_models_tpu.models import maxvit as jmv
from imagenet_models_tpu_torch.ckpt import convert, finetune
from imagenet_models_tpu_torch.ckpt.saver import resume_checkpoint
from imagenet_models_tpu_torch.cli import train as cli_train
from imagenet_models_tpu_torch.cli import validate as cli_validate
from imagenet_models_tpu_torch.core import registry as treg
from imagenet_models_tpu_torch.models import convnext as tcx
from imagenet_models_tpu_torch.models import ga_convnext as tgx
from imagenet_models_tpu_torch.models import ga_cswin as tgc
from imagenet_models_tpu_torch.models import maxvit as tmv
from torch_parity import highest, init_shapes, load_port, random_variables

TOL = dict(rtol=1e-4, atol=1e-4)
# the tiny MAP ConvNeXt of tests/test_torch_convnext.py: NormHeads of two tokens
CONVNEXT = dict(depths=(1, 1, 1, 1), dims=(8, 8, 16, 16), global_pool="mmcap", last_dim=16,
                n_groups=2, n_tokens=2, gram_group=2, bp_dim=16, ca_dim=16, num_heads=2)
MAXVIT = dict(embed_dim=(32, 32, 64, 64), depths=(1, 1, 1, 1), stem_width=16, num_classes=11,
              head_hidden_size=24, last_dim=16, n_groups=2, n_tokens=2, gram_group=2, bp_dim=16,
              gram_dim=16, ca_dim=16, num_heads=2)
GA_CONVNEXT = dict(depths=(1, 1, 2, 1, 1), dims=(16, 32, 48, 64, 64), dim_embed=16, gram_dim=16,
                   branches=2, stage3_naggre=1)
CSWIN = dict(embed_dim=16, depth=(1, 1, 2, 1), dims=(16, 32, 64, 128),
             num_heads=(2, 2, 4, 4, 4), branches=2, gram_dim=48, stage3_naggre=1,
             num_classes=7, split_size=(1, 2, 2, 2, 2))


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _save_jax(variables, model_name: str, path) -> str:
    """The JAX variables as a reference `.pth.tar`, through the JAX exporter."""
    sd = jtc.export_torch_state_dict(variables, reverse_translator(model_name))
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()}}, str(path))
    return str(path)


def _assert_state_equal(model, variables, model_name: str):
    want = convert.state_dict_from_jax(variables, model_name)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


# ---------------------------------------------------------------- fine-tuning

@pytest.mark.parametrize("in21k_to_in1k", [True, False])
def test_finetune_surgery_matches_jax(in21k_to_in1k, tmp_path):
    """A 21841-class checkpoint into a 1000-class model: the heads' fc rows
    remapped through a 300-entry class map (row 850 the 21k mean) with -pt,
    or the fc keys dropped (the model's own fc kept) without; every other
    tensor loaded. Every array equals JAX's apply_finetune_checkpoint."""
    name = "map_convnext_tiny"
    src = jcx.ConvNeXt(**CONVNEXT, num_classes=21841)
    src_vars = random_variables(init_shapes(src, jnp.zeros((1, 32, 32, 3)), training=False),
                                seed=1)
    path = _save_jax(src_vars, name, tmp_path / "in21k.pth.tar")
    rng = np.random.default_rng(2)
    in1k = sorted(rng.choice(np.setdiff1d(np.arange(1000), [850]), 300, replace=False))
    in21k = rng.choice(21841, 300, replace=False)
    map_path = tmp_path / "in21k_1k_map.json"
    map_path.write_text(json.dumps({"in1k_idx": [int(i) for i in in1k],
                                    "in21k_idx": [int(i) for i in in21k]}))

    dst = jcx.ConvNeXt(**CONVNEXT, num_classes=1000)
    init = random_variables(init_shapes(dst, jnp.zeros((1, 32, 32, 3)), training=False), seed=3)
    ref, n_ref = jft.apply_finetune_checkpoint(init, name, path, in21k_to_in1k=in21k_to_in1k,
                                               map_path=str(map_path))
    model = load_port(tcx.ConvNeXt(**CONVNEXT, num_classes=1000), init, name)
    model, n_got = finetune.apply_finetune_checkpoint(model, path, in21k_to_in1k=in21k_to_in1k,
                                                      map_path=str(map_path))
    assert n_got == n_ref == 8  # 4 NormHeads (2 heads, 2 self-distill heads) x 2
    _assert_state_equal(model, ref, name)
    fc = model.state_dict()["head.heads.0.head.weight"].numpy()
    kept = convert.state_dict_from_jax(init, name)["head.heads.0.head.weight"].numpy()
    if in21k_to_in1k:
        assert not np.array_equal(fc, kept)
    else:
        np.testing.assert_array_equal(fc, kept)


@pytest.mark.parametrize("in21k_to_in1k", [True, False])
def test_train_entry_fine_tunes(in21k_to_in1k, monkeypatch, capfd, tmp_path):
    """The train entry with -fp (and -pt, --in21k-1k-map) on a narrow MAP
    ConvNeXt: it loads the checkpoint before the train state is built, logs
    JAX's line, and trains."""
    _register(monkeypatch, "map_convnext_narrow", lambda **kw: None,
              lambda **kw: tcx.ConvNeXt(**{**CONVNEXT, **kw}))
    classes = 21841 if in21k_to_in1k else 1000
    src = jcx.ConvNeXt(**CONVNEXT, num_classes=classes)
    src_vars = random_variables(init_shapes(src, jnp.zeros((1, 32, 32, 3)), training=False),
                                seed=4)
    path = _save_jax(src_vars, "map_convnext_tiny", tmp_path / "src.pth.tar")
    map_path = tmp_path / "map.json"
    map_path.write_text(json.dumps({"in1k_idx": list(range(10)), "in21k_idx": list(range(10))}))
    monkeypatch.setenv("IMTPU_PLATFORM", "cpu")
    argv = ["synthetic:8", "--model", "map_convnext_narrow", "--input-size", "3", "32", "32",
            "-b", "2", "--epochs", "1", "--cooldown-epochs", "0", "--max-steps-per-epoch", "1",
            "--bce-loss", "-j", "1", "--output", str(tmp_path / "out"), "-fp", path]
    if in21k_to_in1k:
        argv += ["-pt", "--in21k-1k-map", str(map_path)]
    result = cli_train.main(argv)
    assert result["exit"] == "done"
    said = "remapped" if in21k_to_in1k else "dropped"
    assert f"fine-tuning from {path} (8 fc keys {said})" in capfd.readouterr().err


# ---------------------------------------------------------------- rel-pos re-resolution

@pytest.mark.parametrize("src,dst", [(13, 23), (23, 13), (3, 5), (7, 13), (5, 3)])
@pytest.mark.parametrize("layout", ["tf", "flat"])
def test_rel_pos_table_resize_matches_jax(src, dst, layout):
    """Both layouts, up and down: TF (heads, 2H-1, 2W-1) and
    ((2H-1)*(2W-1), heads), within 1e-6 of the largest |value| of JAX's
    _resize_rel_pos_table."""
    if layout == "tf":
        table, shape = _x(3, src, src, seed=src), (3, dst, dst)
    else:
        table, shape = _x(src * src, 4, seed=src), (dst * dst, 4)
    ref = jtc._resize_rel_pos_table(table, shape, "t")
    got = convert.resize_rel_pos_table(torch.from_numpy(table), shape, "t")
    assert tuple(got.shape) == shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_rel_pos_table_non_square_raises():
    for fn in (lambda t: jtc._resize_rel_pos_table(t, (25, 2), "t"),
               lambda t: convert.resize_rel_pos_table(torch.from_numpy(t), (25, 2), "t")):
        with pytest.raises(ValueError, match="non-square"):
            fn(_x(12, 2))


@pytest.mark.parametrize("global_pool", ["avg", "mmcap"])
def test_maxvit_checkpoint_loads_at_another_size(global_pool, tmp_path):
    """A narrow MaxViT exported at 64 px (2x2 windows, (heads, 3, 3) tables)
    loads strict=True into the same model at 96 px (3x3 windows, (heads, 5,
    5) tables) through the reference-file load (`resume_checkpoint`), and
    the tables equal JAX's re-resolved ones within 1e-6 of their largest
    |value|; every other tensor
    loads as it is, and the eval logits at 96 px match JAX's on the same
    file within 1e-4."""
    name = "map_maxvit_tiny_tf_224" if global_pool == "mmcap" else "maxvit_tiny_tf_224"
    jm = jmv.MaxxVit(**MAXVIT, global_pool=global_pool)
    v64 = random_variables(init_shapes(jm, jnp.zeros((1, 64, 64, 3)), training=False), seed=5)
    path = _save_jax(v64, name, tmp_path / "m64.pth.tar")
    v96 = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                       init_shapes(jm, jnp.zeros((1, 96, 96, 3)), training=False))
    ref_vars = load_variables_from_torch(name, v96, path)

    model = tmv.MaxxVit(**MAXVIT, global_pool=global_pool, img_size=96)
    resume_checkpoint(path, model)
    got, want = model.state_dict(), convert.state_dict_from_jax(ref_vars, name)
    tables = [k for k in want if k.endswith("relative_position_bias_table")]
    assert len(tables) == 8 and all(tuple(got[k].shape[1:]) == (5, 5) for k in tables)
    for k, v in want.items():
        atol = 1e-6 * float(v.abs().max()) if k in tables else 0
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)
    x = _x(2, 96, 96, 3, seed=6)
    with highest():
        ref = jax.jit(lambda v, x: jm.apply(v, x, training=False))(ref_vars, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for r, g in zip(ref if isinstance(ref, tuple) else (ref,),
                    out if isinstance(out, tuple) else (out,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


# ---------------------------------------------------------------- logit extraction

def _register(monkeypatch, name, jax_factory, port_factory):
    monkeypatch.setitem(jreg._REGISTRY, name, jax_factory)
    monkeypatch.setitem(treg._REGISTRY, name, port_factory)


@pytest.mark.parametrize("name,jcls,tcls,cfg,per_token", [
    ("map_convnext_narrow", jcx.ConvNeXt, tcx.ConvNeXt, CONVNEXT, True),
    ("ga_convnext_narrow", jgx.GA_ConvNeXt, tgx.GA_ConvNeXt, GA_CONVNEXT, False)])
def test_extract_logits_matches_jax_validate(name, jcls, tcls, cfg, per_token, monkeypatch,
                                             tmp_path):
    """The validate entries of both packages with --extract-logits on one
    .pth.tar and synthetic:12 at B=8 (the tail batch of 4 padded and masked):
    `logits` within 1e-4 (per-token partials for the NormHead model, the
    heads' logits for GA-ConvNeXt), `per_token` and `head_biases` equal, and
    the `bias::` entries equal under the port's key for JAX's flax path."""
    import validate as jax_validate

    _register(monkeypatch, name, lambda **kw: jcls(**{**cfg, **kw}),
              lambda **kw: tcls(**{**cfg, **kw}))
    jm = jcls(**cfg, num_classes=10)
    variables = random_variables(init_shapes(jm, jnp.zeros((1, 32, 32, 3)), training=False),
                                 seed=7)
    path = _save_jax(variables, name, tmp_path / f"{name}.pth.tar")
    argv = ["synthetic:12", "--model", name, "--img-size", "32", "--num-classes", "10", "-b", "8",
            "-j", "1", "--checkpoint", path]
    monkeypatch.setenv("IMTPU_PLATFORM", "cpu")
    with highest():
        jax_validate.validate_once(jax_validate.parser.parse_args(
            argv + ["--extract-logits", str(tmp_path / "jax.npz")]))
    [res] = cli_validate.main(argv + ["--extract-logits", str(tmp_path / "port.npz")])
    ref, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert bool(got["per_token"]) == bool(ref["per_token"]) == per_token
    shape = (12, 2, 2, 10) if per_token else (12, 2, 10)  # (N, heads[, tokens], classes)
    assert got["logits"].shape == ref["logits"].shape == shape
    np.testing.assert_allclose(got["logits"], ref["logits"], **TOL)
    assert ("head_biases" in got) == ("head_biases" in ref) == per_token
    if per_token:
        np.testing.assert_array_equal(got["head_biases"], ref["head_biases"])
    translate = convert.reverse_translator(name)
    want = {f"bias::{translate(k[len('bias::'):-len('/bias')])}.bias": ref[k]
            for k in ref.files if k.startswith("bias::")}
    assert want and set(want) == {k for k in got.files if k.startswith("bias::")}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert 0.0 <= res["top1"] <= 100.0


def test_logit_extract_boolean_form(monkeypatch, tmp_path):
    """--logit-extract writes output/logit/<model>.npz under the working
    directory, as the JAX CLI does."""
    _register(monkeypatch, "map_convnext_narrow", lambda **kw: None,
              lambda **kw: tcx.ConvNeXt(**{**CONVNEXT, **kw}))
    monkeypatch.setenv("IMTPU_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    cli_validate.main(["synthetic:4", "--model", "map_convnext_narrow", "--img-size", "32",
                       "--num-classes", "10", "-b", "4", "-j", "1", "--logit-extract"])
    data = np.load(tmp_path / "output" / "logit" / "map_convnext_narrow.npz")
    assert data["logits"].shape == (4, 2, 2, 10) and np.isfinite(data["logits"]).all()


# ---------------------------------------------------------------- GA-CSWin's 7x7 stem

@pytest.mark.parametrize("training", [False, True])
def test_ga_cswin_shallow_stem_matches_jax(training, tmp_path):
    """deep_stem=False: one 7x7 stride-4 conv with bias and a LayerNorm, the
    reference's `stage1_conv_embed.0` and `.2`. The JAX export loads
    strict=True and its .pth.tar round-trips into JAX; the logits match
    JAX's in eval and in training (no dropout or drop-path)."""
    name = "ga_cswin_tiny"
    jm = jgc.GA_CSWinTransformer(**CSWIN, deep_stem=False)
    variables = random_variables(init_shapes(jm, jnp.zeros((1, 64, 64, 3)), training=False),
                                 seed=8)
    model = load_port(tgc.GA_CSWinTransformer(**CSWIN, deep_stem=False, img_size=64),
                      variables, name)
    assert {k for k in model.state_dict() if k.startswith("stage1_conv_embed")} == {
        "stage1_conv_embed.0.weight", "stage1_conv_embed.0.bias",
        "stage1_conv_embed.2.weight", "stage1_conv_embed.2.bias"}
    path = tmp_path / "shallow.pth.tar"
    torch.save({"state_dict": model.state_dict()}, str(path))
    back = load_variables_from_torch(name, variables, str(path))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x = _x(2, 64, 64, 3, seed=9)
    with highest():
        if training:
            ref, _ = jax.jit(lambda v, x: jm.apply(v, x, training=True, mutable=["batch_stats"],
                                                   rngs={"dropout": jax.random.PRNGKey(0)}))(
                variables, jnp.asarray(x))
        else:
            ref = jax.jit(lambda v, x: jm.apply(v, x, training=False))(variables, jnp.asarray(x))
    model.train(training)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for r, g in zip(ref, out):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)

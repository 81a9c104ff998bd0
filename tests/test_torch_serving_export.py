"""The port's serving export (`serving.export_serving`, `write_artifact`,
`load_artifact`, `cli/export_serving.py`) against the JAX package's.

The tiny MAP ConvNeXt of tests/test_serving.py, with random weights from
numpy carried to the port by `state_dict_from_jax`: the port's CPU export,
saved and reloaded, against JAX's reloaded artifact (1e-4, the fp32 parity
bound of tests/test_torch_convnext.py: both sides compute in fp32, XLA at
highest precision) and against the port's live serving function (the same
program on the same weights). The CLI's sidecar keys against the JAX
script's. An export on CPU tensors with `use_kernel=True` traces the kernels'
ops through their fake functions, runs no kernel, and reloads in a fresh
interpreter that imports only torch and the op library, where calling it
raises: nothing falls back to a twin.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagenet_models_tpu.models.convnext import ConvNeXt as JConvNeXt
from imagenet_models_tpu.serving import export_serving as jax_export_serving
from imagenet_models_tpu.serving import load_artifact as jax_load_artifact
from imagenet_models_tpu.serving import write_artifact as jax_write_artifact
from imagenet_models_tpu_torch.cli import export_serving as cli_export
from imagenet_models_tpu_torch.models.convnext import ConvNeXt
from imagenet_models_tpu_torch.ops import convnext_block
from imagenet_models_tpu_torch.ops.library import program_ops
from imagenet_models_tpu_torch.serving import (export_serving, load_artifact, make_serving_fn,
                                               write_artifact)
from torch_parity import highest, init_shapes, load_port, random_variables

REPO = Path(__file__).resolve().parent.parent
TINY = dict(depths=(1, 1, 1, 1), dims=(8, 8, 16, 16), num_classes=13, global_pool="mmcap",
            last_dim=16, n_groups=2, n_tokens=2, gram_group=2, bp_dim=16, ca_dim=16, num_heads=2)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
B, HW = 2, 32
# the JAX script's sidecar keys, with the port's two renamed and its op list
JAX_SIDECAR = {"model", "batch_size", "input", "output", "img_size", "crop_pct", "crop_mode",
               "interpolation", "mean", "std", "normalization", "platforms", "jax_version"}
PORT_SIDECAR = JAX_SIDECAR - {"platforms", "jax_version"} | {"device", "torch_version", "ops"}


@pytest.fixture(scope="module")
def tiny():
    """The JAX module, its random variables, and the port's module on them."""
    jm = JConvNeXt(**TINY)
    variables = random_variables(init_shapes(jm, jnp.zeros((1, HW, HW, 3)), training=False),
                                 seed=5)
    return jm, variables, load_port(ConvNeXt(**TINY), variables)


def _u8(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, HW, HW, 3), dtype=np.uint8)


def test_cpu_export_matches_jax_artifact_and_live_fn(tiny, tmp_path):
    jm, variables, tm = tiny
    jpath = str(tmp_path / "tiny.stablehlo")
    with highest():
        jexp = jax_export_serving(jm, jax.tree.map(jnp.asarray, variables), batch_size=B,
                                  img_size=HW, mean=MEAN, std=STD)
    jax_write_artifact(jexp, jpath, {"model": "tiny"})
    path = str(tmp_path / "tiny.pt2")
    exported = export_serving(tm, B, HW, MEAN, STD)
    assert program_ops(exported) == []  # the CPU export takes the twins: aten ops only
    write_artifact(exported, path, {"model": "tiny", "img_size": HW})
    program, sidecar = load_artifact(path)
    assert sidecar == {"model": "tiny", "img_size": HW}

    u8 = _u8()
    with highest():
        ref = np.asarray(jax_load_artifact(jpath)[0].call(jnp.asarray(u8)))
    with torch.inference_mode():
        got = program.module()(torch.from_numpy(u8))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 13)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    live = make_serving_fn(tm, MEAN, STD)(torch.from_numpy(u8))
    np.testing.assert_allclose(got.numpy(), live.numpy(), rtol=1e-4, atol=1e-5)


def test_cli_sidecar_keys_and_selftest(tmp_path):
    out = tmp_path / "mb.pt2"
    result = cli_export.main(["--model", "map_mobilenet_v1", "--img-size", "64", "-b", "2",
                              "--selftest", "--device", "cpu", "--output", str(out)])
    sidecar = json.loads((tmp_path / "mb.pt2.json").read_text())
    assert set(sidecar) == PORT_SIDECAR
    assert sidecar["device"] == "cpu" and sidecar["ops"] == []
    assert sidecar["torch_version"] == torch.__version__
    assert sidecar["input"] == "uint8[2,64,64,3] NHWC"
    assert result["selftest_max_abs_err"] < cli_export.SELFTEST_ATOL


_CHILD = r"""
import json, sys
import torch
from imagenet_models_tpu_torch.serving import load_artifact
from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp

program, sidecar = load_artifact(sys.argv[1])
layers = {f"imagenet_models_tpu_torch.nn.{m}" for m in ("layers", "heads", "ga_head", "vit")}
loaded = sorted(m for m in sys.modules if m.startswith("imagenet_models_tpu_torch.models")
                or m in layers or m.split(".")[0] in ("jax", "flax"))
try:
    with torch.inference_mode():
        program.module()(torch.zeros(2, 32, 32, 3, dtype=torch.uint8))
    raised = ""
except Exception as e:
    raised = f"{type(e).__name__}: {e}"
print(json.dumps({"loaded": loaded, "raised": raised, "launches": fused_ln_mlp.launches}))
"""


def test_kernel_export_traces_the_ops_and_refuses_the_cpu(tiny, tmp_path):
    _, _, tm = tiny
    before = convnext_block.fused_ln_mlp.launches
    exported = export_serving(tm, B, HW, MEAN, STD, use_kernel=True)
    assert convnext_block.fused_ln_mlp.launches == before  # traced by the fake, not run
    nodes = [n for n in exported.graph.nodes if n.op == "call_function"
             and n.target == torch.ops.imtpu.ln_mlp_fwd.default]
    assert len(nodes) == sum(TINY["depths"])  # one per block
    assert program_ops(exported) == ["imtpu::ln_mlp_fwd"]
    path = str(tmp_path / "kernels.pt2")
    write_artifact(exported, path, {})
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _CHILD, path], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []  # no model code, no layers, no JAX
    assert out["raised"].startswith("ValueError") and "CUDA" in out["raised"]
    assert out["launches"] == 0

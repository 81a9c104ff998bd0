"""The port imports and runs on a CPU-only host without JAX, Triton or a
kernel build, and imports nothing of the JAX package: checked in a fresh
interpreter, since this test process already holds jax."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import torch
import imagenet_models_tpu_torch
from imagenet_models_tpu_torch import create_model
from imagenet_models_tpu_torch.ops import _kernels
from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp, fused_ln_mlp_bwd
from imagenet_models_tpu_torch.serving import make_serving_fn

modules = sorted(m.name for m in pkgutil.walk_packages(imagenet_models_tpu_torch.__path__,
                                                       "imagenet_models_tpu_torch."))
for name in modules:
    importlib.import_module(name)
after_import = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "flax", "imagenet_models_tpu", "triton"))
model = create_model("map_convnext_tiny", num_classes=10, device="cpu")
logits = make_serving_fn(model)(torch.zeros(1, 64, 64, 3, dtype=torch.uint8))
print(json.dumps({
    "modules": modules,
    "after_import": after_import,
    "after_forward": sorted(m for m in ("jax", "flax", "triton", "imagenet_models_tpu")
                            if m in sys.modules),
    "library_loaded": _kernels.ln_mlp_fwd_library.cache_info().currsize
                      + _kernels.ln_mlp_bwd_library.cache_info().currsize,
    "launches": fused_ln_mlp.launches + fused_ln_mlp_bwd.launches,
    "shape": list(logits.shape),
    "finite": bool(torch.isfinite(logits).all()),
}))
"""


def test_port_imports_without_jax_and_serves_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("imagenet_models_tpu_torch.ckpt.convert", "imagenet_models_tpu_torch.train.losses",
                 "imagenet_models_tpu_torch.train.optim", "imagenet_models_tpu_torch.train.scheduler",
                 "imagenet_models_tpu_torch.train.state", "imagenet_models_tpu_torch.ops.batch_norm",
                 "imagenet_models_tpu_torch.models.resnet", "imagenet_models_tpu_torch.models.mobilenet",
                 "imagenet_models_tpu_torch.ops.dw_conv",
                 "imagenet_models_tpu_torch.models.ga_convnext",
                 "imagenet_models_tpu_torch.ops.flash_attention",
                 "imagenet_models_tpu_torch.ops.convnext_branch"):
        assert name in out["modules"]
    assert out["after_import"] == []   # every module, the converter included
    assert out["after_forward"] == []
    assert out["library_loaded"] == 0  # nothing built or loaded for CPU tensors
    assert out["launches"] == 0        # every block went to the twin
    assert out["shape"] == [1, 10] and out["finite"]


def test_create_model_defaults_to_the_gpu():
    from imagenet_models_tpu_torch import create_model

    if torch.cuda.is_available():
        model = create_model("convnext_tiny", num_classes=10)
        assert next(model.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_model("convnext_tiny", num_classes=10)

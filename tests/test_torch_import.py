"""The port imports and runs on a CPU-only host without JAX, Triton or a
kernel build: checked in a fresh interpreter, since this test process already
holds jax."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import json, sys
import torch
import imagenet_models_tpu_torch
from imagenet_models_tpu_torch import create_model
from imagenet_models_tpu_torch.ops import _kernels
from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp
from imagenet_models_tpu_torch.serving import make_serving_fn

model = create_model("map_convnext_tiny", num_classes=10)
after_create = sorted(m for m in ("jax", "flax", "triton") if m in sys.modules)
logits = make_serving_fn(model)(torch.zeros(1, 64, 64, 3, dtype=torch.uint8))
print(json.dumps({
    "after_create": after_create,
    "after_forward": sorted(m for m in ("jax", "flax", "triton", "imagenet_models_tpu")
                            if m in sys.modules),
    "library_loaded": _kernels.ln_mlp_fwd_library.cache_info().currsize,
    "launches": fused_ln_mlp.launches,
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
    assert out["after_create"] == []
    assert out["after_forward"] == []   # not even the JAX package's host modules
    assert out["library_loaded"] == 0   # nothing built or loaded for CPU tensors
    assert out["launches"] == 0         # every block went to the twin
    assert out["shape"] == [1, 10] and out["finite"]

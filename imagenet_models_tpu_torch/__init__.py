"""imagenet_models_tpu_torch — the PyTorch/CUDA port of imagenet_models_tpu.

The layout mirrors the JAX package (`core/`, `nn/`, `ops/`, `models/`,
`ckpt/`, `serving.py`, `train/state.py`), so each module has a counterpart
there. The JAX package is the reference that this one is tested against; this
package imports `torch` and never `jax` or `flax`.

Hot kernels are written by hand for Hopper (`csrc/`) and built at first use on
a machine with `nvcc`. On CPU tensors every kernel wrapper runs its plain
PyTorch twin instead, so the package imports and runs on a CPU-only host.
"""

__version__ = "0.1.0"

from imagenet_models_tpu_torch.core.registry import (  # noqa: F401
    create_model,
    default_cfg,
    list_models,
    register_model,
)
from imagenet_models_tpu_torch import models  # noqa: F401,E402  (registers the factories)

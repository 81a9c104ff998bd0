"""imagenet_models_tpu_torch — the PyTorch/CUDA port of imagenet_models_tpu.

The layout mirrors the JAX package (`core/`, `nn/`, `ops/`, `models/`,
`ckpt/`, `serving.py`, `train/`), so each module has a counterpart there. The
JAX package is the reference that this one is tested against; this package
imports `torch` and never `jax`, `flax` or anything of `imagenet_models_tpu`.

Hot kernels are written by hand for Hopper (`csrc/`) and built at first use on
a machine with `nvcc`. On CPU tensors every kernel wrapper runs its plain
PyTorch twin instead, so the package imports and runs on a CPU-only host.

Importing the package imports no model: the registry imports `models`
(which registers the factories) when it is first asked for one, so a serving
host that imports only the kernels' custom ops (`serving.load_artifact`)
loads no model code.
"""

__version__ = "0.1.0"

from imagenet_models_tpu_torch.core.registry import (  # noqa: F401,E402
    create_model,
    default_cfg,
    list_models,
    register_model,
)

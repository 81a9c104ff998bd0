"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX side runs on the CPU at highest matmul precision; weights and inputs
come from `numpy.random.default_rng(seed)` and reach the port through
`imagenet_models_tpu_torch.ckpt.state_dict_from_jax`, the one bridge.
Every parameter and BN statistic is randomized: init values such as a 1e-6
layer scale or BN mean 0 / var 1 would hide whole blocks from a comparison.
"""

import numpy as np

import jax

from imagenet_models_tpu.ckpt.torch_convert import flatten_dict, unflatten_dict
from imagenet_models_tpu_torch.ckpt.convert import state_dict_from_jax


def init_shapes(module, *args, **kwargs):
    """The module's variable shapes, without running its init."""
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))


def random_variables(shapes, seed: int = 0):
    """Random values for every leaf of `shapes`: kernels N(0, 1/fan_in), norm
    scales 1 + 0.1 N, BN variances U(0.5, 1.5), everything else 0.1 N."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if path.endswith("kernel"):
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.standard_normal(s.shape) / np.sqrt(fan_in)
        if path.endswith("var"):
            return 0.5 + rng.random(s.shape)
        if path.endswith("scale"):
            return 1.0 + 0.1 * rng.standard_normal(s.shape)
        return 0.1 * rng.standard_normal(s.shape)

    return {col: unflatten_dict({p: leaf(p, s).astype(np.float32)
                                 for p, s in flatten_dict(tree).items()})
            for col, tree in shapes.items()}


def load_port(module, variables, model_name: str = "map_convnext_tiny", prefix: str = ""):
    """Load JAX `variables` into the port `module` with strict=True; return it
    in eval mode.

    With `prefix`, the variables belong to a standalone JAX module: they are
    nested under `prefix` so the exporter sees named paths, and the prefix is
    stripped again from the torch keys."""
    if prefix:
        variables = {col: {prefix: tree} for col, tree in variables.items()}
    sd = state_dict_from_jax(variables, model_name)
    if prefix:
        sd = {k[len(prefix) + 1:]: v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def highest():
    return jax.default_matmul_precision("highest")

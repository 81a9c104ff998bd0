"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX side runs on the CPU at highest matmul precision; weights and inputs
come from `numpy.random.default_rng(seed)` and reach the port through
`imagenet_models_tpu_torch.ckpt.state_dict_from_jax`, the one bridge.
Every parameter and BN statistic is randomized: init values such as a 1e-6
layer scale or BN mean 0 / var 1 would hide whole blocks from a comparison.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from imagenet_models_tpu.ckpt.torch_convert import flatten_dict, unflatten_dict
from imagenet_models_tpu_torch.ckpt.convert import state_dict_from_jax
from imagenet_models_tpu_torch.ops import convnext_block, flash_attention

# the JAX package's opt-in routes and the port's switches for them: JAX reads
# its gates from the environment when it traces, the port from a module
# attribute read once at import
SWITCHES = {"flash": ("IMTPU_FLASH_ATTN", flash_attention, "_FLASH_ATTN"),
            "tlnmlp": ("IMTPU_TLNMLP", convnext_block, "_TLNMLP")}


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


def switch_on(monkeypatch, names, routes=()):
    """Sets the named switches to "1" on both sides, and counts the calls of
    each (module, function name) in `routes`: in fp32 a switched route
    computes what the route it replaces does, so only the counts show that it
    ran. Returns the counts by function name."""
    for name in names:
        env, module, attr = SWITCHES[name]
        monkeypatch.setenv(env, "1")
        monkeypatch.setattr(module, attr, "1")
    calls = {}
    for module, fn in routes:
        def counted(*a, _f=getattr(module, fn), _n=fn, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(module, fn, counted)
    return calls


def grads_match_jax(jm, variables, tm, x, model_name: str, prefix: str, apply_kw, tol):
    """The output, d(out . g)/dx and every parameter's gradient of the port
    module `tm` (in its current mode) against JAX's `jm` applied with
    `apply_kw`, on the numpy input `x` and a numpy cotangent g, in fp32."""
    def fwd(params, x):
        return jm.apply({**variables, "params": params}, x, **apply_kw)

    shape = jax.eval_shape(fwd, variables["params"], jnp.asarray(x)).shape
    g = np.random.default_rng(99).standard_normal(shape).astype(np.float32)

    @jax.jit
    def out_and_grads(params, x):
        out, vjp = jax.vjp(fwd, params, x)
        return (out,) + vjp(jnp.asarray(g))

    with highest():
        ref, gp, gx = out_and_grads(variables["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    # the parameter gradients carried to the port's keys by the weights
    # bridge (its transposes and reshapes are linear), as `load_port` does
    grads = state_dict_from_jax({"params": {prefix: jax.tree.map(np.asarray, gp)}}, model_name)
    grads = {k[len(prefix) + 1:]: v for k, v in grads.items()}
    named = dict(tm.named_parameters())
    assert set(named) == set(grads)
    for k, p in named.items():
        assert p.grad is not None, k
        np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(), err_msg=k, **tol)

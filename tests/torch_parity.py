"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX side runs on the CPU at highest matmul precision; weights and inputs
come from `numpy.random.default_rng(seed)` and reach the port through
`imagenet_models_tpu_torch.ckpt.state_dict_from_jax`, the one bridge.
Every parameter and BN statistic is randomized: init values such as a 1e-6
layer scale or BN mean 0 / var 1 would hide whole blocks from a comparison.
"""

import os
import socket

import numpy as np
import torch

import jax
import jax.numpy as jnp

from imagenet_models_tpu.ckpt.torch_convert import flatten_dict, unflatten_dict
from imagenet_models_tpu_torch.ckpt.convert import state_dict_from_jax
from imagenet_models_tpu_torch.ops import convnext_block, flash_attention

# Under pytest-xdist each worker process would run os.cpu_count() intra-op
# threads of its own, and the workers together oversubscribe the cores many
# times over (on an 8-core host with six busy workers, a train step of
# mobilenet_v1 at 64 px took 4.5 s so, and 0.13 s on one thread): the
# workers share the cores instead. Every worker imports this module while it
# collects, so all of them set the same count.
_XDIST_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _XDIST_WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _XDIST_WORKERS))

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


def _flat_jax(out):
    """A model's tuple of (tuples of) logits as one (B, -1) array."""
    if isinstance(out, (tuple, list)):
        return jnp.concatenate([o.reshape(o.shape[0], -1) for o in jax.tree.leaves(out)], -1)
    return out


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return [out]


def _flat_torch(out):
    """`_flat_jax` of the port's outputs, in the same (depth-first) order."""
    if isinstance(out, (tuple, list)):
        return torch.cat([o.reshape(o.shape[0], -1) for o in _leaves(out)], -1)
    return out


def grads_match_jax(jm, variables, tm, x, model_name: str, prefix: str, apply_kw, tol):
    """The output, d(out . g)/dx and every parameter's gradient of the port
    module `tm` (in its current mode) against JAX's `jm` applied with
    `apply_kw`, on the numpy input `x` and a numpy cotangent g, in fp32. A
    tuple of outputs (a MAP head's logits) is compared as one (B, -1) array;
    with `mutable` in `apply_kw` JAX's updated collections are dropped. An
    empty `prefix`: `jm` is a whole model, not a submodule."""
    def fwd(params, x):
        out = jm.apply({**variables, "params": params}, x, **apply_kw)
        return _flat_jax(out[0] if "mutable" in apply_kw else out)

    shape = jax.eval_shape(fwd, variables["params"], jnp.asarray(x)).shape
    g = np.random.default_rng(99).standard_normal(shape).astype(np.float32)

    @jax.jit
    def out_and_grads(params, x):
        out, vjp = jax.vjp(fwd, params, x)
        return (out,) + vjp(jnp.asarray(g))

    with highest():
        ref, gp, gx = out_and_grads(variables["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = _flat_torch(tm(xt))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    # the parameter gradients carried to the port's keys by the weights
    # bridge (its transposes and reshapes are linear), as `load_port` does
    gp = jax.tree.map(np.asarray, gp)
    grads = state_dict_from_jax({"params": {prefix: gp} if prefix else gp}, model_name)
    if prefix:
        grads = {k[len(prefix) + 1:]: v for k, v in grads.items()}
    named = dict(tm.named_parameters())
    # every parameter's keys, a module registered under two names
    # (FasterViT's TokenInitializer conv) under both, as the export writes it
    keys = {k for k, v in tm.state_dict(keep_vars=True).items() if isinstance(v, torch.nn.Parameter)}
    assert set(grads) == keys
    for k, p in named.items():
        assert p.grad is not None, k
        np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(), err_msg=k, **tol)


def free_port() -> int:
    """A TCP port of localhost that no process listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(workdir, tasks, world: int = 2) -> dict:
    """Run `tasks` (names of entries of workdir/inputs.pt) on `world` gloo
    ranks of tests/_torch_dp_child.py, spawned by torch.multiprocessing;
    their results by task, a list over the ranks."""
    import _torch_dp_child

    torch.multiprocessing.spawn(_torch_dp_child.main,
                                args=(world, free_port(), str(workdir), list(tasks)),
                                nprocs=world, join=True)
    return {t: [torch.load(workdir / f"{t}.{r}.pt", weights_only=False) for r in range(world)]
            for t in tasks}

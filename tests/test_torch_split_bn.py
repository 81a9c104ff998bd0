"""The port's split-BN (--split-bn) and synchronised BatchNorm statistics
against the JAX package's `set_bn_splits` / `BatchNorm` (nn/layers.py:110-250).

Rows are interleaved sample-major, split j = rows j mod s. Per split: the
training output, the gradients of the input and the affine, and the running
statistics, which only split 0 feeds; eval ignores the splits; a batch that
does not divide falls back to whole-batch statistics with one warning. With
synchronised statistics over two gloo ranks (tests/_torch_dp_child.py), the
same against JAX's `axis_name` BatchNorm under shard_map on two virtual CPU
devices, and against the port's one process on the whole batch. The JAX
global is set and reset in try/finally.

Tolerances: fp32 on both sides, as tests/test_torch_train.py's BatchNorm
case: outputs and gradients 1e-5, running statistics 1e-6 relative.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from conftest import cpu_devices
from imagenet_models_tpu.nn import layers as jl
from imagenet_models_tpu.parallel.mesh import data_mesh
from imagenet_models_tpu_torch.nn import layers as tl
from torch_parity import highest, init_shapes, load_port, random_variables, spawn

TOL = dict(rtol=1e-5, atol=1e-5)
STAT_TOL = dict(rtol=1e-6, atol=1e-7)


def _interleaved(b=4, h=5, c=6, splits=2, seed=0):
    """A batch of `b` samples x `splits` splits, each split its own
    distribution, interleaved sample-major; and a cotangent."""
    rng = np.random.default_rng(seed)
    x = np.empty((b * splits, h, h, c), np.float32)
    for j in range(splits):
        x[j::splits] = rng.standard_normal((b, h, h, c)) * (1 + 2 * j) + j
    return x, rng.standard_normal(x.shape).astype(np.float32)


def _jax_bn(x, splits, axis_name=None):
    """JAX's BatchNorm, its random variables, and its training apply with
    `splits` set for the call."""
    bn = jl.BatchNorm(axis_name=axis_name)
    variables = random_variables(init_shapes(jl.BatchNorm(), jnp.asarray(x)), seed=1)

    def train(variables, x, g):
        def f(params, x):
            y, mut = bn.apply({**variables, "params": params}, x, use_running_average=False,
                              mutable=["batch_stats"])
            return jnp.sum(y * g), (y, mut["batch_stats"])
        (_, (y, stats)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            variables["params"], x)
        return y, gx, gp, stats

    return bn, variables, train


def _port_bn(variables, splits):
    bn = load_port(tl.BatchNorm(variables["params"]["scale"].shape[0]), variables, prefix="m")
    tl.set_bn_splits(bn, splits)
    return bn


def _port_train(bn, x, g):
    bn.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(g)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy(), bn.weight.grad.numpy(), bn.bias.grad.numpy()


def test_split_bn_training_matches_jax():
    """Two splits of their own statistics: the output, d(y . g) by the input,
    scale and bias, and the running statistics, which hold split 0's alone
    (a BatchNorm fed split 0's rows by itself moves the same way)."""
    x, g = _interleaved()
    _, variables, train = _jax_bn(x, 2)
    jl.set_bn_splits(2)
    try:
        with highest():
            y, gx, gp, stats = jax.jit(train)(variables, jnp.asarray(x), jnp.asarray(g))
    finally:
        jl.set_bn_splits(1)
    bn = _port_bn(variables, 2)
    assert tl.bn_splits(bn) == 2
    ty, tdx, tdw, tdb = _port_train(bn, x, g)
    for got, ref in ((ty, y), (tdx, gx), (tdw, gp["scale"]), (tdb, gp["bias"])):
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), **STAT_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), **STAT_TOL)
    clean = _port_bn(variables, 1).train()
    clean(torch.from_numpy(x[0::2]))
    np.testing.assert_allclose(bn.running_mean.numpy(), clean.running_mean.numpy(), **STAT_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), clean.running_var.numpy(), **STAT_TOL)
    assert not np.allclose(bn.running_mean.numpy(), variables["batch_stats"]["mean"])


def test_split_bn_eval_ignores_the_splits():
    """Eval normalises with the running statistics, splits or not, as JAX's
    does (test_split_bn.py's test_split_bn_eval_path_unchanged)."""
    x, _ = _interleaved(seed=2)
    bn_j, variables, _ = _jax_bn(x, 2)
    jl.set_bn_splits(2)
    try:
        ref = np.asarray(bn_j.apply(variables, jnp.asarray(x), use_running_average=True))
    finally:
        jl.set_bn_splits(1)
    split, plain = _port_bn(variables, 2).eval(), _port_bn(variables, 1).eval()
    with torch.no_grad():
        out = split(torch.from_numpy(x))
        assert torch.equal(out, plain(torch.from_numpy(x)))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_split_bn_falls_back_on_an_indivisible_batch(caplog):
    """5 rows in 2 splits: whole-batch statistics, bit-equal to no splits and
    equal to JAX's fallback, with one warning per geometry however often it
    is met."""
    x, g = _interleaved(b=5, splits=1, seed=3)
    _, variables, train = _jax_bn(x, 2)
    jl.set_bn_splits(2)
    try:
        with highest():
            y, _, _, _ = jax.jit(train)(variables, jnp.asarray(x), jnp.asarray(g))
    finally:
        jl.set_bn_splits(1)
    tl._SPLIT_FALLBACK_WARNED.discard((5, 2))
    with caplog.at_level(logging.WARNING, logger=tl.__name__):
        outs = [_port_train(_port_bn(variables, 2), x, g) for _ in range(2)]
    warned = [r for r in caplog.records
              if r.name == tl.__name__ and "not divisible by 2 aug-splits" in r.getMessage()]
    assert len(warned) == 1
    plain = _port_train(_port_bn(variables, 1), x, g)
    for got in outs:
        for a, b in zip(got, plain):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(outs[0][0], np.asarray(y), **TOL)


@pytest.mark.parametrize("splits", [1, 2])
def test_synchronised_statistics_at_world_2(tmp_path, splits):
    """Statistics mean-all-reduced over two gloo ranks of 4 rows each, split
    or not: each rank's output rows, input gradients and running statistics,
    and the ranks' mean affine gradient (what the step's all-reduce makes),
    against JAX's axis_name BatchNorm under shard_map on two devices (the
    affine gradient pmean'd), and against the port's one process on all 8
    rows (whose loss is the sum of the ranks': its affine gradient is twice
    the ranks' mean)."""
    x, g = _interleaved(b=8 // splits, h=3, c=4, splits=splits, seed=4 + splits)
    _, variables, train = _jax_bn(x, splits, axis_name="data")

    def local(variables, x, g):
        y, gx, gp, stats = train(variables, x, g)
        return y, gx, jax.lax.pmean(gp, "data"), stats

    sharded = jax.jit(shard_map(local, mesh=data_mesh(cpu_devices(2)),
                                in_specs=(P(), P("data"), P("data")),
                                out_specs=(P("data"), P("data"), P(), P()), check_rep=False))
    jl.set_bn_splits(splits)
    try:
        with highest():
            y, gx, gp, stats = sharded(variables, jnp.asarray(x), jnp.asarray(g))
    finally:
        jl.set_bn_splits(1)

    weights = _port_bn(variables, 1).state_dict()
    torch.save({"bn": dict(task="bn", x=torch.from_numpy(x), g=torch.from_numpy(g),
                           weights=weights, splits=splits)}, tmp_path / "inputs.pt")
    ranks = spawn(tmp_path, ["bn"])["bn"]
    ty = np.concatenate([r["y"].numpy() for r in ranks])
    tdx = np.concatenate([r["dx"].numpy() for r in ranks])
    tdw = np.mean([r["dweight"].numpy() for r in ranks], axis=0)
    tdb = np.mean([r["dbias"].numpy() for r in ranks], axis=0)
    for got, ref in ((ty, y), (tdx, gx), (tdw, gp["scale"]), (tdb, gp["bias"])):
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    for r in ranks:
        np.testing.assert_allclose(r["running_mean"].numpy(), np.asarray(stats["mean"]), **STAT_TOL)
        np.testing.assert_allclose(r["running_var"].numpy(), np.asarray(stats["var"]), **STAT_TOL)

    one = _port_bn(variables, splits)
    oy, odx, odw, odb = _port_train(one, x, g)
    for got, ref in ((ty, oy), (tdx, odx), (2 * tdw, odw), (2 * tdb, odb)):
        np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(ranks[0]["running_var"].numpy(), one.running_var.numpy(),
                               **STAT_TOL)

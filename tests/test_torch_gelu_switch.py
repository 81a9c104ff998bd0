"""The exact-GELU switch: IMTPU_GELU (the LN+MLP kernels' and the blocks'
plain path's GELU, `ops/convnext_block.resolve_gelu_impl`) and
IMTPU_XLA_GELU (the heads' and the transformer MLPs' plain GELU,
`nn/layers.resolve_act`), against the JAX package's.

Both packages read the variables once at import into module attributes
(JAX `ops/convnext_block._GELU_ENV`, `nn/layers._XLA_GELU_ENV`; the port's
attributes of the same names), which the tests set with `monkeypatch`. A
set value forces one GELU for both modes: at "exact" a tiny map_convnext's
first train step (loss and grad norm, and every parameter's gradient of its
train-mode forward) is JAX's, at the fp32 parity bound of
tests/torch_parity.py's users (1e-4); at "fast" eval takes the fast fit too,
on both sides. Since the fit lies within that bound of exact erf at the tiny
model's size, the train step's GELUs are also held to JAX's, value by value,
where the two lie far apart. JAX's other values, "poly" and "relu", are not ported and
raise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from imagenet_models_tpu.models.convnext import ConvNeXt as JConvNeXt
from imagenet_models_tpu.nn import layers as jl
from imagenet_models_tpu.ops import convnext_block as jcb
from imagenet_models_tpu.train import losses as jloss
from imagenet_models_tpu.train import optim as joptim
from imagenet_models_tpu.train import state as jstate
from imagenet_models_tpu_torch.models.convnext import ConvNeXt
from imagenet_models_tpu_torch.nn import layers as tl
from imagenet_models_tpu_torch.ops import convnext_block as tcb
from imagenet_models_tpu_torch.train import losses as tloss
from imagenet_models_tpu_torch.train import optim as toptim
from imagenet_models_tpu_torch.train import state as tstate
from torch_parity import (_flat_torch, grads_match_jax, highest, init_shapes, load_port,
                          random_variables)

TOL = dict(rtol=1e-4, atol=1e-4)
TINY = dict(depths=(1, 1, 1, 1), dims=(8, 8, 16, 16), num_classes=13, global_pool="mmcap",
            last_dim=16, n_groups=2, n_tokens=2, gram_group=2, bp_dim=16, ca_dim=16,
            num_heads=2)
LOSS = dict(bce_loss=True, smoothing=0.1, mixup_active=True)
B, HW = 8, 32


def _switch(monkeypatch, gelu: str, xla: str) -> None:
    """Both variables on both sides, as a process started with them set."""
    monkeypatch.setenv("IMTPU_GELU", gelu)
    monkeypatch.setenv("IMTPU_XLA_GELU", xla)
    monkeypatch.setattr(jcb, "_GELU_ENV", gelu)
    monkeypatch.setattr(jl, "_XLA_GELU_ENV", xla)
    monkeypatch.setattr(tcb, "_GELU_ENV", gelu)
    monkeypatch.setattr(tl, "_XLA_GELU_ENV", xla)


@pytest.fixture(scope="module")
def tiny():
    jm = JConvNeXt(**TINY)
    variables = random_variables(init_shapes(jm, jnp.zeros((1, HW, HW, 3)), training=False),
                                 seed=2)
    rng = np.random.default_rng(2)
    images = rng.standard_normal((B, HW, HW, 3)).astype(np.float32)
    targets = rng.random((B, 13)).astype(np.float32)
    return jm, variables, images, targets


def _port(variables):
    tm = load_port(ConvNeXt(**TINY), variables)
    for m in tm.modules():  # dropout off on both sides, in the test only
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return tm


def _gelus(monkeypatch, tm, images, value: str) -> set:
    """The GELUs one forward of `tm` (in its mode) runs with both switches
    at `value`: the blocks' impls ("exact", "fast") and "head fast" where a
    plain activation took the fast fit. The fast fit is within the 1e-4
    bound of exact erf at this size, so the outputs alone cannot tell."""
    seen = []
    with monkeypatch.context() as m:
        _switch(m, value, value)
        m.setattr(tcb, "_gelu", lambda x, impl, _f=tcb._gelu: seen.append(impl) or _f(x, impl))
        m.setattr(tl, "gelu_fast", lambda x, _f=tl.gelu_fast: seen.append("head fast") or _f(x))
        with torch.no_grad():
            tm(torch.from_numpy(images))
    return set(seen)


@pytest.mark.parametrize("value", ["", "exact", "fast"])
def test_resolution_matches_jax(monkeypatch, value):
    _switch(monkeypatch, value, value)
    for training in (True, False):
        assert tcb.resolve_gelu_impl(training) == jcb.resolve_gelu_impl(training)
        port = tl.resolve_act(tl.gelu, deterministic=not training)
        ref = jl.resolve_act(jl.gelu, deterministic=not training)
        assert (port is tl.gelu_fast) == (ref is jl.gelu_fast)
    assert tl.resolve_act(tl.relu, deterministic=False) is tl.relu


@pytest.mark.parametrize("value", ["", "exact", "fast"])
def test_training_gelus_match_jax_where_the_fit_shows(monkeypatch, value):
    """The GELUs a train step takes at each value, by their numbers: the
    blocks' (the plain path's GELU and the derivative that kernel 2's
    instances compute, at `resolve_gelu_impl(True)`) and the heads'
    (`resolve_act(gelu, deterministic=False)`), the port's against JAX's, on
    the points where the fast fit and exact erf lie more than ten times the
    comparison's bound apart; so the numbers alone tell which GELU ran."""
    _switch(monkeypatch, value, value)
    x = np.linspace(-6.0, 6.0, 2401, dtype=np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    impl = jcb.resolve_gelu_impl(True)
    other = "exact" if impl == "fast" else "fast"
    pairs = {
        "block": (lambda i: tcb._gelu(xt, i).numpy(),
                  np.asarray(jl.gelu(xj) if impl == "exact" else jcb._kernel_gelu(xj, impl))),
        "kernel 2's derivative": (lambda i: tcb._gelu_grad(xt, i).numpy(),
                                  np.asarray(jcb._kernel_gelu_grad(xj, impl))),
        "head": (lambda i: (tl.gelu if i == "exact" else tl.gelu_fast)(xt).numpy(),
                 np.asarray(jl.resolve_act(jl.gelu, deterministic=False)(xj))),
    }
    ports = {"block": tcb._gelu(xt, tcb.resolve_gelu_impl(True)).numpy(),
             "kernel 2's derivative": tcb._gelu_grad(xt, tcb.resolve_gelu_impl(True)).numpy(),
             "head": tl.resolve_act(tl.gelu, deterministic=False)(xt).numpy()}
    for name, (by_impl, ref) in pairs.items():
        bound = 2e-6 + 1e-5 * np.abs(ref)
        shows = np.abs(by_impl("fast") - by_impl("exact")) > 10 * bound
        assert shows.sum() > 100, name
        got = ports[name][shows]
        np.testing.assert_allclose(got, ref[shows], rtol=1e-5, atol=2e-6, err_msg=name)
        assert (np.abs(got - by_impl(other)[shows]) > 5 * bound[shows]).all(), name


@pytest.mark.parametrize("value", ["poly", "relu"])
def test_values_not_ported_raise(monkeypatch, value):
    _switch(monkeypatch, value, "")
    with pytest.raises(ValueError, match=f"IMTPU_GELU='{value}' is not ported"):
        tcb.resolve_gelu_impl(True)
    _switch(monkeypatch, "", value)
    with pytest.raises(ValueError, match=f"IMTPU_XLA_GELU='{value}' is not ported"):
        tl.resolve_act(tl.gelu, deterministic=True)


def test_exact_first_step_matches_jax(monkeypatch, tiny):
    """IMTPU_GELU=exact IMTPU_XLA_GELU=exact: one LAMB step's loss and grad
    norm (BCE on dense targets, dec_lam -0.8), and the train-mode forward's
    gradients of every parameter, as JAX's; and the GELUs the port ran."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    jm, variables, images, targets = tiny
    train_kw = dict(training=True, mutable=["batch_stats"])
    _switch(monkeypatch, "exact", "exact")
    tx = joptim.create_optimizer("lamb", learning_rate=5e-3, weight_decay=0.05)
    jst = jstate.create_train_state(jax.tree.map(jnp.asarray, variables), tx)
    jstep = jstate.make_train_step(jm, tx, jloss.create_loss_fn(**LOSS), dec_lam=-0.8)
    with highest():
        _, ref = jstep(jst, jnp.asarray(images), jnp.asarray(targets), jax.random.PRNGKey(0))
    tm = _port(variables)
    opt = toptim.create_optimizer("lamb", learning_rate=5e-3, weight_decay=0.05)
    st = tstate.create_train_state(tm, opt, device="cpu")
    step = tstate.make_train_step(tm, opt, tloss.create_loss_fn(**LOSS), dec_lam=-0.8)
    _, got = step(st, torch.from_numpy(images), torch.from_numpy(targets))
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key].item(), float(ref[key]), rtol=1e-4, err_msg=key)

    tm = _port(variables).train()
    grads_match_jax(jm, variables, tm, images, "map_convnext_tiny", "", train_kw, TOL)
    # the GELUs the port's train-mode forward ran: all exact at "exact", the
    # fast fit at the default
    assert _gelus(monkeypatch, tm, images, "exact") == {"exact"}
    assert _gelus(monkeypatch, tm, images, "") == {"fast", "head fast"}


def test_fast_forces_eval_too(monkeypatch, tiny):
    """IMTPU_GELU=fast IMTPU_XLA_GELU=fast: the eval forward takes the fast
    fit on both sides (the port's GELUs read as in the train step's test)."""
    jm, variables, images, _ = tiny
    tm = _port(variables)
    assert _gelus(monkeypatch, tm, images, "") == {"exact"}
    assert _gelus(monkeypatch, tm, images, "fast") == {"fast", "head fast"}
    _switch(monkeypatch, "fast", "fast")
    with highest():
        ref = jax.jit(lambda v, x: jm.apply(v, x, training=False))(variables, jnp.asarray(images))
    ref = np.concatenate([np.asarray(o).reshape(B, -1) for o in jax.tree.leaves(ref)], -1)
    with torch.no_grad():
        got = _flat_torch(tm(torch.from_numpy(images)))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)

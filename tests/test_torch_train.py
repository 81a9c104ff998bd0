"""The port's training pieces against the JAX package, on the CPU in fp32.

Train-mode BatchNorm, the losses, timm LAMB / AdamW / SGD, the cosine
schedule, the scatter-free triu backward, and the slice as a whole: five
LAMB steps of a tiny mmcap ConvNeXt from the same weights and batches, held
to JAX's `make_train_step` (loss series, final parameters, EMA shadow and BN
running statistics). Inputs come from numpy seeds; the JAX side runs at
highest matmul precision.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from imagenet_models_tpu.models.convnext import ConvNeXt as JConvNeXt
from imagenet_models_tpu.nn import heads as jh
from imagenet_models_tpu.nn import layers as jl
from imagenet_models_tpu.train import losses as jloss
from imagenet_models_tpu.train import optim as joptim
from imagenet_models_tpu.train import scheduler as jsched
from imagenet_models_tpu.train import state as jstate
from imagenet_models_tpu_torch.ckpt.convert import state_dict_from_jax
from imagenet_models_tpu_torch.models.convnext import ConvNeXt as TConvNeXt
from imagenet_models_tpu_torch.nn import heads as th
from imagenet_models_tpu_torch.nn import layers as tl
from imagenet_models_tpu_torch.train import losses as tloss
from imagenet_models_tpu_torch.train import optim as toptim
from imagenet_models_tpu_torch.train import scheduler as tsched
from imagenet_models_tpu_torch.train import state as tstate
from torch_parity import highest, init_shapes, load_port, random_variables


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_batch_norm_training_statistics():
    x = _x(3, 4, 4, 12) * 2.0 + 0.5
    jm = jl.BatchNorm()
    variables = random_variables(init_shapes(jm, jnp.asarray(x)), seed=1)
    with highest():
        ref, mut = jm.apply(variables, jnp.asarray(x), use_running_average=False,
                            mutable=["batch_stats"])
    tm = load_port(tl.BatchNorm(12), variables, prefix="m").train()
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tm.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-7)


def test_gelu_fast_and_resolve_act():
    x = _x(1000) * 4
    np.testing.assert_allclose(tl.gelu_fast(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.gelu_fast(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    assert tl.resolve_act(tl.gelu, deterministic=False) is tl.gelu_fast
    assert tl.resolve_act(tl.gelu, deterministic=True) is tl.gelu
    assert tl.resolve_act(tl.relu, deterministic=False) is tl.relu


def test_drop_path_training():
    dp = tl.DropPath(0.5).train()
    x = torch.ones(4000, 3, 3, 2)
    a = dp(x, torch.Generator().manual_seed(0))
    b = dp(x, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)  # the generator decides the mask
    kept = a[:, 0, 0, 0]
    assert set(kept.unique().tolist()) == {0.0, 2.0}  # dropped, or kept and scaled by 1/(1-rate)
    assert abs(kept.mean().item() - 1.0) < 0.1
    assert (a == a[:, :1, :1, :1]).all()  # one draw per sample
    assert torch.equal(dp.eval()(x), x)


def test_triu_backward_matches_jax_grad():
    x = _x(2, 9, 6)
    w = _x(2, 21, seed=1)

    def jf(t):
        return jnp.sum(jh.gram_triu_normalize(t, scale=1.0 / 9) * w)

    with highest():
        ref = jax.grad(jf)(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    (th.gram_triu_normalize(t, scale=1.0 / 9) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- losses

B, K = 6, 10


def _logits(seed=0):
    return _x(B, K, seed=seed) * 3


def _dense(seed=1):
    t = np.random.default_rng(seed).random((B, K)).astype(np.float32)
    return t / t.sum(-1, keepdims=True)


_IDX = np.random.default_rng(2).integers(0, K, B)

LOSS_CASES = {
    "bce_smooth": (lambda m: m.binary_cross_entropy, dict(smoothing=0.1), _IDX),
    "bce_dense_thresh": (lambda m: m.binary_cross_entropy, dict(target_threshold=0.2), None),
    "soft_ce": (lambda m: m.soft_target_cross_entropy, {}, None),
    "ce_smooth": (lambda m: m.cross_entropy, dict(smoothing=0.1), _IDX),
    "jsd": (lambda m: m.jsd_cross_entropy, dict(num_splits=3, alpha=12.0, smoothing=0.1), _IDX),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_matches_jax(case):
    fn, kw, idx = LOSS_CASES[case]
    target = _dense() if idx is None else idx
    ref = float(fn(jloss)(jnp.asarray(_logits()), jnp.asarray(target), **kw))
    got = fn(tloss)(torch.from_numpy(_logits()), torch.from_numpy(target), **kw).item()
    assert abs(got - ref) <= 1e-6 * abs(ref), (got, ref)


@pytest.mark.parametrize("kw", [dict(bce_loss=True, smoothing=0.1, mixup_active=True),
                                dict(bce_loss=True, smoothing=0.1), dict(smoothing=0.1),
                                dict(mixup_active=True), dict(jsd_splits=3)])
def test_create_loss_fn_matches_jax(kw):
    target = _dense() if kw.get("mixup_active") else _IDX
    ref = float(jloss.create_loss_fn(**kw)(jnp.asarray(_logits()), jnp.asarray(target)))
    got = tloss.create_loss_fn(**kw)(torch.from_numpy(_logits()), torch.from_numpy(target)).item()
    assert abs(got - ref) <= 1e-6 * abs(ref), (got, ref)


@pytest.mark.parametrize("reduction", ["sum", "mean", "batchmean"])
def test_kl_div_log_target_matches_jax(reduction):
    a = np.array(jax.nn.log_softmax(jnp.asarray(_logits(3)), axis=1))
    b = np.array(jax.nn.log_softmax(jnp.asarray(_logits(4)), axis=1))
    ref = float(jloss.kl_div_log_target(jnp.asarray(a), jnp.asarray(b), reduction))
    got = tloss.kl_div_log_target(torch.from_numpy(a), torch.from_numpy(b), reduction).item()
    assert abs(got - ref) <= 1e-6 * abs(ref), (got, ref)


def _heads(kind):
    if kind == "single":
        return [_logits(5)]
    if kind == "plain":
        return [_logits(5), _logits(6), _logits(7)]
    if kind == "pairs":
        return [(_logits(5), _logits(6)), (_logits(7), _logits(8))]
    return [(_logits(5), _logits(6), _logits(7)), (_logits(8), _logits(9), _logits(10))]


@pytest.mark.parametrize("kind,token_distillation", [("single", True), ("plain", True),
                                                     ("pairs", True), ("triples", True),
                                                     ("triples", False)])
def test_multi_head_loss_matches_jax(kind, token_distillation):
    heads = _heads(kind)
    conv = lambda f, hs: [tuple(map(f, h)) if isinstance(h, tuple) else f(h) for h in hs]
    base_j = jloss.create_loss_fn(bce_loss=True, mixup_active=True)
    base_t = tloss.create_loss_fn(bce_loss=True, mixup_active=True)
    ref = float(jloss.multi_head_loss(conv(jnp.asarray, heads), jnp.asarray(_dense()), base_j,
                                      dec_lam=-0.8, token_distillation=token_distillation))
    got = tloss.multi_head_loss(conv(torch.from_numpy, heads), torch.from_numpy(_dense()), base_t,
                                dec_lam=-0.8, token_distillation=token_distillation).item()
    assert abs(got - ref) <= 1e-6 * abs(ref), (got, ref)


# ---------------------------------------------------------------- optimizers

def _toy_params(seed=0):
    """A JAX param tree and the port's names for its leaves, torch layout:
    conv OIHW, Linear (O, I), grouped pointwise (O, I/g, 1, 1) from JAX's
    (g, I/g, O/g), vectors; x_cls is never decayed."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    jtree = {"conv": {"kernel": f(3, 3, 4, 8), "bias": f(8)}, "dense": {"kernel": f(16, 10)},
             "grouped": {"kernel": f(2, 3, 4)}, "norm": {"scale": f(16) + 1.0},
             "x_cls": f(1, 2, 16)}
    to_t = {"conv.weight": lambda t: t["conv"]["kernel"].transpose(3, 2, 0, 1),
            "conv.bias": lambda t: t["conv"]["bias"],
            "dense.weight": lambda t: t["dense"]["kernel"].T,
            "grouped.weight": lambda t: t["grouped"]["kernel"].transpose(0, 2, 1).reshape(8, 3)[
                :, :, None, None],
            "norm.weight": lambda t: t["norm"]["scale"], "x_cls": lambda t: t["x_cls"]}
    return jtree, to_t, {"grouped.weight": 2}


@pytest.mark.parametrize("opt,kw", [("lamb", dict(weight_decay=0.05)),
                                    ("lamb", dict(weight_decay=0.05, clip_grad=0.5)),
                                    ("adamw", dict(weight_decay=0.05)),
                                    ("sgd", dict(weight_decay=1e-4)),
                                    ("momentum", dict(weight_decay=1e-4, clip_grad=0.1,
                                                      clip_mode="value")),
                                    ("adamw", dict(weight_decay=0.05, clip_grad=1.0,
                                                   clip_mode="norm")),
                                    ("lamb", dict(weight_decay=0.05, clip_grad=0.02,
                                                  clip_mode="agc")),
                                    ("sgd", dict(weight_decay=1e-4, clip_grad=0.02,
                                                 clip_mode="agc"))])
@pytest.mark.parametrize("gscale", [0.01, 40.0])
def test_optimizer_matches_jax(opt, kw, gscale):
    """3 updates, leaf for leaf; gscale puts the global grad norm below and
    above LAMB's 1.0 pre-division threshold and the norm clip, and the
    unit-wise grad norms below and above the adaptive clip (0.02 of the
    unit's param norm), whose units are those of the JAX layout."""
    jtree, to_t, grouped = _toy_params()
    lr = lambda count: 3e-3 * (1.0 + count)  # a schedule of the update count
    tx = joptim.create_optimizer(opt, learning_rate=lambda c: 3e-3 * (1.0 + c), **kw)
    jp = jax.tree.map(jnp.asarray, jtree)
    jstate_ = tx.init(jp)
    tp = {k: torch.from_numpy(np.ascontiguousarray(f(jtree))).clone() for k, f in to_t.items()}
    topt = toptim.create_optimizer(opt, learning_rate=lr, **kw)
    tst = topt.init(tp, grouped=grouped)
    rng = np.random.default_rng(1)
    for _ in range(3):
        gtree = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32) * gscale,
                             jtree)
        upd, jstate_ = tx.update(jax.tree.map(jnp.asarray, gtree), jstate_, jp)
        jp = optax_apply(jp, upd)
        topt.step(tp, {k: torch.from_numpy(np.ascontiguousarray(f(gtree))) for k, f in to_t.items()},
                  tst)
    jnp_tree = jax.tree.map(np.asarray, jp)
    for k, f in to_t.items():
        np.testing.assert_allclose(tp[k].numpy(), f(jnp_tree), rtol=2e-5, atol=2e-5, err_msg=k)


def optax_apply(params, updates):
    import optax

    return optax.apply_updates(params, updates)


def test_wd_mask_by_name():
    params = {"stages.0.0.pwconv1.weight": torch.zeros(4, 2), "stages.0.0.gamma": torch.zeros(2),
              "head.mmcap.mmcap.0.x_cls": torch.zeros(1, 2, 4), "a.pos_embed": torch.zeros(1, 2, 2, 2),
              "b.relative_position_bias_table": torch.zeros(9, 2)}
    assert toptim.wd_mask(params) == {"stages.0.0.pwconv1.weight": True, "stages.0.0.gamma": False,
                                      "head.mmcap.mmcap.0.x_cls": False, "a.pos_embed": False,
                                      "b.relative_position_bias_table": False}


@pytest.mark.parametrize("kw", [dict(), dict(warmup_epochs=0, cooldown_epochs=3),
                                dict(cycle_mul=2.0, cycle_limit=3, cycle_decay=0.5),
                                dict(k_decay=2.0),
                                dict(noise_table=jsched.lr_noise_table(30, [5, 20]))])
def test_cosine_schedule_matches_jax(kw):
    jf = jsched.cosine_schedule(5e-3, epochs=20, **kw)
    tf = tsched.cosine_schedule(5e-3, epochs=20, **kw)
    # JAX evaluates in fp32, the port in float64: near the end of a cycle the
    # fp32 rounding of the cosine's argument shows at ~1e-6 of the value
    for e in np.linspace(0, 29, 59):
        assert abs(tf(e) - float(jf(e))) <= 1e-5 * float(jf(e)), e
    np.testing.assert_array_equal(tsched.lr_noise_table(30, [5, 20]),
                                  jsched.lr_noise_table(30, [5, 20]))


def test_step_schedule_matches_jax():
    jf = jsched.create_scheduler("step", base_lr=0.1, decay_epochs=3, warmup_epochs=2)
    tf = tsched.create_scheduler("step", base_lr=0.1, decay_epochs=3, warmup_epochs=2)
    for e in np.linspace(0, 10, 21):
        assert abs(tf(e) - float(jf(e))) <= 1e-6 * float(jf(e))


# ---------------------------------------------------------------- the slice

def _tiny(mmcap, lib):
    kw = dict(depths=(1, 1, 1, 1), dims=(8, 8, 16, 16), num_classes=13)
    if mmcap:
        kw.update(global_pool="mmcap", last_dim=16, n_groups=2, n_tokens=2, gram_group=2,
                  bp_dim=16, ca_dim=16, num_heads=2)
    return JConvNeXt(**kw) if lib == "jax" else TConvNeXt(**kw)


def _batches(n_steps, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, 32, 32, 3)).astype(np.float32),
             rng.random((batch, 13)).astype(np.float32)) for _ in range(n_steps)]


def _port_state(variables, mmcap, ema):
    model = _tiny(mmcap, "torch")
    load_port(model, variables, model_name="map_convnext_tiny")
    for m in model.modules():  # dropout off on both sides, in the test only
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    opt = toptim.create_optimizer("lamb", learning_rate=5e-3, weight_decay=0.05)
    return tstate.create_train_state(model, opt, ema_decay=ema, device="cpu"), opt


LOSS = dict(bce_loss=True, smoothing=0.1, mixup_active=True)


def test_train_trajectory_matches_jax(monkeypatch):
    """5 LAMB steps (lr 5e-3, wd 0.05), BCE on dense targets, dec_lam -0.8,
    EMA 0.9, tiny mmcap ConvNeXt at 32 px, B=8, fp32.

    Measured on a CPU: the loss series agrees within 2.1e-7 relative; final
    parameters within 8.6e-6 and the EMA within 2.9e-6 of (max|ref| + 1),
    the worst leaf attn.k.bias (fp32 sums in another order, through five
    trust-ratio updates). The tolerances leave ~100x of room."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    jm = _tiny(True, "jax")
    variables = random_variables(init_shapes(jm, jnp.zeros((1, 32, 32, 3)), training=False),
                                 seed=0)
    batches = _batches(5)

    tx = joptim.create_optimizer("lamb", learning_rate=5e-3, weight_decay=0.05)
    jst = jstate.create_train_state(jax.tree.map(jnp.asarray, variables), tx, ema_decay=0.9)
    # committed like the step's outputs, so the step compiles once, not twice
    jst = jax.device_put(jst, jax.devices()[0])
    jstep = jstate.make_train_step(jm, tx, jloss.create_loss_fn(**LOSS), dec_lam=-0.8,
                                   ema_decay=0.9)
    ref_losses = []
    with highest():
        for images, targets in batches:
            jst, m = jstep(jst, jnp.asarray(images), jnp.asarray(targets), jax.random.PRNGKey(0))
            ref_losses.append(float(m["loss"]))

    st, opt = _port_state(variables, True, 0.9)
    step = tstate.make_train_step(st.model, opt, tloss.create_loss_fn(**LOSS), dec_lam=-0.8,
                                  ema_decay=0.9)
    losses = []
    for images, targets in batches:
        st, m = step(st, torch.from_numpy(images), torch.from_numpy(targets))
        losses.append(m["loss"].item())
        assert np.isfinite(m["grad_norm"].item())
    for got, ref in zip(losses, ref_losses):
        assert abs(got - ref) <= 1e-3 * abs(ref) + 1e-5, (losses, ref_losses)
    assert st.step == 5

    name = "map_convnext_tiny"
    ref_live = state_dict_from_jax({"params": jax.tree.map(np.asarray, jst.params),
                                    "batch_stats": jax.tree.map(np.asarray, jst.batch_stats)}, name)
    ref_ema = state_dict_from_jax({"params": jax.tree.map(np.asarray, jst.ema_params),
                                   "batch_stats": jax.tree.map(np.asarray, jst.ema_batch_stats)},
                                  name)
    live = st.model.state_dict()
    ema = {**st.ema_params, **st.ema_batch_stats}
    assert set(ref_live) == set(live) and set(ref_ema) == set(ema)
    assert any(k.endswith("running_var") for k in ema)
    for got, ref in ((live, ref_live), (ema, ref_ema)):
        for k, r in ref.items():
            r = r.numpy()
            err = np.abs(got[k].numpy() - r).max()
            assert err <= 1e-3 * (np.abs(r).max() + 1), (k, err)


def test_grad_accum_matches_one_batch_of_twice_the_size():
    """Without BatchNorm (the avg-pool head) and without dropout, two
    microbatches of 8 give the same update as one batch of 16."""
    variables = random_variables(init_shapes(_tiny(False, "jax"), jnp.zeros((1, 32, 32, 3)),
                                             training=False), seed=2)
    images, targets = _batches(1, batch=16, seed=3)[0]
    out = {}
    for accum in (1, 2):
        st, opt = _port_state(variables, False, 0.0)
        step = tstate.make_train_step(st.model, opt, tloss.create_loss_fn(**LOSS),
                                      grad_accum=accum)
        st, m = step(st, torch.from_numpy(images), torch.from_numpy(targets))
        out[accum] = (m, {k: v.clone() for k, v in st.model.state_dict().items()})
    assert abs(out[1][0]["loss"].item() - out[2][0]["loss"].item()) <= 1e-6
    assert abs(out[1][0]["grad_norm"].item() - out[2][0]["grad_norm"].item()) <= 1e-5 * out[1][0]["grad_norm"].item()
    for k, v in out[1][1].items():
        np.testing.assert_allclose(out[2][1][k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_eval_step_reads_the_ema_shadow():
    variables = random_variables(init_shapes(_tiny(True, "jax"), jnp.zeros((1, 32, 32, 3)),
                                             training=False), seed=4)
    st, opt = _port_state(variables, True, 0.5)
    step = tstate.make_train_step(st.model, opt, tloss.create_loss_fn(**LOSS), dec_lam=-0.8,
                                  ema_decay=0.5)
    images, targets = _batches(1, seed=5)[0]
    st, _ = step(st, torch.from_numpy(images), torch.from_numpy(targets))
    labels = torch.from_numpy(np.arange(8) % 13)
    live = tstate.make_eval_step(st.model)(torch.from_numpy(images), labels)[0]
    ema = tstate.make_eval_step(st.model, use_ema=True, state=st)(torch.from_numpy(images), labels)[0]
    shadow = _tiny(True, "torch")
    shadow.load_state_dict({**st.ema_params, **st.ema_batch_stats}, strict=True)
    ref = tstate.make_eval_step(shadow)(torch.from_numpy(images), labels)[0]
    torch.testing.assert_close(ema, ref, rtol=0, atol=0)
    assert not torch.allclose(ema, live)
    with pytest.raises(ValueError, match="ema"):
        tstate.make_eval_step(st.model, use_ema=True)

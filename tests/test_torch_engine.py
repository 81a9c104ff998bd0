"""The port's engine, optimizer schedule count, reference init, checkpoint
saver and export against the JAX package (tests/test_engine_aux.py,
tests/test_reinit.py, tests/test_saver_async.py and
tests/test_ckpt_roundtrip.py hold the JAX side's own cases)."""

import json
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import imagenet_models_tpu.models  # noqa: F401  (registers the JAX factories)
from imagenet_models_tpu import create_model as jax_create_model
from imagenet_models_tpu.ckpt.pretrained import load_variables_from_torch
from imagenet_models_tpu.core.reinit import reference_init as jax_reference_init
from imagenet_models_tpu.models import ga_cswin as jgc
from imagenet_models_tpu.models import resnet as jrn
from imagenet_models_tpu.train import optim as joptim
from imagenet_models_tpu_torch import create_model
from imagenet_models_tpu_torch.ckpt import convert
from imagenet_models_tpu_torch.ckpt import saver as tsaver
from imagenet_models_tpu_torch.cli import Truncate
from imagenet_models_tpu_torch.core.reinit import reference_init
from imagenet_models_tpu_torch.models import ga_cswin as tgc
from imagenet_models_tpu_torch.models import resnet as trn
from imagenet_models_tpu_torch.nn.layers import grouped_weights
from imagenet_models_tpu_torch.train import engine
from imagenet_models_tpu_torch.train import optim as toptim
from imagenet_models_tpu_torch.train.state import create_train_state, make_eval_step
from imagenet_models_tpu_torch.utils.meters import update_summary
from torch_parity import init_shapes

CPU = torch.device("cpu")


class _FakeLoader:
    batch_size = 4
    mixup_enabled = False

    def __len__(self):
        return 3

    def __iter__(self):
        for _ in range(3):
            yield np.zeros((4, 8, 8, 3), np.float32), np.zeros((4,), np.int64)


# ---------------------------------------------------------------- engine

def test_nan_watchdog_fires():
    calls = {"n": 0}

    def step_fn(state, images, targets, generator):
        calls["n"] += 1
        loss = float("nan") if calls["n"] == 2 else 1.0
        return state, {"loss": torch.tensor(loss), "grad_norm": torch.tensor(0.0)}

    with pytest.raises(engine.NaNWatchdog, match="batch 1"):
        engine.train_one_epoch(0, None, step_fn, _FakeLoader(), None, CPU, log_interval=1)


def test_losses_are_fetched_at_log_intervals_only():
    """Between log intervals the loss stays a device tensor: no host sync per
    step. With log_interval 2 the NaN of batch 1 surfaces at batch 2's drain,
    after the third step ran."""
    calls = {"n": 0}

    def step_fn(state, images, targets, generator):
        calls["n"] += 1
        loss = float("nan") if calls["n"] == 2 else 1.0
        return state, {"loss": torch.tensor(loss), "grad_norm": torch.tensor(0.0)}

    with pytest.raises(engine.NaNWatchdog, match="batch 1"):
        engine.train_one_epoch(0, None, step_fn, _FakeLoader(), None, CPU, log_interval=2)
    assert calls["n"] == 3


class _FirstPixel(torch.nn.Module):
    """Logits = the images' first pixel, channels as classes."""

    def forward(self, images, use_kernel=None):
        return images[:, 0, 0, :]


class _TtaLoader:
    batch_size = 4

    def __len__(self):
        return 1

    def __iter__(self):
        # 4 samples, 6 classes: the pairs' mean logits pick class 1 and 2,
        # while single samples disagree
        x = np.full((4, 1, 1, 6), -10.0, np.float32)
        x[0, 0, 0, :3] = [3.0, 2.0, 0.0]
        x[1, 0, 0, :3] = [0.0, 3.0, 2.5]
        x[2, 0, 0, :3] = [0.0, 1.0, 4.0]
        x[3, 0, 0, :3] = [3.5, 0.0, 0.0]
        yield x, np.array([1, -1, 2, -1], np.int64)


def test_validate_tta_group_averaging():
    """--tta N: eval logits averaged over groups of N consecutive samples,
    targets strided (MAP/train.py:1009-1012)."""
    metrics, stats = engine.validate(make_eval_step(_FirstPixel(), tta=2), _TtaLoader(), CPU,
                                     tta=2)
    assert metrics["top1"] == 100.0 and stats.images == 4 and stats.steps == 1
    metrics1, _ = engine.validate(make_eval_step(_FirstPixel(), tta=0), _TtaLoader(), CPU)
    assert metrics1["top1"] < 100.0


def test_validate_pads_the_tail_batch():
    """A tail batch shorter than the loader's is padded with target -1, which
    no prediction matches, and only its real samples are metered."""
    class Tail(_TtaLoader):
        def __iter__(self):
            x = np.full((3, 1, 1, 6), -10.0, np.float32)
            x[:, 0, 0, 2] = 5.0
            yield x, np.array([2, 2, 0], np.int64)

    metrics, stats = engine.validate(make_eval_step(_FirstPixel()), Tail(), CPU)
    assert metrics["top1"] == pytest.approx(200.0 / 3) and stats.images == 3


def test_preemption_saves_recovery_and_raises():
    """SIGTERM -> recovery checkpoint at the next step boundary -> Preempted."""
    calls = {"n": 0}
    saved = []

    class _Saver:
        def save_recovery(self, state, epoch, batch_idx, epoch_complete=False):
            saved.append((epoch, batch_idx, epoch_complete))

    def step_fn(state, images, targets, generator):
        calls["n"] += 1
        if calls["n"] == 2:  # the signal lands mid-step
            engine._PREEMPT["signaled"] = True
        return state, {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(0.0)}

    try:
        with pytest.raises(engine.Preempted):
            engine.train_one_epoch(0, None, step_fn, _FakeLoader(), None, CPU, log_interval=1,
                                   saver=_Saver())
        assert saved and saved[-1] == (0, 1, False)
        assert calls["n"] == 2  # batch 2 never ran
    finally:
        engine._PREEMPT["signaled"] = False


def test_preemption_handler_installs_and_fires():
    engine.install_preemption_handler()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert engine._PREEMPT["signaled"]
    finally:
        engine._PREEMPT["signaled"] = False
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


def test_truncate_wrapper_delegates_attribute_writes():
    """--mixup-off-epoch flips mixup_enabled on the wrapper; the write must
    reach the wrapped loader whose __iter__ applies mixup."""
    loader = _FakeLoader()
    loader.mixup_enabled = True
    wrapped = Truncate(loader, 2)
    assert wrapped.mixup_enabled is True and wrapped.batch_size == 4
    wrapped.mixup_enabled = False
    assert loader.mixup_enabled is False
    assert len(wrapped) == 2 and len(list(wrapped)) == 2


def test_update_summary_writes_the_header_once(tmp_path):
    path = str(tmp_path / "run" / "summary.csv")
    for epoch in range(2):
        update_summary(epoch, {"loss": 0.5}, {"top1": 1.0, "top5": 2.0}, path,
                       write_header=epoch == 0, lr=0.1)
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines == ["epoch,train_loss,eval_top1,eval_top5,lr",
                     "0,0.5,1.0,2.0,0.1", "1,0.5,1.0,2.0,0.1"]


# ---------------------------------------------------------------- schedule count

@pytest.mark.parametrize("count", [0, 7, 1234])
def test_set_schedule_count_gives_jax_lr(count):
    """After set_schedule_count the next update evaluates the LR schedule at
    `count`, in JAX and in the port, while the bias-correction count stays
    fresh (timm steps its scheduler by epoch, apart from the optimizer)."""
    seen = {"jax": [], "port": []}

    def schedule(side):
        def lr(step):
            seen[side].append(int(step))
            return 1e-3 * (1 + int(step) // 5)
        return lr

    tx = joptim.create_optimizer("lamb", learning_rate=schedule("jax"), weight_decay=0.05)
    jparams = {"w": jnp.ones((4, 4))}
    jst = joptim.set_schedule_count(tx.init(jparams), count)
    jupd, _ = tx.update({"w": jnp.full((4, 4), 0.5)}, jst, jparams)

    opt = toptim.create_optimizer("lamb", learning_rate=schedule("port"), weight_decay=0.05)
    params = {"w": torch.ones(4, 4)}
    st = toptim.set_schedule_count(opt.init(params), count)
    assert st["count"] == 0
    opt.step(params, {"w": torch.full((4, 4), 0.5)}, st)
    assert seen["port"] == [count] and count in seen["jax"]
    assert st["count"] == 1 and st["schedule_count"] == count + 1
    np.testing.assert_allclose(params["w"].numpy(), 1.0 + np.asarray(jupd["w"]), rtol=1e-6)


# ---------------------------------------------------------------- reference init

# narrow models of the three families the init rewrites (the port's parity
# tests' configurations: tests/test_torch_resnet.py, tests/test_torch_cswin.py)
RESNET = dict(nblock=(1, 1, 1, 1), channels=(16, 16, 32, 32), se=True, stem_type="deep",
              num_classes=7, last_dim=32, n_groups=2, n_tokens=2, gram_group=16)
CSWIN = dict(embed_dim=16, depth=(1, 1, 2, 1), dims=(16, 32, 64, 128),
             num_heads=(2, 2, 4, 4, 4), branches=2, gram_dim=48, stage3_naggre=1,
             num_classes=7, split_size=(1, 2, 2, 2, 2))


def _init_case(name):
    """(family name, JAX module, port module, JAX port-name key)."""
    if name == "mobilenet_v1":
        return name, jax_create_model(name, num_classes=7), \
            create_model(name, device="cpu", num_classes=7), name
    if name == "resnet":
        return "map_resnet50", jrn.MAP_ResNet(**RESNET), trn.MAP_ResNet(**RESNET), "map_resnet50"
    return "ga_cswin_tiny", jgc.GA_CSWinTransformer(**CSWIN), \
        tgc.GA_CSWinTransformer(**CSWIN, img_size=64), "ga_cswin_tiny"


@pytest.mark.parametrize("name", ["mobilenet_v1", "resnet", "ga_cswin"])
def test_reference_init_rewrites_the_leaves_jax_does(name):
    """reference_init rewrites the same tensors as JAX's, through the weights
    bridge (a JAX leaf marked 1 where JAX's init changed it), with each
    rewritten tensor inside its distribution's bound: torch-default uniforms
    within 1/sqrt(fan_in) with about its spread, kaiming normals with std
    sqrt(2/fan_out), and resnet's zero_init_last gammas at zero."""
    family, jm, tm, key = _init_case(name)
    # JAX's choice of leaves depends on their names and ranks only: its init
    # runs on leaves of the model's ranks with every dimension 1 (four
    # shapes to compile, not one per leaf), all 0.5 before
    shapes = init_shapes(jm, jnp.zeros((1, 64, 64, 3)), training=False)
    halves = jax.tree.map(lambda s: jnp.full((1,) * len(s.shape), 0.5), shapes)
    after = jax_reference_init(family, halves, seed=3)
    marks = jax.tree.map(lambda b: (np.asarray(b) != 0.5).astype(np.float32), after["params"])
    jax_changed = {k for k, v in convert.state_dict_from_jax({"params": marks}, key).items()
                   if v.any()}
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    reference_init(family, tm, seed=3)
    changed = {k for k, p in tm.named_parameters() if not torch.equal(p, before[k])}
    assert changed == jax_changed and changed
    for k, p in tm.named_parameters():
        if k not in changed:
            continue
        w = p.detach()
        if family == "map_resnet50" and k.endswith("conv3.1.weight"):
            assert not w.any(), k
        elif family == "map_resnet50":  # kaiming normal, fan_out
            g = grouped_weights(tm).get(k)  # a grouped projection's JAX leaf: (g, I/g, O/g)
            fan_out = w.shape[0] // g if g else w.shape[0] * w[0, 0].numel()
            assert abs(w.std().item() / np.sqrt(2.0 / fan_out) - 1) < 0.35, k
        else:
            owner = tm.get_submodule(k.rsplit(".", 1)[0]) if "." in k else tm
            b = 1 / np.sqrt(owner.weight[0].numel())
            assert w.abs().max().item() <= b and (w.numel() < 64 or w.abs().max() > 0.8 * b), k
    assert reference_init("map_convnext_tiny", tm, seed=3) is tm  # ConvNeXt: unchanged


# ---------------------------------------------------------------- saver and export

def _tiny_state(ema=0.5):
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    opt = toptim.create_optimizer("lamb", learning_rate=1e-2)
    return create_train_state(model, opt, ema_decay=ema, device="cpu"), opt


def test_saver_layout_best_history_and_recovery(tmp_path):
    """checkpoint-N, last (a copy of the newest), model_best by the metric's
    direction, max_history pruning, args.yaml; recovery snapshots record
    epoch-1 until the epoch's last batch; the async write is of the state at
    the save, not after later steps."""
    state, _ = _tiny_state()
    gen = torch.Generator().manual_seed(5)
    saver = tsaver.CheckpointSaver(str(tmp_path), max_history=2, args_text="a: 1\n",
                                   async_save=True, generator=gen)
    metrics = [1.0, 3.0, 2.0]
    for epoch, m in enumerate(metrics):
        with torch.no_grad():
            state.model[0].weight.fill_(float(epoch))
        best = saver.save_checkpoint(state, epoch, metric=m)
        with torch.no_grad():
            state.model[0].weight.fill_(-1.0)  # after the snapshot: not in the file
    saver.wait_until_finished()
    assert best == (3.0, 1)
    assert sorted(os.listdir(tmp_path)) == ["args.yaml", "checkpoint-1", "checkpoint-2",
                                            "last", "model_best"]
    load = lambda name: torch.load(tmp_path / name / "state.pt", weights_only=True)
    assert load("last")["model"]["0.weight"].eq(2.0).all()
    assert load("model_best")["model"]["0.weight"].eq(1.0).all()
    assert json.loads((tmp_path / "model_best" / "meta.json").read_text()) == \
        {"epoch": 1, "metric": 3.0}
    assert torch.equal(load("last")["generator"], gen.get_state())
    saver.save_recovery(state, 4, 7)
    saver.save_recovery(state, 5, 9, epoch_complete=True)  # overwrites: epoch 5
    saver.wait_until_finished()
    assert json.loads((tmp_path / "recovery" / "meta.json").read_text())["epoch"] == 5
    saver.save_recovery(state, 6, 3)
    _, epoch = saver.restore("recovery", _tiny_state()[0])
    assert epoch == 5


def test_resume_restores_state_and_generators(tmp_path):
    """resume_checkpoint puts back the weights, optimizer state, EMA shadow,
    step, the step generator and the device's default generator; a module
    target takes the raw or the EMA weights."""
    state, opt = _tiny_state()
    opt.step(state.params(), {k: torch.ones_like(p) for k, p in state.params().items()},
             state.opt_state)
    state.step = 3
    state.ema_params = {k: v + 1 for k, v in state.ema_params.items()}
    gen = torch.Generator().manual_seed(11)
    torch.rand(5, generator=gen)
    saver = tsaver.CheckpointSaver(str(tmp_path), generator=gen)
    saver.save_checkpoint(state, 0)
    want_gen, want_default = gen.get_state(), torch.get_rng_state()
    torch.rand(7, generator=gen), torch.rand(9)

    fresh, _ = _tiny_state()
    gen2 = torch.Generator()
    got, epoch = tsaver.resume_checkpoint(str(tmp_path / "last"), fresh, generator=gen2)
    assert epoch == 0 and got is fresh and got.step == 3
    assert torch.equal(gen2.get_state(), want_gen) and torch.equal(torch.get_rng_state(),
                                                                   want_default)
    for k, v in state.model.state_dict().items():
        assert torch.equal(got.model.state_dict()[k], v), k
    assert got.opt_state["count"] == 1
    for k in state.opt_state["mu"]:
        assert torch.equal(got.opt_state["mu"][k], state.opt_state["mu"][k])
        assert torch.equal(got.ema_params[k], state.ema_params[k])
    module, _ = tsaver.resume_checkpoint(str(tmp_path / "last"), _tiny_state()[0].model,
                                         use_ema=True)
    assert torch.equal(module[0].weight, state.ema_params["0.weight"])
    with pytest.raises(ValueError, match="optimizer state"):
        other = create_train_state(torch.nn.Sequential(torch.nn.Linear(3, 4),
                                                       torch.nn.BatchNorm1d(4)),
                                   toptim.create_optimizer("sgd"), ema_decay=0.5, device="cpu")
        tsaver.resume_checkpoint(str(tmp_path / "last"), other)


def test_export_pth_tar_loads_into_the_port_and_jax(tmp_path):
    """export_pth_tar writes the reference format: it loads with strict=True
    into the port, and JAX's load_variables_from_torch maps it onto
    variables equal to the port's weights; with use_ema, the EMA shadow's."""
    name = "mobilenet_v1"
    model = create_model(name, device="cpu", num_classes=7,
                         generator=torch.Generator().manual_seed(2))
    state = create_train_state(model, toptim.create_optimizer("lamb"), ema_decay=0.9,
                               device="cpu")
    state.ema_params = {k: v * 0.5 for k, v in state.ema_params.items()}
    shapes = init_shapes(jax_create_model(name, num_classes=7), jnp.zeros((1, 64, 64, 3)),
                         training=False)
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    for use_ema in (False, True):
        path = str(tmp_path / f"{name}-{use_ema}.pth.tar")
        tsaver.export_pth_tar(state, path, use_ema=use_ema)
        want = {k: (state.ema_params.get(k, v) if use_ema else v)
                for k, v in model.state_dict().items()}
        fresh = create_model(name, device="cpu", num_classes=7)
        fresh.load_state_dict(convert.state_dict_from_checkpoint(path), strict=True)
        jvars = load_variables_from_torch(name, template, path, strict=True)
        back = convert.state_dict_from_jax(jax.tree.map(np.asarray, jvars), name)
        assert set(back) == set(want) == set(fresh.state_dict())
        for k, v in want.items():
            assert torch.equal(fresh.state_dict()[k], v), k
            assert torch.equal(back[k], v), k

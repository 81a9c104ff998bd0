"""The port's data parallelism on the CPU: two gloo ranks spawned with
torch.multiprocessing (tests/_torch_dp_child.py, which imports only the
port), held against the JAX package's 2-device steps on two of conftest's
virtual CPU devices, and against the port's one-process step.

One spawn runs every two-rank task of this file (module fixture `ranks`):
the replicated step and the ZeRO-1 steps, a checkpoint written at world 2
and one resumed from world 1, the preemption agreement and the sharded
validate. The models are test_zero1.py's BN-bearing mmcap ConvNeXt (four
stages of one block, widths 8-16: the MAP head's multi-scale input takes four
stages) at 32 px and test_torch_resnet.py's narrow MAP_ResNet at 32 px, with
random weights from numpy carried over by `state_dict_from_jax`; dropout is
off on both sides and the drop-path rate is 0. Global batches of 8 rows, 4 a
rank.

Tolerances, each that of the existing one-step parity test of the model, in
fp32 with JAX at highest precision: the ConvNeXt's tests/test_torch_train.py
(loss 1e-3 relative + 1e-5; parameters, running statistics and EMA 1e-3 of
(max|ref| + 1)), the ResNet's tests/test_torch_resnet.py (the loss as there;
parameters 2e-2 of (max|ref| + 1), where a ReLU or max-pool input near its
kink falls on the other side in the other framework); the optimizer moments,
L2 over all leaves relative to JAX's, within the parameters' factor. The
port's two ranks against its one process on the global batch: 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

import _torch_dp_child as child
from conftest import cpu_devices
from imagenet_models_tpu.models.convnext import ConvNeXt as JConvNeXt
from imagenet_models_tpu.models.resnet import MAP_ResNet as JResNet
from imagenet_models_tpu.parallel.mesh import data_mesh, shard_batch
from imagenet_models_tpu.train import losses as jloss
from imagenet_models_tpu.train import optim as joptim
from imagenet_models_tpu.train import state as jstate
from imagenet_models_tpu_torch.ckpt.convert import state_dict_from_jax
from imagenet_models_tpu_torch.ckpt.saver import CheckpointSaver, resume_checkpoint
from imagenet_models_tpu_torch.data.loader import DataLoader
from imagenet_models_tpu_torch.parallel import mesh
from imagenet_models_tpu_torch.train import engine
from torch_parity import free_port, highest, init_shapes, random_variables, spawn

NAMES = {"convnext": "map_convnext_tiny", "resnet": "map_resnet50"}
JMODELS = {"convnext": JConvNeXt(**child.CONVNEXT), "resnet": JResNet(**child.RESNET)}
CLASSES = {"convnext": 13, "resnet": 7}
# test_torch_train.py's recipe for the ConvNeXt, test_torch_resnet.py's for
# the ResNet, each with an EMA
LOSS = dict(bce_loss=True, smoothing=0.1, mixup_active=True)
RECIPES = {"convnext": {"opt": dict(learning_rate=5e-3, weight_decay=0.05), "loss": LOSS,
                        "dec_lam": -0.8, "ema": 0.9},
           "resnet": {"opt": dict(learning_rate=5e-3, weight_decay=0.02), "loss": LOSS,
                      "dec_lam": -0.8, "ema": 0.9}}
PARAM_TOL = {"convnext": 1e-3, "resnet": 2e-2}
IMG, BATCH = 32, 8


def _variables(kind):
    seed = {"convnext": 0, "resnet": 6}[kind]
    return random_variables(init_shapes(JMODELS[kind], jnp.zeros((1, IMG, IMG, 3)),
                                        training=False), seed=seed)


def _batches(kind, n=2):
    rng = np.random.default_rng({"convnext": 1, "resnet": 7}[kind])
    return [(rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32),
             rng.random((BATCH, CLASSES[kind])).astype(np.float32)) for _ in range(n)]


def _torch_batches(batches):
    return [(torch.from_numpy(x), torch.from_numpy(t)) for x, t in batches]


def _one_process(kind, weights, batches):
    """The port's one-process trainer over whole global batches: (state,
    metrics of each step)."""
    state, step = child.trainer(kind, weights, RECIPES[kind])
    metrics = []
    for x, t in _torch_batches(batches):
        state, m = step(state, x, t)
        metrics.append({k: v.item() for k, v in m.items()})
    return state, metrics


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every two-rank task, in one spawn, and what the test process made for
    them: {"work", "variables", "weights", "batches", "one", <task>: [rank 0's,
    rank 1's]}. Before the spawn, a one-process ConvNeXt state after one step
    is saved (work/ckpt1) for the ranks to resume under ZeRO-1."""
    work = tmp_path_factory.mktemp("dp")
    variables = {k: _variables(k) for k in JMODELS}
    weights = {k: state_dict_from_jax(variables[k], NAMES[k]) for k in JMODELS}
    batches = {k: _batches(k) for k in JMODELS}
    one, _ = _one_process("convnext", weights["convnext"], batches["convnext"][:1])
    gen = torch.Generator().manual_seed(5)
    saver = CheckpointSaver(str(work / "ckpt1"), generator=gen)
    saver.save_checkpoint(one, epoch=3, metric=1.0)
    saver.close()

    rng = np.random.default_rng(11)
    val_images = rng.standard_normal((11, 4, 4, 3)).astype(np.float32)
    val_labels = rng.integers(0, 13, 11)
    val_labels[::3] = val_images.reshape(11, -1)[::3, :13].argmax(1)  # some are right
    train = lambda kind, zero1, **kw: dict(
        task="train", model=kind, weights=weights[kind], recipe=RECIPES[kind], zero1=zero1,
        batches=_torch_batches(batches[kind]), **kw)
    inputs = {
        "replicated": {**train("convnext", False), "batches": _torch_batches(batches["convnext"][:1])},
        "zero1_convnext": train("convnext", True, save=str(work / "ckpt2")),
        "zero1_resnet": train("resnet", True),
        "resume1": dict(task="resume", model="convnext", weights=weights["convnext"],
                        recipe=RECIPES["convnext"], zero1=True, path=str(work / "ckpt1" / "last")),
        "preempt": dict(task="preempt"),
        "validate": dict(task="validate", images=val_images, labels=val_labels, batch=4, tta=0),
    }
    torch.save(inputs, work / "inputs.pt")
    out = spawn(work, inputs)
    return {"work": work, "variables": variables, "weights": weights, "batches": batches,
            "one": one, "gen1": gen.get_state(), "val": (val_images, val_labels), **out}


def _jax_steps(kind, variables, batches, zero1: bool):
    """JAX's 2-device step (shard_map, or the zero1 global jit) over the
    global batches: (state, losses)."""
    recipe = RECIPES[kind]
    mesh_ = data_mesh(cpu_devices(2))
    tx = joptim.create_optimizer("lamb", **recipe["opt"])
    st = jstate.place_state(jstate.create_train_state(jax.tree.map(jnp.asarray, variables), tx,
                                                      ema_decay=recipe["ema"]), mesh_, zero1=zero1)
    step = jstate.make_train_step(JMODELS[kind], tx, jloss.create_loss_fn(**recipe["loss"]),
                                  dec_lam=recipe["dec_lam"], ema_decay=recipe["ema"], mesh=mesh_,
                                  zero1=zero1)
    losses = []
    with pytest.MonkeyPatch.context() as mp, highest():
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        for i, (x, t) in enumerate(batches):
            x, t = shard_batch((x, t), mesh_)
            st, m = step(st, x, t, jax.random.PRNGKey(i))
            losses.append(float(m["loss"]))
    return st, losses


def _sd(kind, params, batch_stats=None):
    tree = {"params": jax.tree.map(np.asarray, params)}
    if batch_stats is not None:
        tree["batch_stats"] = jax.tree.map(np.asarray, batch_stats)
    return state_dict_from_jax(tree, NAMES[kind])


def _close_leaves(got, ref, tol, what):
    assert set(got) == set(ref), what
    for k, r in ref.items():
        r = r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r)
        err = np.abs(got[k].numpy() - r).max()
        assert err <= tol * (np.abs(r).max() + 1), (what, k, err)


def _rel_l2(got, ref):
    cat = lambda d: torch.cat([d[k].float().flatten() for k in sorted(ref)])
    return ((cat(got) - cat(ref)).norm() / cat(ref).norm()).item()


def _same_on_every_rank(results):
    a, b = results
    for part in ("model", "ema"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)


def test_replicated_step_matches_jax_shard_map(ranks):
    """One LAMB step of the replicated formulation (per-rank BatchNorm
    statistics; gradients, loss and running statistics mean-all-reduced)
    against JAX's shard_map step on the same global batch: the loss, the
    parameters, the running statistics and the EMA shadow after it."""
    res = ranks["replicated"]
    _same_on_every_rank(res)
    jst, losses = _jax_steps("convnext", ranks["variables"]["convnext"],
                             ranks["batches"]["convnext"][:1], zero1=False)
    got = res[0]["metrics"][0]["loss"]
    assert abs(got - losses[0]) <= 1e-3 * abs(losses[0]) + 1e-5, (got, losses)
    tol = PARAM_TOL["convnext"]
    _close_leaves(res[0]["model"], _sd("convnext", jst.params, jst.batch_stats), tol, "live")
    ema = {**res[0]["ema"], **res[0]["ema_batch_stats"]}
    _close_leaves(ema, _sd("convnext", jst.ema_params, jst.ema_batch_stats), tol, "ema")


@pytest.mark.parametrize("kind", ["convnext", "resnet"])
def test_zero1_step_matches_jax_zero1(ranks, kind):
    """Two ZeRO-1 steps with EMA against JAX's zero1=True step
    (test_zero1.py's formulation): synchronised BatchNorm statistics give
    JAX's global-batch statistics. The losses, the parameters and running
    statistics, the EMA shadow and the LAMB moments, gathered from their
    owners."""
    res = ranks[f"zero1_{kind}"]
    _same_on_every_rank(res)
    jst, losses = _jax_steps(kind, ranks["variables"][kind], ranks["batches"][kind], zero1=True)
    for m, ref in zip(res[0]["metrics"], losses):
        assert abs(m["loss"] - ref) <= 1e-3 * abs(ref) + 1e-5, (res[0]["metrics"], losses)
    tol = PARAM_TOL[kind]
    _close_leaves(res[0]["model"], _sd(kind, jst.params, jst.batch_stats), tol, "live")
    ema = {**res[0]["ema"], **res[0]["ema_batch_stats"]}
    _close_leaves(ema, _sd(kind, jst.ema_params, jst.ema_batch_stats), tol, "ema")
    lamb = jst.opt_state[0]
    for moment in ("mu", "nu"):
        ref = _sd(kind, getattr(lamb, moment))
        for r in range(2):
            assert set(res[r]["opt"][moment]) == set(ref)
            assert _rel_l2(res[r]["opt"][moment], ref) <= tol, (moment, r)
    assert res[0]["opt"]["count"] == int(lamb.count) == 2


def test_two_rank_step_equals_one_process(ranks):
    """The two-rank ZeRO-1 ConvNeXt steps against the port's one-process
    steps on the global batches, fp32: losses, grad norms, parameters,
    running statistics, EMA shadow and moments within 1e-5."""
    res = ranks["zero1_convnext"][0]
    one, metrics = _one_process("convnext", ranks["weights"]["convnext"],
                                ranks["batches"]["convnext"])
    for got, ref in zip(res["metrics"], metrics):
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - ref[k]) <= 1e-5 * abs(ref[k]), (k, res["metrics"], metrics)
    _close_leaves(res["model"], one.model.state_dict(), 1e-5, "live")
    _close_leaves({**res["ema"], **res["ema_batch_stats"]},
                  {**one.ema_params, **one.ema_batch_stats}, 1e-5, "ema")
    for moment in ("mu", "nu"):
        assert _rel_l2(res["opt"][moment], one.opt_state[moment]) <= 1e-5, moment


def test_zero1_owners_rule():
    """Largest leaf first, each to the least-loaded rank (ties: the lowest
    rank, then the mapping's order)."""
    leaves = {"a": torch.zeros(3), "b": torch.zeros(10), "c": torch.zeros(4), "d": torch.zeros(4),
              "e": torch.zeros(1)}
    assert mesh.zero1_owners(leaves, 2) == {"b": 0, "c": 1, "d": 1, "a": 1, "e": 0}
    assert mesh.zero1_owners(leaves, 1) == dict.fromkeys(leaves, 0)
    assert set(mesh.zero1_owners(leaves, 8).values()) == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("kind", ["convnext", "resnet"])
def test_zero1_ownership_is_the_same_on_every_rank(ranks, kind):
    """Both ranks hold one ownership map that covers every parameter once;
    each rank's optimizer moments and EMA shadow hold exactly its leaves;
    the ranks' element counts differ by at most the largest leaf."""
    a, b = ranks[f"zero1_{kind}"]
    assert a["owners"] == b["owners"]
    owners = a["owners"]
    assert set(owners) == set(a["model"]) - {k for k in a["model"] if k.endswith(
        ("running_mean", "running_var"))}
    assert set(owners.values()) == {0, 1}
    for r, res in enumerate((a, b)):
        mine = sorted(k for k, o in owners.items() if o == r)
        assert res["owned_opt"] == mine and res["owned_ema"] == mine
    sizes = {k: a["model"][k].numel() for k in owners}
    load = [sum(n for k, n in sizes.items() if owners[k] == r) for r in (0, 1)]
    assert abs(load[0] - load[1]) <= max(sizes.values())


def test_preemption_is_agreed_across_ranks(ranks):
    """A SIGTERM on rank 1 alone, during batch 1: both ranks save and raise
    at the next sync point (batch 3, log interval 3), rank 0 included."""
    for res in ranks["preempt"]:
        assert res["raised"] == "epoch 0 batch 3", res
        assert res["ran"] == [0, 1, 2, 3]


def test_validate_with_an_uneven_tail_equals_one_pass(ranks):
    """11 samples in global batches of 4 over two ranks (the tail: 2 rows and
    1, the second padded): the all-reduced top-1 and top-5 equal one
    process's pass over the whole set, to the float32 rounding of a batch's
    mean flag that the meters take (1e-6 relative; 1.2e-8 measured here)."""
    images, labels = ranks["val"]
    loader = DataLoader(child.Samples(images, labels), 4, lambda img, rng: img, num_workers=1)
    ref, _ = engine.validate(child.flags_step, loader, torch.device("cpu"))
    assert [r["local_sizes"] for r in ranks["validate"]] == [[2, 2, 2], [2, 2, 1]]
    assert 0 < ref["top1"] < ref["top5"] < 100
    for res in ranks["validate"]:
        for k in ("top1", "top5"):
            assert abs(res["metrics"][k] - ref[k]) <= 1e-6 * ref[k], (k, res["metrics"], ref)


def _equal_trees(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        assert torch.equal(a[k], b[k]), (what, k)


def test_checkpoint_from_world_2_resumes_at_world_1(ranks):
    """The ZeRO-1 checkpoint written by two ranks resumes into a one-process
    state with the ranks' state: weights, running statistics, every LAMB
    moment, the EMA shadow, the step and rank 0's generator."""
    res = ranks["zero1_convnext"][0]
    state, _ = child.trainer("convnext", ranks["weights"]["convnext"], RECIPES["convnext"])
    gen = torch.Generator()
    state, epoch = resume_checkpoint(str(ranks["work"] / "ckpt2" / "last"), state, generator=gen)
    assert epoch == 0 and state.step == res["step"] == 2
    _equal_trees(state.model.state_dict(), res["model"], "model")
    _equal_trees(state.ema_params, res["ema"], "ema")
    _equal_trees(state.ema_batch_stats, res["ema_batch_stats"], "ema_batch_stats")
    for moment in ("mu", "nu"):
        _equal_trees(state.opt_state[moment], res["opt"][moment], moment)
    assert state.opt_state["count"] == res["opt"]["count"] == 2
    assert torch.equal(gen.get_state(), res["generator"])


def test_checkpoint_from_world_1_resumes_at_world_2(ranks):
    """A one-process checkpoint resumed by two ZeRO-1 ranks: each rank holds
    the saved weights and its own leaves of the saved moments and EMA
    shadow; rank 0 takes the saved generator, rank 1 keeps its own."""
    one = ranks["one"]
    for r, res in enumerate(ranks["resume1"]):
        assert res["epoch"] == 3 and res["step"] == one.step == 1
        _equal_trees(res["model"], one.model.state_dict(), "model")
        mine = res["owned_opt"]
        assert sorted(res["mu_part"]) == mine == sorted(res["ema_part"])
        _equal_trees(res["mu_part"], {k: one.opt_state["mu"][k] for k in mine}, "mu")
        _equal_trees(res["ema_part"], {k: one.ema_params[k] for k in mine}, "ema")
        _equal_trees(res["opt"]["nu"], one.opt_state["nu"], "nu (gathered)")
    assert torch.equal(ranks["resume1"][0]["generator"], ranks["gen1"])
    assert torch.equal(ranks["resume1"][1]["generator"], ranks["resume1"][1]["fresh_generator"])


@pytest.mark.parametrize("zero1", [False, True])
def test_world_1_group_gives_the_one_process_bits(zero1):
    """Over a gloo group of one rank, both formulations (the all-reduce, the
    broadcast from rank 0, synchronised BatchNorm statistics) give the
    one-process steps' bits: losses, grad norms, weights, EMA and moments."""
    weights = state_dict_from_jax(_variables("convnext"), NAMES["convnext"])
    batches = _batches("convnext")
    one, metrics = _one_process("convnext", weights, batches)
    mesh.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=torch.device("cpu"))
    try:
        state, step = child.trainer("convnext", weights, RECIPES["convnext"], mesh.data_group(),
                                    zero1)
        for (x, t), ref in zip(_torch_batches(batches), metrics):
            state, m = step(state, x, t)
            assert {k: v.item() for k, v in m.items()} == ref
    finally:
        mesh.destroy()
    _equal_trees(state.model.state_dict(), one.model.state_dict(), "model")
    _equal_trees(state.ema_params, one.ema_params, "ema")
    for moment in ("mu", "nu"):
        _equal_trees(state.opt_state[moment], one.opt_state[moment], moment)

"""The port's train and validate entries on the CPU (IMTPU_PLATFORM=cpu):
one tiny subprocess run of `python -m imagenet_models_tpu_torch.cli.train`
(the JAX dry run's CLI smoke, `__graft_entry__._dryrun_train_cli`, on the
port) and a two-process one over gloo, and in-process runs that check
resume, the checkpoints, the validate entry, the split-BN and device-count
flags and a one-rank process group. mobilenet_v1 at 64 px with batches of 2 keeps each run to
seconds."""

import csv
import glob
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from imagenet_models_tpu_torch.ckpt.saver import export_pth_tar
from imagenet_models_tpu_torch.cli import train as cli_train
from imagenet_models_tpu_torch.cli import validate as cli_validate
from torch_parity import free_port

REPO = Path(__file__).resolve().parent.parent
SMOKE = ["synthetic:64", "--model", "mobilenet_v1", "--input-size", "3", "64", "64", "-b", "2",
         "--epochs", "2", "--cooldown-epochs", "0", "--max-steps-per-epoch", "2", "--bce-loss",
         "-j", "1", "--log-interval", "1"]
# the resume case: 2 steps an epoch with nothing truncated, a step schedule
# whose warmup makes each epoch's LR its own and does not depend on --epochs,
# mixup (its generator is keyed by the epoch), EMA; 6 classes, so that top-1
# is not 0 by chance and top-5 is not 100 (the eval step takes a top 5)
RESUME = ["synthetic:4", "--model", "mobilenet_v1", "--input-size", "3", "64", "64", "-b", "2",
          "--num-classes", "6", "--sched", "step", "--warmup-epochs", "5", "--lr", "1e-2",
          "--mixup", "0.8", "--cutmix", "1.0", "--model-ema", "--model-ema-decay", "0.9",
          "-j", "1", "--log-interval", "1", "--seed", "3"]
VALIDATE = ["synthetic:4", "--model", "mobilenet_v1", "--input-size", "3", "64", "64",
            "-b", "2", "--num-classes", "6", "-j", "1"]


def test_cli_smoke_subprocess(tmp_path):
    """`python -m imagenet_models_tpu_torch.cli.train` exits 0 on the CPU and
    writes summary.csv with one row an epoch, and a checkpoint per epoch."""
    env = dict(os.environ, PYTHONPATH=str(REPO), IMTPU_PLATFORM="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "imagenet_models_tpu_torch.cli.train", *SMOKE,
                           "--output", str(tmp_path)], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    [summary] = glob.glob(str(tmp_path / "*" / "summary.csv"))
    with open(summary) as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert set(rows[0]) == {"epoch", "train_loss", "eval_top1", "eval_top5", "lr"}
    run = Path(summary).parent
    assert {"checkpoint-0", "checkpoint-1", "last", "model_best", "args.yaml"} <= set(
        os.listdir(run))
    assert "host decoder: PIL" in proc.stderr


def test_cli_needs_the_gpu_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    """Without IMTPU_PLATFORM=cpu the entry runs on the GPU, and raises where
    there is none instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is for a host without one")
    monkeypatch.delenv("IMTPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_train.main([*SMOKE, "--output", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_validate.main(VALIDATE)


def test_two_process_cli_smoke(tmp_path):
    """Two processes of `python -m imagenet_models_tpu_torch.cli.train` on
    gloo (--dist-coordinator, --zero1, global batch 2 x 2) exit 0 and write
    one run directory: rank 0's name, its summary.csv and checkpoints."""
    env = dict(os.environ, PYTHONPATH=str(REPO), IMTPU_PLATFORM="cpu", OMP_NUM_THREADS="1")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "imagenet_models_tpu_torch.cli.train", *SMOKE, "--epochs", "1",
         "--zero1", "--model-ema", "--dist-coordinator", f"127.0.0.1:{port}",
         "--dist-num-processes", "2", "--dist-process-id", str(rank), "--output", str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)]
    logs = [p.communicate(timeout=300)[1] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [log[-3000:] for log in logs]
    [run] = os.listdir(tmp_path)
    with open(tmp_path / run / "summary.csv") as f:
        assert [r["epoch"] for r in csv.DictReader(f)] == ["0"]
    assert {"checkpoint-0", "last", "model_best", "args.yaml"} <= set(os.listdir(tmp_path / run))
    assert "global batch 4 = 2/dev x 2 dev x 1 accum" in logs[0]
    assert "Train:" in logs[0] and "Train:" not in logs[1]  # progress on rank 0 alone


def _in_process(monkeypatch, argv):
    monkeypatch.setenv("IMTPU_PLATFORM", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return cli_train.main(argv)
    finally:
        torch.set_num_threads(threads)


def test_split_bn_runs_at_one_process(monkeypatch, tmp_path):
    """--split-bn with --aug-splits 2 (and the JSD loss) trains and evaluates."""
    result = _in_process(monkeypatch, [*SMOKE, "--epochs", "1", "--split-bn", "--aug-splits", "2",
                                       "--jsd-loss", "--output", str(tmp_path)])
    assert result["exit"] == "done" and len(result["epochs"]) == 1
    assert result["epochs"][0]["train"]["loss"] == result["epochs"][0]["train"]["loss"]


@pytest.mark.parametrize("flags,message", [
    (["--split-bn"], "--aug-splits >= 2"),
    (["--split-bn", "--aug-splits", "2", "--sync-bn"], "mutually exclusive")])
def test_split_bn_flag_rules(flags, message, monkeypatch, tmp_path):
    """--split-bn needs --aug-splits >= 2 and excludes --sync-bn, with the
    JAX CLI's messages."""
    with pytest.raises(ValueError, match=message):
        _in_process(monkeypatch, [*SMOKE, *flags, "--output", str(tmp_path)])


@pytest.mark.parametrize("n", [1, 2])
def test_n_devices_is_the_number_of_processes(n, monkeypatch, tmp_path):
    """--n-devices must be absent or the world size: one process runs with
    1 and refuses 2, since a process drives one device."""
    argv = [*SMOKE, "--epochs", "1", "--n-devices", str(n), "--output", str(tmp_path)]
    if n == 1:
        assert _in_process(monkeypatch, argv)["exit"] == "done"
    else:
        with pytest.raises(ValueError, match="a process drives one GPU"):
            _in_process(monkeypatch, argv)


def test_world_1_group_run_equals_the_one_process_run(monkeypatch, tmp_path):
    """The entry over a gloo group of one rank, --zero1 (with --sync-bn and
    --dist-bn, accepted) writes the one-process run's checkpoint bit for bit:
    weights, BatchNorm statistics, LAMB moments, EMA shadow, step."""
    base = [*RESUME, "--epochs", "1", "--output", str(tmp_path)]
    _in_process(monkeypatch, [*base, "--experiment", "one"])
    dist_run = _in_process(monkeypatch, [
        *base, "--experiment", "group", "--zero1", "--sync-bn", "--dist-bn", "reduce",
        "--dist-coordinator", f"127.0.0.1:{free_port()}", "--dist-num-processes", "1",
        "--dist-process-id", "0"])
    assert dist_run["world"] == 1 and dist_run["exit"] == "done"
    a = torch.load(tmp_path / "one" / "last" / "state.pt", weights_only=True)
    b = torch.load(tmp_path / "group" / "last" / "state.pt", weights_only=True)
    assert a["step"] == b["step"] == 2
    for part in ("model", "ema_params", "ema_batch_stats"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for moment in ("mu", "nu"):
        for k in a["opt_state"][moment]:
            assert torch.equal(a["opt_state"][moment][k], b["opt_state"][moment][k]), (moment, k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three in-process runs on one thread (restored after): an
    uninterrupted 2-epoch run, a 1-epoch run, and a resume of the latter
    from its `last` checkpoint for the second epoch."""
    out = tmp_path_factory.mktemp("runs")
    threads = torch.get_num_threads()
    old = os.environ.get("IMTPU_PLATFORM")
    os.environ["IMTPU_PLATFORM"] = "cpu"
    torch.set_num_threads(1)
    try:
        base = [*RESUME, "--output", str(out)]
        full = cli_train.main([*base, "--epochs", "2", "--experiment", "full"])
        first = cli_train.main([*base, "--epochs", "1", "--experiment", "first"])
        resumed = cli_train.main([*base, "--epochs", "2", "--experiment", "resumed",
                                  "--resume", str(out / "first" / "last")])
    finally:
        torch.set_num_threads(threads)
        if old is None:
            os.environ.pop("IMTPU_PLATFORM", None)
        else:
            os.environ["IMTPU_PLATFORM"] = old
    return out, full, first, resumed


def test_resume_round_trip_is_bit_equal(runs):
    """A run resumed from `last` after its first epoch trains the second epoch
    exactly as the uninterrupted run does: the same loss and, after it, the
    same weights, EMA shadow, optimizer state, step and step generator."""
    out, full, first, resumed = runs
    assert [e["epoch"] for e in full["epochs"]] == [0, 1] and full["exit"] == "done"
    assert first["epochs"][0]["train"] == full["epochs"][0]["train"]
    assert resumed["start_epoch"] == 1 and [e["epoch"] for e in resumed["epochs"]] == [1]
    assert resumed["epochs"][0]["train"]["loss"] == full["epochs"][1]["train"]["loss"]
    a = torch.load(out / "full" / "checkpoint-1" / "state.pt", weights_only=True)
    b = torch.load(out / "resumed" / "checkpoint-1" / "state.pt", weights_only=True)
    assert a["step"] == b["step"] == 4 and torch.equal(a["generator"], b["generator"])
    for part in ("model", "ema_params", "ema_batch_stats"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 4
    for k in a["opt_state"]["mu"]:
        assert torch.equal(a["opt_state"]["mu"][k], b["opt_state"]["mu"][k]), k
        assert torch.equal(a["opt_state"]["nu"][k], b["opt_state"]["nu"][k]), k
    assert not torch.equal(a["model"]["fc.2.weight"],
                           torch.load(out / "full" / "checkpoint-0" / "state.pt",
                                      weights_only=True)["model"]["fc.2.weight"])


def test_validate_entry_reads_the_checkpoint_and_the_pth_tar(runs, monkeypatch, tmp_path):
    """The validate entry on `model_best` reports the engine's eval of the
    same weights: the EMA weights' top-1/top-5 with --use-ema (THE eval
    metrics), the raw model's without; a reference .pth.tar exported from
    the checkpoint validates to the raw model's numbers too."""
    out, full, _, _ = runs
    monkeypatch.setenv("IMTPU_PLATFORM", "cpu")
    best = full["epochs"][full["best_epoch"]]["eval"]
    ckpt = str(out / "full" / "model_best")
    pth = str(tmp_path / "best.pth.tar")
    export_pth_tar(ckpt, pth)
    results_file = str(tmp_path / "results.csv")
    [ema] = cli_validate.main([*VALIDATE, "--checkpoint", ckpt, "--use-ema",
                               "--results-file", results_file])
    [raw] = cli_validate.main([*VALIDATE, "--checkpoint", ckpt])
    [ref] = cli_validate.main([*VALIDATE, "--checkpoint", pth])
    assert (ema["top1"], ema["top5"]) == (round(best["top1"], 4), round(best["top5"], 4))
    assert (raw["top1"], raw["top5"]) == (round(best["raw_top1"], 4), round(best["raw_top5"], 4))
    assert (ref["top1"], ref["top5"]) == (raw["top1"], raw["top5"])
    with open(results_file) as f:
        assert [r["top1"] for r in csv.DictReader(f)] == [str(ema["top1"])]

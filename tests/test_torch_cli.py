"""The port's train and validate entries on the CPU (IMTPU_PLATFORM=cpu):
one tiny subprocess run of `python -m imagenet_models_tpu_torch.cli.train`
(the JAX dry run's CLI smoke, `__graft_entry__._dryrun_train_cli`, on the
port), and in-process runs that check resume, the checkpoints and the
validate entry. mobilenet_v1 at 64 px with batches of 2 keeps each run to
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


@pytest.mark.parametrize("flags,item", [
    (["--zero1"], "item 2"), (["--dist-coordinator", "127.0.0.1:1"], "item 2"),
    (["--sync-bn"], "item 2"), (["--split-bn", "--aug-splits", "2"], "item 2"),
    (["-fp", "x.pth.tar"], "item 10"), (["-pt"], "item 10")])
def test_unported_flags_raise(flags, item, monkeypatch, tmp_path):
    """A flag whose feature is not ported raises, naming its ROADMAP item."""
    monkeypatch.setenv("IMTPU_PLATFORM", "cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, {item}"):
        cli_train.main([*SMOKE, *flags, "--output", str(tmp_path)])


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

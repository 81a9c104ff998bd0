"""The port's recipe runner (`imagenet_models_tpu_torch.cli.train_with_script`)
against the JAX package's root `train_with_script.py`: the same seven preset
lines, each parsed by the port's `cli.train._parse_args` into the namespace
JAX's `train._parse_args` gives, and the runner's overrides, its setup x
model product and its `--dist-*` and `-fp`/`-pt` forwarding reaching `run`,
which is stubbed on both sides (no training runs)."""

import copy
import sys

import pytest

import train_with_script as jax_tws
from imagenet_models_tpu_torch.cli import train_with_script as tws

# `--local-rank` defaults to None in the port: a given rank means
# `--dist-coordinator auto` there (cli/train.py's help), where JAX's 0 is
# the one-process default
PORT_ONLY_DEFAULTS = {"local_rank"}


@pytest.fixture()
def captured(monkeypatch):
    """`run` of both runners stubbed: their namespaces, snapshotted at call
    time (one namespace is mutated per setup), by side."""
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(tws, "run", lambda a, t: calls["port"].append((copy.deepcopy(a), t)))
    monkeypatch.setattr(jax_tws, "run", lambda a, t: calls["jax"].append((copy.deepcopy(a), t)))
    return calls


def _main(monkeypatch, argv, module=tws):
    monkeypatch.setattr(sys, "argv", ["train_with_script.py"] + argv)
    module.main()


def _shared(port, ref) -> dict:
    """Keys both namespaces have whose values differ, the known one aside."""
    p, j = vars(port), vars(ref)
    return {k: (p[k], j[k]) for k in set(p) & set(j) - PORT_ONLY_DEFAULTS if p[k] != j[k]}


def test_presets_are_jax_word_for_word():
    assert tws.setting_dict == jax_tws.setting_dict
    assert len(tws.setting_dict) == 7


@pytest.mark.parametrize("setup", sorted(jax_tws.setting_dict))
def test_preset_parses_as_jax(setup):
    port, _ = tws._parse_args(tws.setting_dict[setup].split())
    ref, _ = jax_tws._parse_args(jax_tws.setting_dict[setup].split())
    assert set(vars(ref)) <= set(vars(port))
    assert _shared(port, ref) == {}


def test_runner_flags_are_jax():
    port = {a.dest: (tuple(a.option_strings), a.default, a.nargs)
            for a in tws.get_multi_args_parser()._actions}
    ref = {a.dest: (tuple(a.option_strings), a.default, a.nargs)
           for a in jax_tws.get_multi_args_parser()._actions}
    assert port == ref


def test_recipe_values_and_overrides(monkeypatch, captured):
    argv = ["convnext_tiny", "-m", "map_convnext_tiny", "--data-dir", "synthetic:64",
            "--epochs", "2", "-b", "4", "-tb", "8", "--max-steps-per-epoch", "3", "-s", "7",
            "--dec-lam", "-0.5", "--distill-tokens", "2", "--token-distillation", "0",
            "-e", "5", "--zero1", "-r", "out/last", "-ri", "abc", "-cp", "init.pth.tar",
            "-es", "9"]
    _main(monkeypatch, argv)
    _main(monkeypatch, argv, jax_tws)
    assert len(captured["port"]) == 1
    args, args_text = captured["port"][0]
    assert args.opt == "lamb" and args.bce_loss and args.smoothing == 0.1
    assert args.drop_path == 0.1 and args.model_ema_decay == 0.9999
    assert args.aug_repeats == 3 and args.crop_pct == 0.875
    assert args.model == "map_convnext_tiny" and args.data_dir == "synthetic:64"
    assert args.epochs == 2 and args.batch_size == 4
    assert args.total_batch_size == 8 and args.max_steps_per_epoch == 3
    assert args.seed == 7 and args.eval_epoch == 5 and args.early_stop == 9
    assert args.dec_lam == -0.5
    assert args.distill_tokens == 2 and args.token_distillation == 0
    assert args.zero1 and args.resume == "out/last" and args.resume_id == "abc"
    assert args.initial_checkpoint == "init.pth.tar"
    assert "lamb" in args_text
    assert _shared(args, captured["jax"][0][0]) == {}


def test_setup_x_model_product(monkeypatch, captured):
    argv = ["mobilenet_v1", "convnext_tiny", "-m", "map_mobilenet_v1", "map_convnext_tiny",
            "--data-dir", "synthetic:32"]
    _main(monkeypatch, argv)
    _main(monkeypatch, argv, jax_tws)
    assert [(a.model, a.epochs) for a, _ in captured["port"]] == [
        ("map_mobilenet_v1", 100), ("map_convnext_tiny", 100),
        ("map_mobilenet_v1", 300), ("map_convnext_tiny", 300)]
    mob = captured["port"][0][0]
    assert mob.input_size == [3, 160, 160] and mob.reprob == 0.0
    for (port, _), (ref, _) in zip(captured["port"], captured["jax"], strict=True):
        assert _shared(port, ref) == {}


def test_dist_flags_reach_run(monkeypatch, captured):
    argv = ["convnext_tiny", "-m", "map_convnext_tiny", "--data-dir", "synthetic:32",
            "--dist-coordinator", "localhost:1234", "--dist-num-processes", "4",
            "--dist-process-id", "2"]
    _main(monkeypatch, argv)
    args = captured["port"][0][0]
    assert args.dist_coordinator == "localhost:1234"
    assert args.dist_num_processes == 4 and args.dist_process_id == 2
    captured["port"].clear()
    _main(monkeypatch, argv[:5])
    assert captured["port"][0][0].dist_coordinator == ""


def test_finetune_flags_reach_run(monkeypatch, captured):
    _main(monkeypatch, ["resnet50", "-m", "map_resnet50", "-fp", "ft.pth.tar", "-pt",
                        "--data-dir", "synthetic:32"])
    args = captured["port"][0][0]
    assert args.finetuning_checkpoint == "ft.pth.tar" and args.in21k_to_in1k is True

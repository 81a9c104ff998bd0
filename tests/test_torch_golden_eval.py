"""The port's golden-eval harness (`imagenet_models_tpu_torch.cli.golden_eval`)
against the JAX package's `scripts/golden_eval.py`, offline: the golden
table, the data-config check on the port's registry (and the port's default
cfgs against JAX's), checkpoint resolution, the SKIPPED verdicts and their
command, the result parser and the judge. No checkpoint is downloaded:
`--no-download` is passed and `try_download` is replaced by one that fails
the test if it is called."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import golden_eval as jax_golden  # noqa: E402
import imagenet_models_tpu.models  # noqa: E402,F401  (registers the JAX cfgs)
from imagenet_models_tpu.core.registry import default_cfg as jax_default_cfg  # noqa: E402
from imagenet_models_tpu_torch import default_cfg  # noqa: E402
from imagenet_models_tpu_torch.cli import golden_eval  # noqa: E402

CFG_KEYS = ("input_size", "crop_pct", "interpolation", "mean", "std", "crop_mode")


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    def refuse(name, timeout=30.0):
        raise AssertionError(f"try_download({name}) called in an offline test")

    monkeypatch.setattr(golden_eval, "try_download", refuse)


def test_golden_table_is_jax():
    assert golden_eval.GOLDEN == jax_golden.GOLDEN
    assert golden_eval.GOLDEN_DATA_CFG == jax_golden.GOLDEN_DATA_CFG
    assert len(golden_eval.GOLDEN) == 7


@pytest.mark.parametrize("name", sorted(jax_golden.GOLDEN))
def test_data_config_and_default_cfg_match_jax(name):
    c = golden_eval.check_data_config(name)
    assert c["data_config_ok"], (name, c["mismatches"])
    port, ref = default_cfg(name), jax_default_cfg(name)
    assert {k: port.get(k) for k in CFG_KEYS} == {k: ref.get(k) for k in CFG_KEYS}


def test_unknown_model_fails_loudly():
    with pytest.raises(KeyError):
        golden_eval.check_data_config("map_not_a_model")


def test_resolve_checkpoint_in_the_port_dirs(tmp_path, monkeypatch):
    env_dir = tmp_path / "pre"
    env_dir.mkdir()
    (env_dir / "map_pit_s.pth.tar").write_bytes(b"x")
    monkeypatch.setenv("IMTPU_PRETRAINED_DIR", str(env_dir))
    monkeypatch.chdir(tmp_path)
    assert golden_eval.checkpoint_search_dirs()[0] == str(env_dir)
    assert golden_eval.resolve_checkpoint("map_pit_s") == str(env_dir / "map_pit_s.pth.tar")
    assert golden_eval.resolve_checkpoint("map_resnet50") is None


@pytest.mark.parametrize("top1,top5,expect", [(83.166, 96.272, "PASS"), (83.366, 96.472, "PASS"),
                                              (83.40, 96.272, "FAIL"), (83.166, 95.9, "FAIL")])
def test_judge_is_jax(top1, top5, expect):
    result = {"top1": top1, "top5": top5}
    v = golden_eval.judge("map_convnext_tiny", result, tol=0.2)
    assert v["status"] == expect
    assert v == jax_golden.judge("map_convnext_tiny", result, tol=0.2)


def test_main_skips_offline_with_the_port_command(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("IMTPU_PRETRAINED_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "verdict.json"
    rc = golden_eval.main(["/data/imagenet", "--no-download", "--out", str(out)])
    assert rc == 0
    summary = json.loads(out.read_text())
    assert summary["n_skipped"] == 7 and summary["n_fail"] == 0
    assert summary["n_data_config_mismatch"] == 0
    for v in summary["verdicts"]:
        assert v["status"] == "SKIPPED"
        assert v["command"].startswith("python -m imagenet_models_tpu_torch.cli.validate ")
        assert "--crop-pct" in v["command"] and v["model"] in v["command"]
    assert "SKIPPED" in capsys.readouterr().out


def test_parse_result_json_handles_trailing_braces():
    result = {"top1": 83.1, "top5": 96.2, "param_count": 47.83}
    out = ("noise\n--result\n" + json.dumps(result, indent=4)
           + "\ntrailing log {with: braces} and }\n{\"not\": \"the result\"}\n")
    assert golden_eval.parse_result_json(out, "m") == result
    with pytest.raises(RuntimeError, match="no --result"):
        golden_eval.parse_result_json("no marker here", "m")
    with pytest.raises(RuntimeError, match="no --result JSON"):
        golden_eval.parse_result_json("--result\nnot json {{{", "m")


def test_main_judges_a_pass_and_a_fail(tmp_path, monkeypatch):
    pre = tmp_path / "pre"
    pre.mkdir()
    (pre / "map_mobilenet_v1.pth.tar").write_bytes(b"x")
    (pre / "map_pit_s.pth.tar").write_bytes(b"x")
    monkeypatch.setenv("IMTPU_PRETRAINED_DIR", str(pre))
    monkeypatch.chdir(tmp_path)

    def fake_validate(name, ckpt, data, batch_size=256, extra=()):
        assert os.path.isfile(ckpt)
        if name == "map_mobilenet_v1":
            return {"top1": 73.43, "top5": 91.364}
        return {"top1": 80.0, "top5": 95.0}

    monkeypatch.setattr(golden_eval, "run_validate", fake_validate)
    out = tmp_path / "verdict.json"
    assert golden_eval.main(["/data/imagenet", "--no-download", "--model", "map_mobilenet_v1",
                             "--out", str(out)]) == 0
    assert json.loads(out.read_text())["n_pass"] == 1
    assert golden_eval.main(["/data/imagenet", "--no-download", "--model", "map_pit_s",
                             "--out", str(out)]) == 1
    assert json.loads(out.read_text())["n_fail"] == 1

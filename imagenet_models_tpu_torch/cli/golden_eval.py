#!/usr/bin/env python3
"""Golden released-checkpoint evaluation of the PyTorch port: the offline
logic of the JAX package's `scripts/golden_eval.py` (the reference's de-facto
acceptance tests, its MAP/README.MD §2 golden logs), run through the port's
validate entry:

    python -m imagenet_models_tpu_torch.cli.golden_eval /path/to/imagenet-val \
        [--model NAME] [--tol 0.2] [--out golden_eval.json] [--no-download]

Per model it
  1. checks the port's resolved eval data config against the golden log
     header (`check_data_config`, on the port's registry),
  2. resolves the released checkpoint offline-first, in the port's
     pretrained directories (`ckpt.pretrained.pretrained_dirs`),
  3. downloads it from the GitHub release only if missing, where the host
     has network access and `--no-download` is not given,
  4. runs `python -m imagenet_models_tpu_torch.cli.validate` with the golden
     command's flags and diffs top-1/top-5 against the golden log at +-tol,
and emits one JSON verdict. Without a checkpoint it prints SKIPPED per model
with the exact command to run once the .pth.tar is in place.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VALIDATE = "imagenet_models_tpu_torch.cli.validate"

_RELEASE = ("https://github.com/Lab-LVM/imagenet-models/releases/download/"
            "v0.0.1/{name}.pth.tar")

# MAP/README.MD §2 golden `--result` JSONs (lines cited per model section) +
# the validate command's --crop-pct from each golden log header.
GOLDEN = {
    "map_mobilenet_v1": dict(top1=73.430, top5=91.364, param_count=4.88,
                             crop_pct=0.95),           # README.MD:105-146
    "map_resnet50": dict(top1=82.850, top5=95.946, param_count=42.71,
                         crop_pct=0.95),               # README.MD:170-211
    "map_pit_s": dict(top1=81.888, top5=95.810, param_count=36.15,
                      crop_pct=0.95),                  # README.MD:237-278
    "map_convnext_tiny": dict(top1=83.166, top5=96.272, param_count=47.83,
                              crop_pct=0.875),         # README.MD:304-345
    "map_convnext_small": dict(top1=84.050, top5=96.668, param_count=82.84,
                               crop_pct=0.875),        # README.MD:369-410
    "map_maxvit_tiny_tf_224": dict(top1=84.348, top5=96.876, param_count=49.96,
                                   crop_pct=0.95),     # README.MD:434-475
    "map_faster_vit_3_224": dict(top1=84.140, top5=96.652, param_count=187.34,
                                 crop_pct=0.95),       # README.MD:499-541
}


# Every golden log header (README.MD §2, e.g. :111-116 for mobilenet) resolves
# the SAME eval data config apart from crop_pct (which the golden command
# passes on the CLI and GOLDEN records per model):
GOLDEN_DATA_CFG = dict(
    input_size=(3, 224, 224),
    interpolation="bicubic",
    mean=(0.485, 0.456, 0.406),
    std=(0.229, 0.224, 0.225),
    crop_mode="center",
)


def check_data_config(name: str) -> dict:
    """Offline parity of the port's resolved eval data config against the
    golden log header, as `cli/validate.py` resolves it under the golden
    command's flags (--crop-pct from GOLDEN, everything else from the
    model's default cfg). Catches wrong preprocessing before a golden run
    can silently pass or fail with it. Raises KeyError on a name the port's
    registry does not hold."""
    from imagenet_models_tpu_torch.core.registry import default_cfg, list_models

    if name not in list_models():
        raise KeyError(f"{name} is not in the model registry")
    cfg = default_cfg(name)
    resolved = dict(
        input_size=(3,) + tuple(cfg["input_size"][:2]),
        interpolation=cfg["interpolation"],
        mean=tuple(cfg["mean"]),
        std=tuple(cfg["std"]),
        crop_mode=cfg.get("crop_mode", "center"),
    )
    mismatches = {k: {"ours": resolved[k], "golden": v}
                  for k, v in GOLDEN_DATA_CFG.items() if resolved[k] != v}
    return {"model": name, "data_config_ok": not mismatches,
            "mismatches": mismatches}


def checkpoint_search_dirs():
    """The port's pretrained directories (`ckpt.pretrained.pretrained_dirs`)."""
    from imagenet_models_tpu_torch.ckpt.pretrained import pretrained_dirs

    return pretrained_dirs()


def resolve_checkpoint(name: str):
    """Offline-first released-checkpoint resolution. Returns a path or None."""
    for d in checkpoint_search_dirs():
        p = os.path.join(d, f"{name}.pth.tar")
        if os.path.isfile(p):
            return p
    return None


def try_download(name: str, timeout: float = 30.0):
    """Download the release checkpoint if egress exists; None otherwise."""
    url = _RELEASE.format(name=name)
    dest_dir = os.path.expanduser("~/.cache/imtpu/checkpoints")
    dest = os.path.join(dest_dir, f"{name}.pth.tar")
    try:
        import urllib.request

        os.makedirs(dest_dir, exist_ok=True)
        tmp = dest + ".part"
        with urllib.request.urlopen(url, timeout=timeout) as r, \
                open(tmp, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
        os.replace(tmp, dest)
        return dest
    except Exception as e:  # no egress / 404 / partial download
        print(f"[golden_eval] download unavailable for {name}: {e}",
              file=sys.stderr)
        return None


def golden_command(name: str, data: str = "/path/to/imagenet-val") -> str:
    """The exact command this harness runs (printed for SKIPPED models;
    mirrors the reference's golden log header, README.MD:105 etc.)."""
    cp = GOLDEN[name]["crop_pct"]
    return (f"python -m {VALIDATE} {data} "
            f"--model {name} --checkpoint <{name}.pth.tar> "
            f"--crop-pct {cp} --amp")


def run_validate(name: str, ckpt: str, data: str, batch_size: int = 256,
                 extra=()):
    """Run the port's validate entry and parse its --result JSON."""
    cp = GOLDEN[name]["crop_pct"]
    cmd = [sys.executable, "-m", VALIDATE, data,
           "--model", name, "--checkpoint", ckpt,
           "--crop-pct", str(cp), "--amp", "-b", str(batch_size), *extra]
    path = os.environ.get("PYTHONPATH", "")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{VALIDATE} failed for {name}:\n{proc.stdout[-2000:]}"
            f"\n{proc.stderr[-2000:]}")
    return parse_result_json(proc.stdout, name)


def parse_result_json(stdout: str, name: str) -> dict:
    """Extract the --result JSON from the validate entry's output. The JSON may span
    lines (json.dumps indent) and trailing log lines may contain '}', so a
    greedy capture is unsafe: after the LAST '--result' marker, the first
    completely-parsing dict that carries 'top1' is the result."""
    marker = stdout.rfind("--result")
    if marker < 0:
        raise RuntimeError(f"no --result marker in validate output for {name}")
    tail = stdout[marker:]
    decoder = json.JSONDecoder()
    for m in re.finditer(r"\{", tail):
        try:
            obj, _ = decoder.raw_decode(tail[m.start():])
        except json.JSONDecodeError:
            continue
        if isinstance(obj, dict) and "top1" in obj:
            return obj  # first complete candidate after the marker IS the result
    raise RuntimeError(f"no --result JSON in validate output for {name}")


def judge(name: str, result: dict, tol: float) -> dict:
    """Diff a validate --result against the golden log at +-tol."""
    g = GOLDEN[name]
    d1 = result["top1"] - g["top1"]
    d5 = result["top5"] - g["top5"]
    ok = abs(d1) <= tol + 1e-9 and abs(d5) <= tol + 1e-9
    return {
        "model": name, "status": "PASS" if ok else "FAIL",
        "top1": result["top1"], "golden_top1": g["top1"],
        "delta_top1": round(d1, 3),
        "top5": result["top5"], "golden_top5": g["top5"],
        "delta_top5": round(d5, 3),
        "tol": tol,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("data", help="ImageNet validation dir "
                                 "(torch folder layout, as cli/validate.py)")
    ap.add_argument("--model", default=None,
                    help="run a single model (default: all 7)")
    ap.add_argument("--tol", type=float, default=0.2,
                    help="top-1/top-5 tolerance (BASELINE.md +-0.2)")
    ap.add_argument("--batch-size", "-b", type=int, default=256)
    ap.add_argument("--no-download", action="store_true",
                    help="never attempt network downloads")
    ap.add_argument("--out", default="golden_eval.json")
    args = ap.parse_args(argv)

    names = [args.model] if args.model else list(GOLDEN)
    verdicts = []
    cfg_checks = []
    for name in names:
        c = check_data_config(name)
        cfg_checks.append(c)
        if not c["data_config_ok"]:
            print(f"[golden_eval] DATA-CONFIG MISMATCH {name}: "
                  f"{c['mismatches']}", file=sys.stderr)
    for name in names:
        ckpt = resolve_checkpoint(name)
        if ckpt is None and not args.no_download:
            ckpt = try_download(name)
        if ckpt is None:
            verdicts.append({
                "model": name, "status": "SKIPPED",
                "reason": "released checkpoint not found and no egress; "
                          f"place {name}.pth.tar in $IMTPU_PRETRAINED_DIR "
                          "and re-run",
                "command": golden_command(name, args.data),
            })
            print(f"[golden_eval] SKIPPED {name}: no checkpoint. Run once "
                  f"available:\n    {golden_command(name, args.data)}")
            continue
        print(f"[golden_eval] {name}: validating {ckpt}")
        result = run_validate(name, ckpt, args.data, args.batch_size)
        v = judge(name, result, args.tol)
        verdicts.append(v)
        print(f"[golden_eval] {v['status']} {name}: top1 {v['top1']} vs "
              f"golden {v['golden_top1']} (delta {v['delta_top1']})")

    summary = {
        "verdicts": verdicts,
        "data_config_checks": cfg_checks,
        "n_pass": sum(v["status"] == "PASS" for v in verdicts),
        "n_fail": sum(v["status"] == "FAIL" for v in verdicts),
        "n_skipped": sum(v["status"] == "SKIPPED" for v in verdicts),
        "n_data_config_mismatch": sum(
            not c["data_config_ok"] for c in cfg_checks),
    }
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 1 if summary["n_fail"] or summary["n_data_config_mismatch"] else 0


if __name__ == "__main__":
    sys.exit(main())

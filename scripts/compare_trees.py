#!/usr/bin/env python3
"""map_convnext_tiny's eval and train img/s on the card from the package of
one checkout, measured by this checkout's chip_smoke.py: for comparing two
checkouts in turns in one call.

    python3 scripts/compare_trees.py [--root DIR] [--out FILE]

DIR is the root of a checkout (default: this one); its
`imagenet_models_tpu_torch` is imported and its LN+MLP kernels built into its
own `_build/`. The measurement is chip_smoke.py's phases 5 and 7, loaded from
this checkout whatever DIR is, so both checkouts are measured by one code:
`throughput` (eval img/s at B=256, kernel and plain path in turns),
`make_trainer` and `train_batch` (bench.py's recipe at B=128),
`train_throughput` (train img/s of both paths in turns) and `profile_step`
(the device's idle share of one kernel-path train step). Prints one JSON line
with the card's name and power limit, and appends it to FILE with --out. Run
it from each checkout in turns (A, B, B, A) in one call to compare the two on
one card. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("compare_trees: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import imagenet_models_tpu_torch as pkg
    from imagenet_models_tpu_torch.ops import _kernels
    from imagenet_models_tpu_torch.train.state import make_train_step

    if Path(pkg.__file__).resolve().parents[1] != root:
        raise AssertionError(f"imported {pkg.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    _kernels.build_all(["ln_mlp_fwd", "ln_mlp_bwd"])
    state, opt, loss_fn = cs.make_trainer()
    plain_state = copy.deepcopy(state)
    kernel = (state, make_train_step(state.model, opt, loss_fn, dec_lam=-0.8, ema_decay=0.9999))
    plain = (plain_state, make_train_step(plain_state.model, opt, loss_fn, dec_lam=-0.8,
                                          ema_decay=0.9999, use_kernel=False))
    eval_img_s, eval_runs = cs.throughput(state.model, card)
    images, targets = cs.train_batch()
    train_img_s, train_runs = cs.train_throughput(kernel, plain, images, targets, card,
                                                  "map_convnext_tiny")
    profile = cs.profile_step(kernel, images, targets, "map_convnext_tiny")
    result = {"root": str(args.root), "card": card, "eval_img_s": eval_img_s,
              "eval_runs": eval_runs, "train_img_s": train_img_s, "train_runs": train_runs,
              "train_idle_share": profile["idle_share"]}
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with args.out.open("a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

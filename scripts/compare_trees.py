#!/usr/bin/env python3
"""A model's eval and train img/s on the card from the package of one
checkout, measured by this checkout's chip_smoke.py: for comparing two
checkouts in turns in one call.

    python3 scripts/compare_trees.py [--root DIR] [--model NAME] [--flash] [--out FILE]

DIR is the root of a checkout (default: this one); its
`imagenet_models_tpu_torch` is imported and the model's kernels built into
its own `_build/`. NAME is map_convnext_tiny (the default; kernels 1 and 2,
bench.py's recipe, chip_smoke.py's `make_trainer`), ga_cswin_tiny (kernels
5 and 6, the GA recipe, `ga_trainer`) or map_maxvit_tiny_tf_224 (kernels 3
and 4, which only its train step takes, the maxvit_tiny recipe,
`maxvit_trainer`: train img/s and the idle share only, since its eval takes
no kernel of either tree); with --flash, ga_cswin_tiny with
IMTPU_FLASH_ATTN at "1" (`ops.flash_attention._FLASH_ATTN`, set in the
checkout's package), so that its 61 LePEAttention calls take kernel 12.
The measurement is chip_smoke.py's
(phases 5 and 7, or 12 and 13), loaded from this checkout whatever DIR is,
so both checkouts are measured by one code: `throughput` (eval img/s at
B=256, kernel and plain path in turns), `device_ms_by_kernel` (the device
time of one kernel-path eval forward at B=256, by kernel), `train_batch`
(B=128), `train_throughput` (train img/s of both paths in turns) and
`profile_step` (the device's idle share of one kernel-path train step). Prints one JSON line
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
    ap.add_argument("--model", default="map_convnext_tiny",
                    choices=("map_convnext_tiny", "ga_cswin_tiny", "map_maxvit_tiny_tf_224"))
    ap.add_argument("--flash", action="store_true",
                    help='ga_cswin_tiny with IMTPU_FLASH_ATTN at "1" (kernel 12)')
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if args.flash and args.model != "ga_cswin_tiny":
        ap.error("--flash is for ga_cswin_tiny")
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
    if args.model == cs.GA_CSWIN:
        _kernels.build_all(["stripe_attn_fwd", "stripe_attn_bwd", "window_attn_fwd"])
        if args.flash:
            from imagenet_models_tpu_torch.ops import flash_attention

            flash_attention._FLASH_ATTN = "1"
        state, opt, loss_fn = cs.ga_trainer(cs.GA_CSWIN, torch.bfloat16)
        kw = dict(dec_lam=-0.8, ema_decay=cs.GA_EMA)
    elif args.model == cs.MAXVIT:
        _kernels.build_all(["partition_attn_fwd", "partition_attn_bwd"])
        state, opt, loss_fn = cs.maxvit_trainer(torch.bfloat16)
        kw = dict(dec_lam=-0.8)
    else:
        _kernels.build_all(["ln_mlp_fwd", "ln_mlp_bwd"])
        state, opt, loss_fn = cs.make_trainer()
        kw = dict(dec_lam=-0.8, ema_decay=0.9999)
    plain_state = copy.deepcopy(state)
    kernel = (state, make_train_step(state.model, opt, loss_fn, **kw))
    plain = (plain_state, make_train_step(plain_state.model, opt, loss_fn, use_kernel=False, **kw))
    eval_img_s = eval_runs = None
    eval_device = {}
    if args.model != cs.MAXVIT:
        eval_img_s, eval_runs = cs.throughput(state.model, card, args.model)
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 2)
        x = torch.randn(cs.BENCH_BATCH, cs.IMG, cs.IMG, 3, generator=gen, device="cuda")
        with torch.inference_mode():
            eval_device = cs.device_ms_by_kernel(lambda: state.model(x), calls=3)
        del x
    images, targets = cs.train_batch()
    train_img_s, train_runs = cs.train_throughput(kernel, plain, images, targets, card,
                                                  args.model)
    profile = cs.profile_step(kernel, images, targets, args.model)
    result = {"root": str(args.root), "model": args.model, "flash": args.flash, "card": card,
              "eval_img_s": eval_img_s,
              "eval_runs": eval_runs, "train_img_s": train_img_s, "train_runs": train_runs,
              "train_idle_share": profile["idle_share"],
              "eval_device_ms": sum(eval_device.values()) if eval_device else None,
              "eval_device_ms_by_kernel": dict(list(eval_device.items())[:10])}
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with args.out.open("a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

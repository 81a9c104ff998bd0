#!/usr/bin/env python3
"""Export a model's serving forward to a `torch.export` program with a JSON
sidecar. Port of the JAX package's `scripts/export_serving.py`:

    python -m imagenet_models_tpu_torch.cli.export_serving --model map_convnext_tiny \\
        --checkpoint weights.pth.tar -b 8 --output out/model.pt2 --selftest

The program takes uint8 NHWC images (resized and center-cropped per the
sidecar) and returns fp32 head-averaged logits, the weights inside it
(`serving.export_serving`). `--device` takes the place of JAX's
`--platforms`: an artifact is traced for one device. Traced on the card
(the default; IMTPU_PLATFORM=cpu or `--device cpu` for the CPU), it calls
the forward kernels as `imtpu::` custom ops, so the serving host needs this
package's op library and the kernels' build (`serving.load_artifact`);
traced on the CPU, it holds aten ops only. The sidecar lists the `imtpu::`
ops the program calls. `--selftest` reloads the written artifact and holds
it against the live model on a seeded uint8 batch (largest |difference|
under 1e-3, the JAX script's bound). Prints one JSON line.
"""

import argparse
import json
import logging
import os

_logger = logging.getLogger("export_serving")

SELFTEST_ATOL = 1e-3

parser = argparse.ArgumentParser(description="torch.export serving export (PyTorch port)")
parser.add_argument("--model", "-m", default="map_convnext_tiny", type=str)
parser.add_argument("--checkpoint", default="", type=str,
                    help="a reference .pth.tar, or a port checkpoint directory (as validate)")
parser.add_argument("--pretrained", action="store_true",
                    help="load the released weights from the local pretrained dirs")
parser.add_argument("--use-ema", action="store_true")
parser.add_argument("--batch-size", "-b", default=8, type=int)
parser.add_argument("--img-size", default=None, type=int)
parser.add_argument("--num-classes", type=int, default=None)
parser.add_argument("--amp", action="store_true", default=True,
                    help="bf16 compute inside the program (default)")
parser.add_argument("--no-amp", dest="amp", action="store_false")
parser.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the device the program is traced for and runs on (default: the "
                         "GPU; the CPU with IMTPU_PLATFORM=cpu)")
parser.add_argument("--output", "-o", default="", type=str,
                    help="artifact path (default output/serving/<model>.pt2)")
parser.add_argument("--selftest", action="store_true",
                    help="reload the artifact and compare it with the live model")


def main(argv=None) -> dict:
    import numpy as np
    import torch

    from imagenet_models_tpu_torch import create_model, default_cfg
    from imagenet_models_tpu_torch.ckpt.pretrained import (
        find_local_pretrained, load_pretrained, require_local_pretrained)
    from imagenet_models_tpu_torch.ckpt.saver import resume_checkpoint
    from imagenet_models_tpu_torch.cli import entry_device
    from imagenet_models_tpu_torch.core.registry import resolve_device
    from imagenet_models_tpu_torch.ops.library import program_ops
    from imagenet_models_tpu_torch.serving import (export_serving, load_artifact,
                                                   make_serving_fn, write_artifact)
    from imagenet_models_tpu_torch.utils.meters import setup_default_logging

    setup_default_logging()
    args = parser.parse_args(argv)
    device = resolve_device(args.device) if args.device else entry_device()

    cfg = default_cfg(args.model)
    img_size = args.img_size or cfg["input_size"][0]
    num_classes = args.num_classes or cfg["num_classes"]
    model = create_model(args.model, device=device, num_classes=num_classes,
                         dtype=torch.bfloat16 if args.amp else None,
                         generator=torch.Generator().manual_seed(0))
    if args.checkpoint:
        if args.checkpoint.endswith((".pth", ".pth.tar", ".pt")):
            load_pretrained(model, args.model, args.checkpoint, use_ema=args.use_ema)
        else:
            resume_checkpoint(args.checkpoint, model, use_ema=args.use_ema)
        _logger.info("loaded %s", args.checkpoint)
    else:
        pre = (require_local_pretrained(args.model) if args.pretrained
               else find_local_pretrained(args.model))
        if pre:
            load_pretrained(model, args.model, pre, use_ema=args.use_ema)
            _logger.info("loaded pretrained weights %s", pre)
        else:
            _logger.warning("exporting RANDOM-INIT weights (no checkpoint given)")

    exported = export_serving(model, args.batch_size, img_size, mean=cfg["mean"],
                              std=cfg["std"])
    out = args.output or os.path.join("output", "serving", f"{args.model}.pt2")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    sidecar = {
        "model": args.model,
        "batch_size": args.batch_size,
        "input": f"uint8[{args.batch_size},{img_size},{img_size},3] NHWC",
        "output": f"float32[{args.batch_size},{num_classes}] head-averaged logits",
        "img_size": img_size,
        "crop_pct": cfg["crop_pct"],
        "crop_mode": cfg.get("crop_mode", "center"),
        "interpolation": cfg["interpolation"],
        "mean": list(cfg["mean"]),
        "std": list(cfg["std"]),
        "normalization": "inside artifact: (x/255 - mean)/std",
        "device": device.type,
        "torch_version": torch.__version__,
        "ops": program_ops(exported),
    }
    write_artifact(exported, out, sidecar)
    _logger.info("wrote %s (%.1f MB) + sidecar", out, os.path.getsize(out) / 1e6)
    result = {"artifact": out, **{k: sidecar[k] for k in ("input", "output", "device", "ops")}}

    if args.selftest:
        reloaded, _ = load_artifact(out)
        rng = np.random.default_rng(0)
        u8 = torch.from_numpy(rng.integers(0, 256, (args.batch_size, img_size, img_size, 3),
                                           dtype=np.uint8)).to(device)
        with torch.inference_mode():
            got = reloaded.module()(u8)
        ref = make_serving_fn(model, cfg["mean"], cfg["std"])(u8)
        err = (got.float() - ref).abs().max().item()
        if not (bool(torch.isfinite(got).all()) and err < SELFTEST_ATOL):
            raise RuntimeError(f"selftest failed: max |artifact - live| = {err:.3e} "
                               f"(bound {SELFTEST_ATOL})")
        _logger.info("selftest ok: max |artifact - live| = %.2e", err)
        result["selftest_max_abs_err"] = err
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

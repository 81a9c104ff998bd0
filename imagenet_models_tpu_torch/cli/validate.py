#!/usr/bin/env python3
"""ImageNet validation CLI of the PyTorch port. Port of the JAX package's
root `validate.py` (`validate_once`, bulk mode, the OOM batch-halving retry,
the results file):

    python -m imagenet_models_tpu_torch.cli.validate DATA --model map_convnext_tiny \\
        --checkpoint output/train/<run>/model_best --use-ema --amp

`--checkpoint` takes a port checkpoint (a directory such as `model_best/`,
or its `state.pt`) or a reference `.pth.tar`; a directory of `.pth.tar`
files validates each. The heads' logits are averaged (the MAP/GA models'
eval output), and the top-1/top-5 flags come from the same eval step the
train engine uses (`train.state.make_eval_step`), so a checkpoint validates
to the engine's numbers. It runs on the GPU; IMTPU_PLATFORM=cpu runs it on
the CPU.

`--extract-logits PATH` (or `--logit-extract`, which writes
`output/logit/<model>.npz`) saves every head's logits to an npz, as the JAX
CLI does (its validate.py:131-134, :194-212, :314-334): `logits` (N, heads,
classes), or for heads with a per-token `pre_logits` form (`NormHead`)
(N, heads, tokens, classes) partial logits without bias; `per_token`; the
per-head fc biases in head order as `head_biases` where the heads have the
per-token form; and `bias::<key>` for each classifier bias (keys under
`heads.N.`, GA's `fc.N.bias`, or ending in `head.bias`). The JAX CLI names
the `bias::` entries by flax path; the port names them by its (the
reference's) state_dict key. Top-1/top-5 then come from those logits
(token sums plus biases, averaged over the heads).
"""

import argparse
import csv
import glob
import json
import logging
import os
import re
import time

import numpy as np

from imagenet_models_tpu_torch.cli import Truncate, entry_device
from imagenet_models_tpu_torch.data.dataset import create_dataset
from imagenet_models_tpu_torch.data.loader import create_loader

_logger = logging.getLogger("validate")

parser = argparse.ArgumentParser(description="ImageNet validation (PyTorch port, one GPU)")
parser.add_argument("data", metavar="DIR", help="dataset path (or 'synthetic[:N]')")
parser.add_argument("--dataset", "-d", default="", type=str)
parser.add_argument("--split", default="validation", type=str)
parser.add_argument("--model", "-m", default="map_convnext_tiny", type=str,
                    help="model name; 'all' or a glob validates every match")
parser.add_argument("-b", "--batch-size", default=256, type=int)
parser.add_argument("--img-size", default=None, type=int)
parser.add_argument("--input-size", default=None, nargs=3, type=int)
parser.add_argument("--crop-pct", default=None, type=float)
parser.add_argument("--mean", type=float, nargs="+", default=None)
parser.add_argument("--std", type=float, nargs="+", default=None)
parser.add_argument("--interpolation", default="", type=str)
parser.add_argument("--num-classes", type=int, default=None)
parser.add_argument("--checkpoint", default="", type=str,
                    help="port checkpoint (directory or state.pt) or .pth.tar; a "
                         "directory of .pth.tar enables bulk mode")
parser.add_argument("--pretrained", action="store_true",
                    help="load released weights for --model from a local dir "
                         "($IMTPU_PRETRAINED_DIR, ./pretrained, ~/.cache/imtpu/"
                         "checkpoints); the reference downloads them "
                         "(MAP/validate.py:133,157)")
parser.add_argument("--use-ema", action="store_true")
parser.add_argument("--amp", action="store_true", help="bf16 compute")
parser.add_argument("--tta", type=int, default=0,
                    help="average logits over groups of N consecutive samples "
                         "(the train CLI's --tta)")
parser.add_argument("--num-gpu", type=int, default=1, help="accepted no-op")
parser.add_argument("-j", "--workers", type=int, default=4)
parser.add_argument("--log-freq", default=50, type=int)
parser.add_argument("--results-file", default="", type=str)
parser.add_argument("--max-batches", default=None, type=int,
                    help="truncate (subset evals)")
parser.add_argument("--extract-logits", default="", type=str,
                    help="save per-head logits (and per-token partials) to this .npz")
parser.add_argument("--logit-extract", action="store_true", default=False,
                    help="reference boolean form of --extract-logits: output/logit/<model>.npz")
parser.add_argument("--real-labels", default="", type=str,
                    help="JSON {filename: [valid class ids]} (ReaL labels)")
parser.add_argument("--valid-labels", default="", type=str,
                    help="text file of class indices restricting the label space")
parser.add_argument("--class-map", default="", type=str, metavar="FILENAME",
                    help="class-to-idx mapping file (one class name per line)")
parser.add_argument("--distill-tokens", "-dt", type=int, default=0,
                    help="build the model with N distill tokens per CAP")
parser.add_argument("--gp", default=None, type=str,
                    help="global pool override; fails loudly (factories fix pooling)")
parser.add_argument("--test-pool", action="store_true", default=False,
                    help="timm test-time pooling; unsupported (fails loudly)")
parser.add_argument("--tf-preprocessing", action="store_true", default=False,
                    help="TF preprocessing pipeline; unsupported (fails loudly)")
# runtime flags of the reference accepted for CLI parity
parser.add_argument("--apex-amp", action="store_true", default=False,
                    help="reference AMP selector; enables --amp (bf16) here")
parser.add_argument("--native-amp", action="store_true", default=False,
                    help="reference AMP selector; enables --amp (bf16) here")
parser.add_argument("--channels-last", action="store_true", default=False,
                    help="accepted no-op: the port's models take NHWC")
parser.add_argument("--cuda", action="store_true", default=False,
                    help="accepted no-op: the GPU is the default device")
parser.add_argument("--pin-mem", action="store_true", default=False,
                    help="accepted no-op")
parser.add_argument("--no-prefetcher", action="store_true", default=False,
                    help="accepted no-op: batches always reach the card through pinned memory")
parser.add_argument("--dataset-download", action="store_true", default=False,
                    help="accepted no-op: datasets are local directories")
parser.add_argument("--torchscript", action="store_true", default=False,
                    help="accepted no-op: the model runs eagerly")
parser.add_argument("--fuser", default="", type=str,
                    help="accepted no-op: the port's kernels are written by hand")


def validate_once(args) -> dict:
    import torch

    from imagenet_models_tpu_torch import create_model, default_cfg
    from imagenet_models_tpu_torch.ckpt.pretrained import (
        find_local_pretrained, load_pretrained, require_local_pretrained)
    from imagenet_models_tpu_torch.ckpt.saver import resume_checkpoint
    from imagenet_models_tpu_torch.data.dataset import check_dataset_name
    from imagenet_models_tpu_torch.train.engine import to_device
    from imagenet_models_tpu_torch.train.state import make_eval_step
    from imagenet_models_tpu_torch.utils.meters import AverageMeter

    if args.apex_amp or args.native_amp:
        args.amp = True
    if args.gp is not None:
        raise NotImplementedError(
            f"--gp {args.gp}: pooling is fixed by the model factory here")
    if args.test_pool or args.tf_preprocessing:
        raise NotImplementedError(
            "--test-pool/--tf-preprocessing are timm-substrate features the "
            "reference never exercises; not supported")
    if args.logit_extract and not args.extract_logits:
        # the reference's layout: output/logit/<model> (MAP/validate.py:328-338)
        os.makedirs(os.path.join("output", "logit"), exist_ok=True)
        args.extract_logits = os.path.join("output", "logit", f"{args.model}.npz")
    device = entry_device()

    cfg = default_cfg(args.model)
    num_classes = args.num_classes or cfg["num_classes"]
    img_size = args.input_size[1] if args.input_size else (args.img_size or cfg["input_size"][0])
    crop_pct = args.crop_pct or cfg["crop_pct"]
    interpolation = args.interpolation or cfg["interpolation"]
    crop_mode = cfg.get("crop_mode", "center")
    mean = tuple(args.mean) if args.mean else cfg["mean"]
    std = tuple(args.std) if args.std else cfg["std"]
    _logger.info(
        "Data processing configuration for current model + dataset:\n"
        "\tinput_size: (3, %d, %d)\n\tinterpolation: %s\n\tmean: %s\n"
        "\tstd: %s\n\tcrop_pct: %s\n\tcrop_mode: %s",
        img_size, img_size, interpolation, mean, std, crop_pct, crop_mode)

    model_kwargs = {"distill_tokens": args.distill_tokens} if args.distill_tokens else {}
    model = create_model(args.model, device=device, num_classes=num_classes,
                         dtype=torch.bfloat16 if args.amp else None,
                         generator=torch.Generator().manual_seed(0), **model_kwargs)
    if args.checkpoint:
        resume_checkpoint(args.checkpoint, model, use_ema=args.use_ema)
        _logger.info("loaded %s%s", args.checkpoint, " (EMA weights)" if args.use_ema else "")
    else:
        # the reference downloads released weights when no --checkpoint is
        # given (MAP/validate.py:133,155-162); here they are local files, and
        # only an explicit --pretrained fails without them
        pre_path = (require_local_pretrained(args.model) if args.pretrained
                    else find_local_pretrained(args.model))
        if pre_path:
            load_pretrained(model, args.model, pre_path, use_ema=args.use_ema)
            _logger.info("loaded pretrained weights %s", pre_path)
        else:
            _logger.warning("no checkpoint and no local pretrained weights for %s "
                            ": evaluating RANDOM INIT (the reference would "
                            "download released weights here)", args.model)
    param_count = sum(p.numel() for p in model.parameters())
    _logger.info("Model %s created, param count: %d", args.model, param_count)

    check_dataset_name(args.dataset)
    dataset = create_dataset(args.data, args.split, num_classes=num_classes,
                             image_size=img_size, class_map=args.class_map or None)
    tta = max(int(args.tta), 1)
    batch = max(tta, args.batch_size // tta * tta)
    loader = create_loader(dataset, img_size, batch, is_training=False,
                           interpolation=interpolation, crop_pct=crop_pct,
                           crop_mode=crop_mode, mean=mean, std=std,
                           num_workers=args.workers)
    if args.max_batches:
        loader = Truncate(loader, args.max_batches)

    valid_idx = None
    if args.valid_labels:
        with open(args.valid_labels) as f:
            valid_idx = np.asarray([int(line.strip()) for line in f if line.strip()])
    real = None
    if args.real_labels:
        with open(args.real_labels) as f:
            real_map = json.load(f)
        real = [set(real_map.get(os.path.basename(p), [])) for p in dataset.filenames]
    if tta > 1 and (real is not None or valid_idx is not None or args.extract_logits):
        raise ValueError("--tta does not combine with --real-labels/--valid-labels/"
                         "--extract-logits")

    eval_step = make_eval_step(model, tta=tta)
    extract = _LogitExtractor(model) if args.extract_logits else None
    top1, top5 = AverageMeter(), AverageMeter()
    batch_time = AverageMeter()
    seen = 0
    t_start = end = time.time()
    last_idx = len(loader) - 1
    for batch_idx, (images, targets) in enumerate(loader):
        n = images.shape[0]
        if n < batch:  # pad the tail as the train engine does; only n rows count
            pad = batch - n
            images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
            targets = np.concatenate([targets, np.full((pad,), -1, targets.dtype)])
        x, t = to_device(images, targets, device)
        if extract is not None:
            logits = extract(x, n)
        else:
            logits, c1, c5 = eval_step(x, t)
        n_eff = n // tta
        if extract is not None or real is not None or valid_idx is not None:
            if extract is None:
                logits = logits[:n].float().cpu().numpy()
            if valid_idx is not None:
                masked = np.full_like(logits, -np.inf)
                masked[:, valid_idx] = logits[:, valid_idx]
                logits = masked
            order = np.argsort(-logits, axis=1)[:, :5]
            if real is not None:
                c1 = np.asarray([bool(real[seen + i]) and order[i, 0] in real[seen + i]
                                 for i in range(n)], np.float32)
                c5 = np.asarray([bool(set(order[i]) & real[seen + i]) for i in range(n)],
                                np.float32)
            else:
                c1 = (order[:, 0] == targets[:n]).astype(np.float32)
                c5 = (order == targets[:n, None]).any(axis=1).astype(np.float32)
        else:
            c1, c5 = c1[:n_eff].cpu().numpy(), c5[:n_eff].cpu().numpy()
        seen += n
        if n_eff:
            top1.update(float(c1.mean()) * 100.0, n_eff)
            top5.update(float(c5.mean()) * 100.0, n_eff)
        batch_time.update(time.time() - end)
        end = time.time()
        if batch_idx % args.log_freq == 0 or batch_idx == last_idx:
            _logger.info("Test: [%4d/%d]  Time: %.3f (%.3f, %7.2f/s)  "
                         "Acc@1: %.3f (%.3f)  Acc@5: %.3f (%.3f)",
                         batch_idx, len(loader), batch_time.val, batch_time.avg,
                         n / max(batch_time.avg, 1e-9), top1.val, top1.avg,
                         top5.val, top5.avg)

    if extract is not None:
        extract.save(args.extract_logits)
        _logger.info("wrote logits for %d images to %s", seen, args.extract_logits)

    dt = time.time() - t_start
    return {
        "model": args.model,
        "top1": round(top1.avg, 4), "top1_err": round(100 - top1.avg, 4),
        "top5": round(top5.avg, 4), "top5_err": round(100 - top5.avg, 4),
        "param_count": round(param_count / 1e6, 2),
        "img_size": img_size, "cropt_pct": crop_pct, "interpolation": interpolation,
        "images_per_sec": round(seen / dt, 2),
    }


class _LogitExtractor:
    """Per-head logits of each batch (JAX validate.py:194-212, :267-276),
    kept for the npz (:314-334). Heads with a per-token `pre_logits` form
    (every output (B, tokens, classes)) give their partial logits without
    bias, and the full logits are the token sums plus the fc biases; other
    models give their logits. Whether the heads have the form is decided on
    the first batch."""

    def __init__(self, model):
        import inspect

        import torch

        self.model, self.parts = model, []
        self.per_token = "pre_logits" in inspect.signature(type(model).forward).parameters
        self.head_biases = None
        found = {}
        for k, v in model.state_dict().items():
            m = re.search(r"(?:^|\.)heads\.(\d+)\.", k)
            if m and k.endswith("head.bias"):
                found[int(m.group(1))] = v.float().cpu().numpy()
        if found:
            self.head_biases = np.stack([found[i] for i in sorted(found)])
        # every classifier bias (:318-323): JAX's flax paths holding
        # `heads_`, `fc_` or ending in `head/bias`, by the port's keys
        ga_fc = isinstance(getattr(model, "fc", None), torch.nn.ModuleList)
        self.biases = {k: v.float().cpu().numpy() for k, v in model.state_dict().items()
                       if k.endswith(".bias") and (re.search(r"heads\.\d+\.", k)
                                                   or k.endswith("head.bias")
                                                   or (ga_fc and re.match(r"fc\.\d+\.bias$", k)))}
        self.decided = False

    def __call__(self, x, n: int) -> np.ndarray:
        """The (n, classes) fp32 logits of the first n rows of batch `x`."""
        import torch

        self.model.eval()
        with torch.inference_mode():
            out = self.model(x, pre_logits=True) if self.per_token else None
            if not self.decided:
                self.per_token = (isinstance(out, (tuple, list))
                                  and all(o.dim() == 3 for o in out))
                self.decided = True
            if not self.per_token:
                out = self.model(x)
            out = out if isinstance(out, (tuple, list)) else (out,)
            heads = torch.stack([o.float() for o in out], dim=1)[:n].cpu().numpy()
        self.parts.append(heads)
        if self.per_token:
            per_head = heads.sum(axis=2)
            if self.head_biases is not None:
                per_head = per_head + self.head_biases
            return per_head.mean(axis=1)
        return heads.mean(axis=1)

    def save(self, path: str) -> None:
        extra = {f"bias::{k}": v for k, v in self.biases.items()}
        if self.per_token and self.head_biases is not None:
            extra["head_biases"] = self.head_biases
        np.savez(path, logits=np.concatenate(self.parts), per_token=np.asarray(self.per_token),
                 **extra)


def _try_run(args) -> dict:
    """Out of device memory: halve the batch and retry (MAP/validate.py:360-378)."""
    import torch

    batch_size = args.batch_size
    while batch_size >= 1:
        args.batch_size = batch_size
        try:
            return validate_once(args)
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            batch_size //= 2
            _logger.warning("OOM, retrying with batch size %d", batch_size)
    raise RuntimeError("validation failed even at batch size 1")


def main(argv=None) -> list:
    from imagenet_models_tpu_torch.utils.meters import setup_default_logging

    setup_default_logging()
    args = parser.parse_args(argv)

    # bulk mode (MAP/validate.py:387-409): a model glob and/or a directory
    # of .pth.tar checkpoints (a port checkpoint directory holds state.pt)
    runs = []
    if os.path.isdir(args.checkpoint) and not os.path.exists(
            os.path.join(args.checkpoint, "state.pt")):
        for ckpt in sorted(glob.glob(os.path.join(args.checkpoint, "*.pth.tar"))):
            name = os.path.basename(ckpt).rsplit(".pth.tar", 1)[0]
            runs.append((name, ckpt))
    elif args.model == "all" or any(ch in args.model for ch in "*?["):
        from imagenet_models_tpu_torch import list_models

        pattern = "*" if args.model == "all" else args.model
        runs = [(m, args.checkpoint) for m in list_models(pattern)]
    else:
        runs = [(args.model, args.checkpoint)]

    all_results = []
    for name, ckpt in runs:
        args.model, args.checkpoint = name, ckpt
        results = _try_run(args)
        all_results.append(results)
        if args.results_file:
            with open(args.results_file, "a", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=list(results.keys()))
                if f.tell() == 0:
                    writer.writeheader()
                writer.writerow(results)
        print(f"--result\n{json.dumps(results, indent=4)}")
    return all_results


if __name__ == "__main__":
    main()

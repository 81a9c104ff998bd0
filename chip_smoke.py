#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths at full width on the card, through the
entry points a user calls, with random weights from a fixed seed: the
map_convnext_tiny serving forward (`create_model`, `serving.make_serving_fn`,
`train.state.make_eval_step`) and its train step (`train.state.
create_train_state` / `make_train_step` with bench.py's recipe: timm LAMB lr
5e-3 wd 0.05, BCE on dense targets, dec_lam -0.8, EMA 0.9999). Phases:

1. device: the card's name and power limit;
2. build: compile every CUDA kernel of both paths from `csrc/`, one nvcc per
   source, all started together;
3. kernels: each kernel against its plain-PyTorch twin at the shapes the
   paths give it (the four stage shapes of B=64 and a ragged N=152, and
   those of B=128 for the training kernels): the LN+MLP forward with exact
   and with fast GELU, and the backward (kernel 2) with both, every output;
   times in turns (twin, kernel, kernel, twin) from CUDA events, the forward
   at B=64 (both GELUs) and the training kernels at B=128;
4. serving: four uint8 requests of 32 images through the kernel path, with
   launch counts per request, logits checked against the plain path, and one
   eval step;
5. throughput: eval img/s at B=256, kernel path and plain path in turns;
6. train: six steps at B=128, 224 px, on the kernel path (18 forward and 18
   backward launches each, finite loss and grad norm, the EMA shadow moves),
   and one step from a deep copy of the first state on the plain path, whose
   loss, grad norm and gradients (by stage and block parameter) must agree
   with the kernel path's first step, both paths' gradients held against
   those of an fp32 model with the same weights;
7. train throughput: train img/s at B=128, kernel and plain path in turns;
8. profile: torch.profiler's top device rows of one train step.

Any failure raises and exits non-zero. The last lines are a JSON summary of
the kernels, the card's name and power limit, and
`{"ok": true, "device": {...}}`. A copy of the measurements goes to
`chiprun_out/chip_smoke.json`. There is no CPU path: without CUDA the script
exits with status 2.
"""

from __future__ import annotations

import copy
import importlib
import json
import pkgutil
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
STAGE_DEPTHS = (3, 3, 9, 3)  # map_convnext_tiny: launches per stage in one forward
STAGE_WIDTHS = (96, 192, 384, 768)
STAGE_SIDES = (56, 28, 14, 7)  # token grid of each stage at 224 px


def stage_shapes(batch: int):
    return [(batch * s * s, c) for s, c in zip(STAGE_SIDES, STAGE_WIDTHS)]


RAGGED_SHAPE = (49 * 3 + 5, 768)
# bf16 kernel vs twin: both sum in fp32 in different orders, so a result may
# round to the neighbouring bf16 value; 1e-2 of the largest |output| is 2.5
# bf16 ulps at the top of the range. The same bound holds every output of the
# backward: its fp32 sums add up to 400k exact products of bf16 operands that
# may differ by one rounding between kernel and twin.
KERNEL_RTOL = 1e-2
# kernel path vs plain path through 18 bf16 blocks and the head: one-ulp
# differences per block carry into the logits.
LOGITS_RTOL = 5e-2
# one train step, kernel path vs plain path, from the same state and batch:
# the blocks' bf16 roundings fall differently in the two paths. Measured on
# an H100 80GB HBM3 (700 W): loss 8.7e-6 and global grad norm 7.3e-6
# relative apart.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GNORM_RTOL = 1e-3
# The first step's gradients, grouped by stage and block parameter (the
# LN+MLP leaves kernel 2 writes, and the depthwise conv's, which take its
# dx): |g_kernel - g_plain| / |g_plain| (L2 over the group). Each path's
# bf16 roundings carry through every block below, so each is 6-8% (L2) from
# the gradients of the same weights computed in fp32, and the two are
# 2.4-4.2% apart per group (same card). Single leaves are no gate: some have
# a true gradient of zero (attention key biases; the last block's pwconv2
# bias, which only train-mode BatchNorm sees) and hold rounding noise only.
# So the gate is twofold: the paths within TRAIN_GRAD_RTOL of each other,
# and the kernel path no farther from fp32 than TRAIN_GRAD_ACC times the
# plain path's distance (measured at most 1.05).
TRAIN_GRAD_RTOL = 0.08
TRAIN_GRAD_ACC = 1.25
BLOCK_KINDS = ("norm.weight", "norm.bias", "pwconv1.weight", "pwconv1.bias", "pwconv2.weight",
               "pwconv2.bias", "gamma", "dwconv.weight", "dwconv.bias")
REQUESTS, REQUEST_BATCH, IMG = 4, 32, 224
BENCH_BATCH, BENCH_ITERS = 256, 10
TRAIN_BATCH, TRAIN_STEPS = 128, 6
TRAIN_WARMUP, TRAIN_ITERS = 2, 5
# the card's published dense peaks (H100 SXM, NVIDIA's data sheet)
PEAK_BF16_FLOPS, PEAK_BYTES = 989e12, 3.35e12
OUT_DIR = Path("chiprun_out")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip()


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of `fn` on the current stream, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns, iters: int):
    """Times of fns["plain"] and fns["kernel"] in turns (plain, kernel,
    kernel, plain); returns {name: [ms, ms]}."""
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        times[which].append(cuda_ms(fns[which], iters))
    return times


def bound_ms(n: int, c: int, backward: bool) -> tuple:
    """The least time of one LN+MLP launch on (n, c) tokens, hidden 4c: the
    larger of its operations over the bf16 peak and its bytes (each input
    read once, each output written once) over the memory rate."""
    hidden = 4 * c
    if backward:
        # five products: pre1 (recomputed), dhmid, dln, dW1 and G = g^T hmid,
        # which gives dW2 = gamma * G and, with pre2 = hmid W2^T + b2,
        # dgamma = sum_j W2 * G + b2 * sum_t g, so pre2 need not be formed
        flops = 5 * 2 * n * c * hidden
        nbytes = 3 * n * c * 2 + 2 * hidden * c * 2 + 2 * hidden * c * 4 + 2 * (hidden + 4 * c) * 4
    else:
        flops = 2 * 2 * n * c * hidden
        nbytes = 2 * n * c * 2 + 2 * hidden * c * 2 + (hidden + 4 * c) * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ln_mlp_args(n: int, c: int, gen):
    import torch

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + shift

    return (randn(n, c).to(torch.bfloat16),
            randn(c, scale=0.1, shift=1.0), randn(c, scale=0.1),
            randn(4 * c, c, scale=c ** -0.5).to(torch.bfloat16), randn(4 * c, scale=0.1),
            randn(c, 4 * c, scale=(4 * c) ** -0.5).to(torch.bfloat16), randn(c, scale=0.1),
            randn(c))


def rel_err(got, ref) -> float:
    scale = ref.float().abs().max().item()
    return (got.float() - ref.float()).abs().max().item() / max(scale, 1e-30)


def compare_forward(args, gelu_impl: str, tag: str) -> dict:
    """One forward kernel launch against its twin on the same inputs; raises
    past KERNEL_RTOL."""
    import torch

    from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp, plain_ln_mlp

    n, c = args[0].shape
    with torch.inference_mode():
        got = fused_ln_mlp(*args, gelu_impl=gelu_impl)
        ref = plain_ln_mlp(*args, gelu_impl=gelu_impl)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got.float()).all():
            raise AssertionError(f"forward kernel output at ({n}, {c}) is malformed")
        err = (got.float() - ref.float()).abs().max().item()
        ratio = rel_err(got, ref)
    log(f"[kernels] ln_mlp_fwd[{gelu_impl}] {tag}N={n} C={c}: max|kernel-twin|/max|twin| = "
        f"{ratio:.4g} (tol {KERNEL_RTOL})")
    if not ratio <= KERNEL_RTOL:
        raise AssertionError(f"forward kernel ({gelu_impl}) disagrees with its twin at "
                             f"({n}, {c}): {ratio}")
    return {"n": n, "c": c, "max_abs_err": err, "err_over_max_twin": ratio}


def check_forward(gelu_impl: str, time_batches):
    """Forward kernel vs twin at the B=64 stage shapes and the ragged one,
    and at the stage shapes of each batch in `time_batches`, where it is
    also timed per launch ({batch: rows})."""
    import torch

    from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp, plain_ln_mlp

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for n, c in stage_shapes(64) + [RAGGED_SHAPE]:
        args = ln_mlp_args(n, c, gen)
        rows.append(compare_forward(args, gelu_impl, ""))
        del args
    times = {}
    for time_batch, (n, c) in [(b, nc) for b in time_batches for nc in stage_shapes(b)]:
        args = ln_mlp_args(n, c, gen)
        rows.append(compare_forward(args, gelu_impl, f"B={time_batch} "))
        iters = max(3, min(50, 2_000_000 // n))
        with torch.inference_mode():
            t = in_turns({"kernel": lambda: fused_ln_mlp(*args, gelu_impl=gelu_impl),
                          "plain": lambda: plain_ln_mlp(*args, gelu_impl=gelu_impl)}, iters)
        bound, by = bound_ms(n, c, backward=False)
        row = {"n": n, "c": c, "ms": sum(t["kernel"]) / 2, "plain_ms": sum(t["plain"]) / 2,
               "bound_ms": bound, "bound_by": by, "turns": t}
        times.setdefault(time_batch, []).append(row)
        log(f"[kernels] ln_mlp_fwd[{gelu_impl}] B={time_batch} N={n} C={c}: kernel "
            f"{row['ms']:.4f} ms, twin {row['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by}) "
            f"(twin,kernel,kernel,twin: {t['plain'][0]:.4f},{t['kernel'][0]:.4f},"
            f"{t['kernel'][1]:.4f},{t['plain'][1]:.4f})")
        del args
    return rows, times


BWD_NAMES = ("dx", "dln_s", "dln_b", "dw1", "db1", "dw2", "db2", "dgamma")


def compare_backward(args, g, gelu_impl: str, tag: str) -> dict:
    """One launch of kernel 2 against its twin on the same inputs, all eight
    outputs; raises past KERNEL_RTOL."""
    import torch

    from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp_bwd, plain_ln_mlp_bwd

    n, c = args[0].shape
    got = fused_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl=gelu_impl)
    ref = plain_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl=gelu_impl)
    torch.cuda.synchronize()
    ratios = {}
    for name, o, r in zip(BWD_NAMES, got, ref):
        if o.shape != r.shape or o.dtype != r.dtype:
            raise AssertionError(f"backward kernel output {name} at ({n}, {c}): "
                                 f"{tuple(o.shape)} {o.dtype}, twin {tuple(r.shape)} {r.dtype}")
        if not torch.isfinite(o.float()).all():
            raise AssertionError(f"backward kernel output {name} at ({n}, {c}) is not finite")
        ratios[name] = rel_err(o, r)
    err = max((o.float() - r.float()).abs().max().item() for o, r in zip(got, ref))
    log(f"[kernels] ln_mlp_bwd[{gelu_impl}] {tag}N={n} C={c}: max|kernel-twin|/max|twin| "
        + " ".join(f"{k}={v:.3g}" for k, v in ratios.items()) + f" (tol {KERNEL_RTOL})")
    bad = [k for k, v in ratios.items() if not v <= KERNEL_RTOL]
    if bad:
        raise AssertionError(f"backward kernel ({gelu_impl}) disagrees with its twin at "
                             f"({n}, {c}) in {bad}")
    return {"n": n, "c": c, "gelu": gelu_impl, "max_abs_err": err, "ratios": ratios}


def check_backward():
    """Kernel 2 vs its twin with both GELUs at the B=64 stage shapes and the
    ragged one, and with the training GELU at the B=128 stage shapes, where
    its halves (a) and (b) and the twin are also timed per launch."""
    import torch

    from imagenet_models_tpu_torch.ops.convnext_block import (
        fused_ln_mlp_bwd, ln_mlp_bwd_dx, ln_mlp_bwd_wgrad, plain_ln_mlp_bwd)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for gelu_impl in ("exact", "fast"):
        for n, c in stage_shapes(64) + [RAGGED_SHAPE]:
            args = ln_mlp_args(n, c, gen)
            g = torch.randn(n, c, generator=gen, device="cuda").to(torch.bfloat16)
            rows.append(compare_backward(args, g, gelu_impl, ""))
            del args, g
    times = []
    for n, c in stage_shapes(TRAIN_BATCH):
        args = ln_mlp_args(n, c, gen)
        g = torch.randn(n, c, generator=gen, device="cuda").to(torch.bfloat16)
        rows.append(compare_backward(args, g, "fast", f"B={TRAIN_BATCH} "))
        iters = max(3, min(30, 1_000_000 // n))
        _, scratch = ln_mlp_bwd_dx(args[0], g, *args[1:], gelu_impl="fast")
        t = in_turns({"kernel": lambda: fused_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl="fast"),
                      "plain": lambda: plain_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl="fast")},
                     iters)
        dx_ms = cuda_ms(lambda: ln_mlp_bwd_dx(args[0], g, *args[1:], gelu_impl="fast"), iters)
        wgrad_ms = cuda_ms(lambda: ln_mlp_bwd_wgrad(scratch), iters)
        bound, by = bound_ms(n, c, backward=True)
        row = {"n": n, "c": c, "ms": sum(t["kernel"]) / 2, "plain_ms": sum(t["plain"]) / 2,
               "dx_ms": dx_ms, "wgrad_ms": wgrad_ms, "bound_ms": bound, "bound_by": by,
               "turns": t}
        times.append(row)
        log(f"[kernels] ln_mlp_bwd[fast] B={TRAIN_BATCH} N={n} C={c}: kernel {row['ms']:.4f} ms "
            f"((a) {dx_ms:.4f} + (b) {wgrad_ms:.4f}), twin {row['plain_ms']:.4f} ms, bound "
            f"{bound:.4f} ms ({by}) (twin,kernel,kernel,twin: {t['plain'][0]:.4f},"
            f"{t['kernel'][0]:.4f},{t['kernel'][1]:.4f},{t['plain'][1]:.4f})")
        del args, g, scratch
    return rows, times


def serve():
    """The serving path: map_convnext_tiny on the card, through the kernel."""
    import torch

    from imagenet_models_tpu_torch import create_model, default_cfg
    from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp
    from imagenet_models_tpu_torch.serving import make_serving_fn
    from imagenet_models_tpu_torch.train.state import make_eval_step

    n_blocks = sum(STAGE_DEPTHS)
    # ls_init_value=1: the default 1e-6 layer scale would hide every block's
    # branch, and with it the kernel, from the logits compared below
    t0 = time.perf_counter()
    model = create_model("map_convnext_tiny", dtype=torch.bfloat16, ls_init_value=1.0,
                         generator=torch.Generator().manual_seed(SEED))
    if not next(model.parameters()).is_cuda:
        raise AssertionError("create_model did not build on the GPU by default")
    log(f"[serving] map_convnext_tiny built: "
        f"{sum(p.numel() for p in model.parameters())} params, bf16 compute, "
        f"{time.perf_counter() - t0:.1f} s")
    serve_fn = make_serving_fn(model)
    plain_fn = make_serving_fn(model, use_kernel=False)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    requests = [torch.randint(0, 256, (REQUEST_BATCH, IMG, IMG, 3), generator=gen,
                              device="cuda", dtype=torch.uint8) for _ in range(REQUESTS)]

    fused_ln_mlp.launches = 0
    outputs, per_request = [], []
    t0 = time.perf_counter()
    for images in requests:
        before = fused_ln_mlp.launches
        outputs.append(serve_fn(images))
        per_request.append(fused_ln_mlp.launches - before)
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    launches = fused_ln_mlp.launches
    log(f"[serving] {REQUESTS} requests of {REQUEST_BATCH} in {served_s:.3f} s "
        f"(first includes warm-up); ln_mlp_fwd launches per request: {per_request}")
    if per_request != [n_blocks] * REQUESTS:
        raise AssertionError(f"expected {n_blocks} kernel launches per request, got {per_request}")
    for logits in outputs:
        if logits.shape != (REQUEST_BATCH, 1000) or logits.dtype != torch.float32:
            raise AssertionError(f"logits {tuple(logits.shape)} {logits.dtype}")
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")

    plain = plain_fn(requests[0])
    err = (outputs[0] - plain).abs().max().item()
    scale = plain.abs().max().item()
    agree = (outputs[0].argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"[serving] kernel path vs plain path logits: max|diff|={err:.4g} "
        f"(tol {LOGITS_RTOL * scale:.4g}, max|plain|={scale:.4g}), top-1 agreement {agree:.3f}")
    if not err <= LOGITS_RTOL * scale:
        raise AssertionError(f"kernel-path logits disagree with the plain path: {err}")

    step = make_eval_step(model)
    cfg = default_cfg("map_convnext_tiny")
    mean = torch.tensor(cfg["mean"], device="cuda")
    std = torch.tensor(cfg["std"], device="cuda")
    x = (requests[1].float() / 255.0 - mean) / std
    targets = torch.randint(0, 1000, (REQUEST_BATCH,), generator=gen, device="cuda")
    before = fused_ln_mlp.launches
    logits, top1, top5 = step(x, targets)
    if fused_ln_mlp.launches - before != n_blocks:
        raise AssertionError("eval step did not run every block through the kernel")
    if not (logits - outputs[1]).abs().max().item() <= 1e-3 * scale:
        raise AssertionError("eval step logits differ from the serving logits on the same images")
    if not (top1 <= top5).all() or top1.shape != (REQUEST_BATCH,):
        raise AssertionError("eval step top-1/top-5 flags are malformed")
    log(f"[serving] eval step: top-1 {top1.mean().item():.4f}, top-5 {top5.mean().item():.4f} "
        f"on random targets")
    return model, launches, {"max_abs_err": err, "max_abs_plain": scale, "top1_agreement": agree}


def throughput(model, card: str):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.randn(BENCH_BATCH, IMG, IMG, 3, generator=gen, device="cuda")
    model.eval()
    with torch.inference_mode():
        t = in_turns({"kernel": lambda: model(x, use_kernel=True),
                      "plain": lambda: model(x, use_kernel=False)}, BENCH_ITERS)
    runs = {k: [BENCH_BATCH * 1000.0 / ms for ms in v] for k, v in t.items()}
    result = {k: sum(v) / len(v) for k, v in runs.items()}
    log(f"[throughput] map_convnext_tiny eval B={BENCH_BATCH} {IMG}px bf16: "
        f"kernel path {result['kernel']:.1f} img/s, plain path {result['plain']:.1f} img/s "
        f"(turns plain,kernel,kernel,plain: {runs['plain'][0]:.1f},{runs['kernel'][0]:.1f},"
        f"{runs['kernel'][1]:.1f},{runs['plain'][1]:.1f}) on {card}")
    return result, runs


def make_trainer():
    """bench.py's train recipe on a fresh full-width map_convnext_tiny."""
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.train.losses import create_loss_fn
    from imagenet_models_tpu_torch.train.optim import create_optimizer
    from imagenet_models_tpu_torch.train.state import create_train_state

    model = create_model("map_convnext_tiny", dtype=torch.bfloat16, ls_init_value=1.0,
                         generator=torch.Generator().manual_seed(SEED))
    opt = create_optimizer("lamb", learning_rate=5e-3, weight_decay=0.05)
    state = create_train_state(model, opt, ema_decay=0.9999)
    loss_fn = create_loss_fn(bce_loss=True, smoothing=0.1, mixup_active=True)
    return state, opt, loss_fn


def train_batch():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    images = torch.randn(TRAIN_BATCH, IMG, IMG, 3, generator=gen, device="cuda")
    targets = torch.rand(TRAIN_BATCH, 1000, generator=gen, device="cuda")
    return images, targets


class FirstGrads:
    """An optimizer that keeps an fp32 copy of the gradients of its first
    update and passes every update on to `opt`."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params, grouped=None):
        return self.opt.init(params, grouped)

    def step(self, params, grads, state):
        if self.grads is None:
            self.grads = {k: g.detach().float().clone() for k, g in grads.items()}
        self.opt.step(params, grads, state)


def rel_l2(got, ref) -> float:
    return (got - ref).norm().item() / max(ref.norm().item(), 1e-30)


def compare_grads(kernel, plain, fp32) -> dict:
    """The first step's gradients by (stage, block parameter) group: kernel
    path against plain path, and both against the fp32 gradients; raises
    past TRAIN_GRAD_RTOL or TRAIN_GRAD_ACC."""
    import torch

    groups = []
    for s, kind in [(s, k) for s in range(len(STAGE_DEPTHS)) for k in BLOCK_KINDS]:
        keys = [k for k in fp32 if k.startswith(f"stages.{s}.") and k.endswith("." + kind)]
        cat = lambda g: torch.cat([g[k].flatten() for k in keys])
        groups.append({"stage": s, "kind": kind, "leaves": len(keys),
                       "kernel_vs_plain": rel_l2(cat(kernel), cat(plain)),
                       "kernel_vs_fp32": rel_l2(cat(kernel), cat(fp32)),
                       "plain_vs_fp32": rel_l2(cat(plain), cat(fp32))})
    cat = lambda g: torch.cat([g[k].flatten() for k in fp32])
    whole = {"kernel_vs_plain": rel_l2(cat(kernel), cat(plain)),
             "kernel_vs_fp32": rel_l2(cat(kernel), cat(fp32)),
             "plain_vs_fp32": rel_l2(cat(plain), cat(fp32))}
    apart = max(groups, key=lambda g: g["kernel_vs_plain"])
    ratio = max(groups, key=lambda g: g["kernel_vs_fp32"] / g["plain_vs_fp32"])
    worst_ratio = ratio["kernel_vs_fp32"] / ratio["plain_vs_fp32"]
    log(f"[train] first step's gradients, {len(groups)} (stage, block parameter) groups, L2 "
        f"relative: kernel vs plain path at most {apart['kernel_vs_plain']:.4g} (stage "
        f"{apart['stage']} {apart['kind']}; tol {TRAIN_GRAD_RTOL}); distance to fp32 kernel / "
        f"plain at most {worst_ratio:.4g} (stage {ratio['stage']} {ratio['kind']}: "
        f"{ratio['kernel_vs_fp32']:.4g} / {ratio['plain_vs_fp32']:.4g}; tol {TRAIN_GRAD_ACC}); "
        f"all {len(fp32)} leaves: kernel vs plain {whole['kernel_vs_plain']:.4g}, kernel vs fp32 "
        f"{whole['kernel_vs_fp32']:.4g}, plain vs fp32 {whole['plain_vs_fp32']:.4g}")
    if not (apart["kernel_vs_plain"] <= TRAIN_GRAD_RTOL and worst_ratio <= TRAIN_GRAD_ACC):
        raise AssertionError(f"the kernel-path gradients disagree with the plain path's: {apart}, "
                             f"{ratio}")
    return {"groups": groups, "all": whole}


def fp32_grads(loss_fn, images, targets):
    """The first step's gradients of the same weights with fp32 compute on
    the plain path."""
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.train.optim import create_optimizer
    from imagenet_models_tpu_torch.train.state import create_train_state, make_train_step

    model = create_model("map_convnext_tiny", dtype=torch.float32, ls_init_value=1.0,
                         generator=torch.Generator().manual_seed(SEED))
    opt = FirstGrads(create_optimizer("lamb", learning_rate=5e-3, weight_decay=0.05))
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, loss_fn, dec_lam=-0.8, use_kernel=False)
    torch.manual_seed(SEED + 10)
    step(state, images, targets, torch.Generator(device="cuda").manual_seed(SEED + 10))
    return opt.grads


def train():
    """The train path: six kernel-path steps with launch counts, and one
    plain-path step from a deep copy of the first state, whose loss, grad
    norm and gradients must agree with the kernel path's first step."""
    import torch

    from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp, fused_ln_mlp_bwd
    from imagenet_models_tpu_torch.train.state import make_train_step

    n_blocks = sum(STAGE_DEPTHS)
    state, opt, loss_fn = make_trainer()
    plain_state = copy.deepcopy(state)
    first = {k: p.detach().clone() for k, p in state.params().items()}
    kernel_opt, plain_opt = FirstGrads(opt), FirstGrads(opt)
    step = make_train_step(state.model, kernel_opt, loss_fn, dec_lam=-0.8, ema_decay=0.9999)
    plain_step = make_train_step(plain_state.model, plain_opt, loss_fn, dec_lam=-0.8,
                                 ema_decay=0.9999, use_kernel=False)
    images, targets = train_batch()
    gen = torch.Generator(device="cuda")

    fused_ln_mlp.launches = fused_ln_mlp_bwd.launches = 0
    metrics, per_step = [], []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        torch.manual_seed(SEED + 10 + i)  # the head's dropout masks
        before = (fused_ln_mlp.launches, fused_ln_mlp_bwd.launches)
        state, m = step(state, images, targets, gen.manual_seed(SEED + 10 + i))
        metrics.append({k: v.item() for k, v in m.items()})
        per_step.append((fused_ln_mlp.launches - before[0], fused_ln_mlp_bwd.launches - before[1]))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"fwd": fused_ln_mlp.launches, "bwd": fused_ln_mlp_bwd.launches}
    log(f"[train] {TRAIN_STEPS} steps of B={TRAIN_BATCH} in {train_s:.2f} s (first includes "
        f"warm-up); (forward, backward) launches per step: {per_step}")
    log("[train] loss per step: " + ", ".join(f"{m['loss']:.6f}" for m in metrics)
        + "; grad_norm per step: " + ", ".join(f"{m['grad_norm']:.6f}" for m in metrics))
    if per_step != [(n_blocks, n_blocks)] * TRAIN_STEPS:
        raise AssertionError(f"expected {n_blocks} forward and {n_blocks} backward kernel "
                             f"launches per step, got {per_step}")
    for m in metrics:
        if not all(map(lambda v: v == v and abs(v) != float("inf"), m.values())):
            raise AssertionError(f"non-finite train metrics: {metrics}")
    if state.step != TRAIN_STEPS:
        raise AssertionError(f"train state counted {state.step} steps")
    ema_moved = max((state.ema_params[k] - first[k]).abs().max().item() for k in first)
    moved = max((p.detach() - first[k]).abs().max().item() for k, p in state.params().items())
    log(f"[train] largest move from the initial weights: params {moved:.4g}, EMA shadow "
        f"{ema_moved:.4g}")
    if not 0.0 < ema_moved < moved:
        raise AssertionError("the EMA shadow did not move, or moved as far as the params")

    torch.manual_seed(SEED + 10)
    plain_state, pm = plain_step(plain_state, images, targets, gen.manual_seed(SEED + 10))
    pm = {k: v.item() for k, v in pm.items()}
    loss_rel = abs(metrics[0]["loss"] - pm["loss"]) / abs(pm["loss"])
    gnorm_rel = abs(metrics[0]["grad_norm"] - pm["grad_norm"]) / abs(pm["grad_norm"])
    log(f"[train] first step, kernel vs plain path: loss {metrics[0]['loss']:.6f} vs "
        f"{pm['loss']:.6f} (rel {loss_rel:.3g}, tol {TRAIN_LOSS_RTOL}); grad_norm "
        f"{metrics[0]['grad_norm']:.6f} vs {pm['grad_norm']:.6f} (rel {gnorm_rel:.3g}, tol "
        f"{TRAIN_GNORM_RTOL})")
    if not (loss_rel <= TRAIN_LOSS_RTOL and gnorm_rel <= TRAIN_GNORM_RTOL):
        raise AssertionError("the kernel-path train step disagrees with the plain path")
    grads = compare_grads(kernel_opt.grads, plain_opt.grads, fp32_grads(loss_fn, images, targets))
    kernel_opt.grads = plain_opt.grads = {}  # free them; later steps record nothing
    torch.cuda.empty_cache()
    check = {"losses": [m["loss"] for m in metrics], "grad_norms": [m["grad_norm"] for m in metrics],
             "plain_loss": pm["loss"], "plain_grad_norm": pm["grad_norm"], "loss_rel": loss_rel,
             "grad_norm_rel": gnorm_rel, "grads_rel": grads, "ema_moved": ema_moved,
             "params_moved": moved}
    return (state, step), (plain_state, plain_step), images, targets, launches, check


def train_throughput(kernel, plain, images, targets, card: str):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    fns = {}
    for name, (st, step) in (("kernel", kernel), ("plain", plain)):
        def run(st=st, step=step):
            step(st, images, targets, gen)
        fns[name] = run
    for fn in fns.values():
        for _ in range(TRAIN_WARMUP):
            fn()
    t = in_turns(fns, TRAIN_ITERS)
    runs = {k: [TRAIN_BATCH * 1000.0 / ms for ms in v] for k, v in t.items()}
    result = {k: sum(v) / len(v) for k, v in runs.items()}
    log(f"[train-throughput] map_convnext_tiny train B={TRAIN_BATCH} {IMG}px bf16 (LAMB, EMA): "
        f"kernel path {result['kernel']:.1f} img/s, plain path {result['plain']:.1f} img/s "
        f"(turns plain,kernel,kernel,plain: {runs['plain'][0]:.1f},{runs['kernel'][0]:.1f},"
        f"{runs['kernel'][1]:.1f},{runs['plain'][1]:.1f}) on {card}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return result, runs


def profile_step(kernel, images, targets, top: int = 15):
    """torch.profiler over one kernel-path train step: device time by kernel
    name, and the device's idle share of the span from the step's first
    kernel to its last (the profiler slows the host, so this span is longer
    than an unprofiled step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    st, step = kernel
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    step(st, images, targets, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(st, images, targets, gen)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    span_ms = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)) / 1e3
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == cuda:
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            rows.append({"name": ev.key, "ms": dev_us / 1e3, "count": ev.count})
    rows.sort(key=lambda r: -r["ms"])
    idle = max(0.0, 1 - busy_ms / span_ms)
    log(f"[profile] one train step: device span {span_ms:.2f} ms, kernels busy {busy_ms:.2f} ms, "
        f"idle share of the span {idle:.3f}")
    for r in rows[:top]:
        log(f"[profile]   {r['ms']:9.3f} ms  x{r['count']:<5d} {r['name'][:110]}")
    return {"span_ms": span_ms, "busy_ms": busy_ms, "idle_share": idle, "rows": rows[:40]}


def depth_weighted(times, key):
    return sum(d * r[key] for d, r in zip(STAGE_DEPTHS, times))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU", file=sys.stderr)
        return 2
    from imagenet_models_tpu_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] {kind}; nvidia-smi: {card}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    builds = _kernels.build_all()
    _kernels.ln_mlp_fwd_library()
    _kernels.ln_mlp_bwd_library()
    log(f"[build] {', '.join(f'{n}.cu -> {b.path.name} in {b.seconds:.1f} s' for n, b in builds.items())}"
        f"; {time.perf_counter() - t0:.1f} s in all, in parallel")
    for name, b in builds.items():
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {name}: {line.strip()}")

    fwd_rows, fwd_times = check_forward("exact", (64,))
    fast_rows, fast_times = check_forward("fast", (64, TRAIN_BATCH))
    bwd_rows, bwd_times = check_backward()
    model, serve_launches, logits_check = serve()
    bench, runs = throughput(model, card)
    del model
    kernel, plain, images, targets, train_launches, train_check = train()
    train_bench, train_runs = train_throughput(kernel, plain, images, targets, card)
    del plain
    prof = profile_step(kernel, images, targets)

    def entry(name, source, replaces, launches, rows, times):
        return {"name": name, "route": "cuda",
                "source": f"imagenet_models_tpu_torch/csrc/{source}",
                "replaces": f"imagenet_models_tpu/ops/convnext_block.py:{replaces}",
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                # one forward's or train step's 18 launches: depth-weighted over the stages
                "ms": depth_weighted(times, "ms"), "plain_ms": depth_weighted(times, "plain_ms"),
                "bound_ms": depth_weighted(times, "bound_ms"),
                "bound_by": "operations" if all(t["bound_by"] == "operations" for t in times)
                else "bytes",
                "library_ms": None}

    kernels = [
        entry("ln_mlp_fwd", "ln_mlp_fwd.cu", 341, serve_launches, fwd_rows, fwd_times[64]),
        entry("ln_mlp_fwd_fast", "ln_mlp_fwd.cu", 341, train_launches["fwd"], fast_rows,
              fast_times[TRAIN_BATCH]),
        entry("ln_mlp_bwd", "ln_mlp_bwd.cu", 474, train_launches["bwd"], bwd_rows, bwd_times),
    ]
    # every module of the port, the weights converter included, imports
    # nothing of JAX or of the JAX package
    import imagenet_models_tpu_torch

    for mod in pkgutil.walk_packages(imagenet_models_tpu_torch.__path__, "imagenet_models_tpu_torch."):
        importlib.import_module(mod.name)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "imagenet_models_tpu"))
    if leaked or "imagenet_models_tpu_torch.ckpt.convert" not in sys.modules:
        raise AssertionError(f"the port imported JAX-side modules: {leaked[:5]}")

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "device": kind, "card": card, "torch": torch.__version__,
        "build_seconds": {n: b.seconds for n, b in builds.items()},
        "forward_checks": fwd_rows, "forward_times": fwd_times,
        "forward_fast_checks": fast_rows, "forward_fast_times": fast_times,
        "backward_checks": bwd_rows, "backward_times_b128": bwd_times,
        "serving": logits_check, "serving_launches": serve_launches,
        "eval_img_s": bench, "eval_img_s_turns": runs,
        "train": train_check, "train_launches": train_launches,
        "train_img_s": train_bench, "train_img_s_turns": train_runs,
        "train_profile": prof, "kernels": kernels}, indent=2))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

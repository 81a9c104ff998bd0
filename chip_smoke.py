#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the map_convnext_tiny serving forward, at full
width on the card, through the entry points a user calls
(`create_model`, `serving.make_serving_fn`, `train.state.make_eval_step`),
with random weights from a fixed seed. Phases:

1. device: the card's name and power limit;
2. build: compile every CUDA kernel of the path from `csrc/`;
3. kernels: each kernel against its plain-PyTorch twin at the shapes the main
   path gives it (B=64 at 224 px), with times in turns (twin, kernel,
   kernel, twin) from CUDA events;
4. serving: four uint8 requests of 32 images through the kernel path, with
   launch counts per request, logits checked against the plain path, and one
   eval step;
5. throughput: eval img/s at B=256, kernel path and plain path in turns.

Any failure raises and exits non-zero. The last lines are a JSON summary of
the kernels, the card's name and power limit, and
`{"ok": true, "device": {...}}`. A copy of the measurements goes to
`chiprun_out/chip_smoke.json`. There is no CPU path: without CUDA the script
exits with status 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
STAGE_SHAPES = [(64 * 56 * 56, 96), (64 * 28 * 28, 192), (64 * 14 * 14, 384), (64 * 7 * 7, 768)]
RAGGED_SHAPE = (49 * 3 + 5, 768)
STAGE_DEPTHS = (3, 3, 9, 3)  # map_convnext_tiny: launches per stage in one forward
# bf16 kernel vs twin: both sum in fp32 in different orders, so a result may
# round to the neighbouring bf16 value; 1e-2 of the largest |output| is 2.5
# bf16 ulps at the top of the range.
KERNEL_RTOL = 1e-2
# kernel path vs plain path through 18 bf16 blocks and the head: one-ulp
# differences per block carry into the logits.
LOGITS_RTOL = 5e-2
REQUESTS, REQUEST_BATCH, IMG = 4, 32, 224
BENCH_BATCH, BENCH_ITERS = 256, 10
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


def ln_mlp_args(n: int, c: int, gen):
    import torch

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + shift

    return (randn(n, c).to(torch.bfloat16),
            randn(c, scale=0.1, shift=1.0), randn(c, scale=0.1),
            randn(4 * c, c, scale=c ** -0.5).to(torch.bfloat16), randn(4 * c, scale=0.1),
            randn(c, 4 * c, scale=(4 * c) ** -0.5).to(torch.bfloat16), randn(c, scale=0.1),
            randn(c))


def check_kernels():
    """Kernel vs twin at every main-path shape plus a ragged one."""
    import torch

    from imagenet_models_tpu_torch.ops.convnext_block import fused_ln_mlp, plain_ln_mlp

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for n, c in STAGE_SHAPES + [RAGGED_SHAPE]:
        args = ln_mlp_args(n, c, gen)
        with torch.inference_mode():
            got = fused_ln_mlp(*args)
            ref = plain_ln_mlp(*args)
            torch.cuda.synchronize()
            if got.shape != ref.shape or not torch.isfinite(got.float()).all():
                raise AssertionError(f"kernel output at ({n}, {c}) is malformed")
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            ok = err <= KERNEL_RTOL * scale
            iters = max(3, min(50, 2_000_000 // n))
            times = {"plain": [], "kernel": []}
            for which in ("plain", "kernel", "kernel", "plain"):
                fn = (lambda: fused_ln_mlp(*args)) if which == "kernel" else (lambda: plain_ln_mlp(*args))
                times[which].append(cuda_ms(fn, iters))
        row = {"n": n, "c": c, "max_abs_err": err, "max_abs_ref": scale,
               "tol": KERNEL_RTOL * scale, "ok": ok,
               "ms": sum(times["kernel"]) / 2, "plain_ms": sum(times["plain"]) / 2}
        rows.append(row)
        log(f"[kernels] ln_mlp_fwd N={n} C={c}: max|kernel-twin|={err:.4g} "
            f"(tol {KERNEL_RTOL * scale:.4g}, max|twin|={scale:.4g}) "
            f"kernel {row['ms']:.4f} ms, twin {row['plain_ms']:.4f} ms "
            f"(twin,kernel,kernel,twin: {times['plain'][0]:.4f},{times['kernel'][0]:.4f},"
            f"{times['kernel'][1]:.4f},{times['plain'][1]:.4f})")
        if not ok:
            raise AssertionError(f"kernel disagrees with its twin at ({n}, {c}): {err} > "
                                 f"{KERNEL_RTOL * scale}")
        del args, got, ref
    return rows


def serve():
    """The main path: map_convnext_tiny serving on the card, through the kernel."""
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
                         generator=torch.Generator().manual_seed(SEED), device="cuda")
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
    runs = {"plain": [], "kernel": []}
    with torch.inference_mode():
        for which in ("plain", "kernel", "kernel", "plain"):
            use = which == "kernel"
            ms = cuda_ms(lambda: model(x, use_kernel=use), BENCH_ITERS)
            runs[which].append(BENCH_BATCH * 1000.0 / ms)
    result = {k: sum(v) / len(v) for k, v in runs.items()}
    log(f"[throughput] map_convnext_tiny eval B={BENCH_BATCH} {IMG}px bf16: "
        f"kernel path {result['kernel']:.1f} img/s, plain path {result['plain']:.1f} img/s "
        f"(turns plain,kernel,kernel,plain: {runs['plain'][0]:.1f},{runs['kernel'][0]:.1f},"
        f"{runs['kernel'][1]:.1f},{runs['plain'][1]:.1f}) on {card}")
    return result, runs


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

    build = _kernels.build("ln_mlp_fwd")
    _kernels.ln_mlp_fwd_library()
    log(f"[build] ln_mlp_fwd.cu -> {build.path.name} in {build.seconds:.1f} s")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build]   {line.strip()}")

    rows = check_kernels()
    model, launches, logits_check = serve()
    bench, runs = throughput(model, card)

    stage = [r for r in rows if (r["n"], r["c"]) in STAGE_SHAPES]
    kernels = [{
        "name": "ln_mlp_fwd",
        "route": "cuda",
        "source": "imagenet_models_tpu_torch/csrc/ln_mlp_fwd.cu",
        "replaces": "imagenet_models_tpu/ops/convnext_block.py:341",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # one B=64 forward's 18 launches: depth-weighted sum over the stages
        "ms": sum(d * r["ms"] for d, r in zip(STAGE_DEPTHS, stage)),
        "plain_ms": sum(d * r["plain_ms"] for d, r in zip(STAGE_DEPTHS, stage)),
    }]
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "imagenet_models_tpu"))
    if leaked:
        raise AssertionError(f"the port imported JAX-side modules: {leaked[:5]}")

    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "device": kind, "card": card, "torch": torch.__version__,
        "build_seconds": build.seconds, "kernel_checks": rows, "serving": logits_check,
        "launches": launches, "eval_img_s": bench, "eval_img_s_turns": runs}, indent=2))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

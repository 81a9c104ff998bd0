#!/usr/bin/env python3
"""Time copies of kernels 9 and 13 on the card beside the built kernels and
the library calls, in turns, at the shapes of chip_smoke.py's phases 18 and
21; with a baseline, kernels 2 and 8 of another checkout beside this one's.

    python3 scripts/kernel_variants.py [--baseline DIR] [--out DIR]

Kernel 9 (`csrc/dw7_wgrad.cu`): the source as it is; copies with other tile
plans (the `Cfg<P, WL, NC, R>` lines); and diagnostic copies with the
products, the global loads or the step barrier taken out, which give wrong
sums and serve only to show where a step's time goes. Each copy that keeps
the numerics is held to float64 sums (chip_smoke.DW_SUM_RTOL). Kernel 13
(`csrc/window_attn_heads_fwd.cu`): the source as it is beside SDPA. With
`--baseline DIR` (the `csrc/` of another checkout, for example an earlier
commit unpacked with `git archive`), both kernels and kernel 12 are also
built from there and timed in turns with this checkout's, and kernel 12's
output bits are compared; and kernels 2 and 8 of that checkout, through a
copy of its host code (its C interface: PR 9's, before kernel 2 became a
pipeline of stages and kernel 8 one launch), are timed in turns with this
checkout's wrappers: kernel 2 at the four B=128 stage shapes of
map_convnext_tiny and per train step (3/3/9/3 launches), kernel 8 at every
BatchNorm shape of map_resnet50's B=128 train step and per step, beside
`torch.batch_norm_backward_reduce`. Every library is built with nvcc by
hand into `--out` (one process per source, all started together), with the
registers and SASS counts of this checkout's kernels 2, 9 and 13
(chip_smoke.code_report). Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CSRC = ROOT / "imagenet_models_tpu_torch" / "csrc"
# kernel 9 copies: name -> {text in dw7_wgrad.cu: its replacement}
DW_VARIANTS = {
    "wide R=1, 32 channels": {"CfgWide = Cfg<8, 4, 7, 4>": "CfgWide = Cfg<16, 2, 14, 1>"},
    "mid R=2": {"CfgMid = Cfg<16, 2, 7, 3>": "CfgMid = Cfg<16, 2, 7, 2>"},
    "no products": {
        "for (int kx = 0; kx < K; ++kx) E::mul_add_pair(acc[kx][0], acc[kx][1], win[kx], g);":
        "acc[j % K][0] += g.x + win[j % K].x; acc[j % K][1] += g.y + win[j % K].y;"},
    "no global loads": {"if (vrow[k] < (visx[k] ? nx : nd) && goff[k] >= 0)": "if (false)"},
    "no step barrier": {
        "__syncthreads();  // the next step's rows are in; this step's are free": "__syncwarp();"},
}
DIAGNOSTIC = ("no products", "no global loads", "no step barrier")
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build(jobs, out: Path) -> dict:
    """nvcc each (name, source) into out/<name>.so, all at once; returns
    {name: path} of those that built (a failure is logged)."""
    from imagenet_models_tpu_torch.ops import _kernels

    procs = {}
    for name, src in jobs:
        so = out / f"{name}.so"
        procs[name] = (subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(so),
                                         str(src)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    built = {}
    for name, (proc, so) in procs.items():
        text, _ = proc.communicate()
        (out / f"{name}.nvcc.log").write_text(text)
        if proc.returncode:
            cs.log(f"[build] {name} failed:\n{text[-2000:]}")
        else:
            built[name] = so
    return built


def dw_lib(path):
    lib = ctypes.CDLL(str(path))
    lib.imt_dw7_wgrad_slabs.argtypes = [I] * 4
    lib.imt_dw7_wgrad_slabs.restype = I
    lib.imt_dw7_wgrad.argtypes = [P, P] + [I] * 5 + [P] * 3
    lib.imt_dw7_wgrad.restype = I
    return lib


def heads_lib(path):
    lib = ctypes.CDLL(str(path))
    lib.imt_window_attn_heads_fwd.argtypes = [P] * 5 + [LL, I, I, I, I, P]
    lib.imt_window_attn_heads_fwd.restype = I
    return lib


def window_lib(path):
    lib = ctypes.CDLL(str(path))
    lib.imt_window_attn_fwd.argtypes = [P] * 5 + [LL, I, I, I, P]
    lib.imt_window_attn_fwd.restype = I
    return lib


def dw_run(lib, x, dy):
    import torch

    b, h, w, c = x.shape
    part = torch.empty(lib.imt_dw7_wgrad_slabs(b, h, w, c), 49, c, device="cuda")
    out = torch.empty(c, 1, 7, 7, device="cuda")
    err = lib.imt_dw7_wgrad(x.data_ptr(), dy.data_ptr(), 0 if x.dtype == torch.bfloat16 else 1,
                            b, h, w, c, part.data_ptr(), out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def heads_run(lib, q, k, v, bias):
    import torch

    out = torch.empty_like(q)
    bw, heads, n, d = q.shape
    err = lib.imt_window_attn_heads_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        bias.data_ptr(), out.data_ptr(), bw, heads, n, d,
                                        int(q.dtype == torch.bfloat16),
                                        torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def window_run(lib, q, k, v, bias):
    import torch

    out = torch.empty_like(q)
    bw, n, d = q.shape
    err = lib.imt_window_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  None if bias is None else bias.data_ptr(), out.data_ptr(),
                                  bw, n, d, int(q.dtype == torch.bfloat16),
                                  torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def old_bn_lib(path):
    lib = ctypes.CDLL(str(path))
    lib.imt_bn_slices.argtypes = [LL, I, I]
    lib.imt_bn_slices.restype = I
    lib.imt_bn_dot_sums.argtypes = [P, LL, I, P, LL, I, LL, I, I, I, P, P, P]
    lib.imt_bn_dot_sums.restype = I
    return lib


def old_dot_sums(lib, a, b):
    """The baseline's kernel 8 through a copy of its wrapper's host code
    (PR 9's ops/batch_norm.py `_launch`): the slice plan asked each call,
    two allocations, the device context, two launches."""
    import torch

    from imagenet_models_tpu_torch.ops import batch_norm as bn

    c = a.shape[-1]
    n = a.numel() // c
    operands = [(a, bn._row_stride(a)), (b, bn._row_stride(b))]
    v = 8 if all(t.dtype == torch.bfloat16 for t, _ in operands) else 4
    if any(c % v or ld % v or t.data_ptr() % (v * t.element_size()) for t, ld in operands):
        v = 1
    slices = lib.imt_bn_slices(n, c, v)
    partials = torch.empty(slices, 2 * c, dtype=torch.float32, device=a.device)
    out = torch.empty(2, c, dtype=torch.float32, device=a.device)
    args = []
    for t, ld in operands:
        args += [t.data_ptr(), ld, bn._DTYPES[t.dtype]]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.imt_bn_dot_sums(*args, n, c, v, slices, partials.data_ptr(), out.data_ptr(),
                                  stream)
    assert err == 0, err
    return out[0], out[1]


def old_bwd_lib(path):
    lib = ctypes.CDLL(str(path))
    lib.imt_ln_mlp_bwd_workspace_bytes.argtypes = [LL, I, I]
    lib.imt_ln_mlp_bwd_workspace_bytes.restype = LL
    lib.imt_ln_mlp_bwd_dx_bf16.argtypes = [P] * 14 + [LL, I, I, ctypes.c_float, I, P]
    lib.imt_ln_mlp_bwd_dx_bf16.restype = I
    lib.imt_ln_mlp_bwd_wgrad_bf16.argtypes = [P] * 10 + [LL, I, I, P]
    lib.imt_ln_mlp_bwd_wgrad_bf16.restype = I
    return lib


def old_ln_mlp_bwd(lib, h, g, ln_s, ln_b, w1, b1, w2, b2, gamma, fast=True):
    """The baseline's kernel 2 (halves (a) and (b)) through a copy of its
    wrappers' host code (PR 9's ops/convnext_block.py `ln_mlp_bwd_dx` and
    `ln_mlp_bwd_wgrad`); bf16 weights and fp32 vectors as given."""
    import torch

    n, c = h.shape
    hidden = w1.shape[0]
    dx, tok = torch.empty_like(h), torch.empty_like(h)
    hmid = torch.empty(n, hidden, dtype=torch.bfloat16, device=h.device)
    dpre1 = torch.empty_like(hmid)
    ws = torch.empty(lib.imt_ln_mlp_bwd_workspace_bytes(n, c, hidden), dtype=torch.uint8,
                     device=h.device)
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.imt_ln_mlp_bwd_dx_bf16(
        h.data_ptr(), g.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
        tok.data_ptr(), hmid.data_ptr(), dpre1.data_ptr(), ws.data_ptr(), n, c, hidden, 1e-6,
        int(fast), stream)
    assert err == 0, err
    dw1 = torch.empty(hidden, c, dtype=torch.float32, device=h.device)
    dw2 = torch.empty(c, hidden, dtype=torch.float32, device=h.device)
    vecs = torch.empty(hidden + 4 * c, dtype=torch.float32, device=h.device)
    err = lib.imt_ln_mlp_bwd_wgrad_bf16(
        tok.data_ptr(), hmid.data_ptr(), dpre1.data_ptr(), g.data_ptr(), w2.data_ptr(),
        gamma.data_ptr(), ws.data_ptr(), dw1.data_ptr(), dw2.data_ptr(), vecs.data_ptr(), n, c,
        hidden, stream)
    assert err == 0, err
    return dx, dw1, dw2, vecs


def kernel2(old, card: str) -> dict:
    """Kernel 2 of this checkout and of the baseline in turns at the B=128
    stage shapes; both held to the twin (chip_smoke.KERNEL_RTOL)."""
    import torch

    from imagenet_models_tpu_torch.ops import convnext_block as cb

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
    rows = []
    for n, c in cs.stage_shapes(cs.TRAIN_BATCH):
        args = cs.ln_mlp_args(n, c, gen)
        g = torch.randn(n, c, generator=gen, device="cuda").to(torch.bfloat16)
        ref = cb.plain_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl="fast")
        got = old_ln_mlp_bwd(old, args[0], g, *args[1:])
        errs = {"baseline dx": cs.rel_err(got[0], ref[0]),
                "baseline dw1": cs.rel_err(got[1], ref[3])}
        new = cb.fused_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl="fast")
        errs.update({"this checkout dx": cs.rel_err(new[0], ref[0]),
                     "this checkout dw1": cs.rel_err(new[3], ref[3])})
        if not all(e <= cs.KERNEL_RTOL for e in errs.values()):
            raise AssertionError(f"kernel 2 at ({n}, {c}) disagrees with its twin: {errs}")
        del ref, got, new
        fns = {"this checkout": lambda: cb.fused_ln_mlp_bwd(args[0], g, *args[1:],
                                                            gelu_impl="fast"),
               "baseline": lambda: old_ln_mlp_bwd(old, args[0], g, *args[1:])}
        iters = max(3, min(30, 1_000_000 // n))
        warm_up(fns, 2)
        turns = cs.in_turns(fns, iters, order=tuple(fns))
        ms = {arm: sum(t) / 2 for arm, t in turns.items()}
        cs.log(f"[kernel 2] B={cs.TRAIN_BATCH} N={n} C={c}: "
               + ", ".join(f"{arm} {v:.4f}" for arm, v in ms.items()) + f" ms on {card}")
        rows.append({"n": n, "c": c, "ms": ms, "turns": turns, "vs_twin": errs})
        del args, g
    step = per_unit(rows, cs.STAGE_DEPTHS)
    cs.log(f"[kernel 2] per map_convnext_tiny train step: "
           + ", ".join(f"{arm} {v:.4f}" for arm, v in step.items()) + f" ms on {card}")
    return {"rows": rows, "per_step_ms": step}


def kernel8(old, card: str) -> dict:
    """Kernel 8 of this checkout and of the baseline, and
    `torch.batch_norm_backward_reduce`, in turns at every BatchNorm shape of
    map_resnet50's B=128 train step (chip_smoke.bn_census); both kernels held
    to float64 sums (chip_smoke.BN_SUM_RTOL)."""
    import torch

    from imagenet_models_tpu_torch import create_model
    from imagenet_models_tpu_torch.ops import batch_norm as bn

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 13)
    model = create_model(cs.RESNET, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(cs.SEED))
    images = torch.randn(cs.TRAIN_BATCH, cs.IMG, cs.IMG, 3, generator=gen, device="cuda")
    census = cs.bn_census(model, images)
    del model, images
    torch.cuda.empty_cache()
    rows = []
    for (shape, _), count in census.items():
        c = shape[-1]
        x = (torch.randn(*shape, generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
        dy = torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
        x64, dy64 = x.reshape(-1, c).double(), dy.reshape(-1, c).double()
        exact = (dy64.sum(0), (dy64 * x64).sum(0))
        size = (dy64.abs().sum(0), (dy64 * x64).abs().sum(0))
        errs = {}
        for arm, got in (("this checkout", bn.fused_channel_dot_sums(dy, x)),
                         ("baseline", old_dot_sums(old, dy, x))):
            errs[arm] = max(((o.double() - e).abs() / z.clamp_min(1e-30)).max().item()
                            for o, e, z in zip(got, exact, size))
        if not all(e <= cs.BN_SUM_RTOL for e in errs.values()):
            raise AssertionError(f"kernel 8 at {shape} disagrees with float64: {errs}")
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        mean, invstd = torch.batch_norm_stats(xn, 1e-5)
        weight = torch.ones(c, device="cuda")
        fns = {"this checkout": lambda: bn.fused_channel_dot_sums(dy, x),
               "baseline": lambda: old_dot_sums(old, dy, x),
               "batch_norm_backward_reduce": lambda: torch.batch_norm_backward_reduce(
                   dyn, xn, mean, invstd, weight, False, True, True)}
        iters = max(5, min(100, 400_000_000 // x.numel()))
        with torch.inference_mode():
            warm_up(fns)
            turns = cs.in_turns(fns, iters, order=tuple(fns))
        ms = {arm: sum(t) / 2 for arm, t in turns.items()}
        cs.log(f"[kernel 8] {shape} x{count}: "
               + ", ".join(f"{arm} {v:.4f}" for arm, v in ms.items()) + f" ms on {card}")
        rows.append({"shape": list(shape), "count": count, "ms": ms, "turns": turns,
                     "vs_fp64": errs})
        del x, dy, xn, dyn, x64, dy64
    step = per_unit(rows, [r["count"] for r in rows])
    cs.log(f"[kernel 8] per {cs.RESNET} train step: "
           + ", ".join(f"{arm} {v:.4f}" for arm, v in step.items()) + f" ms on {card}")
    return {"rows": rows, "per_step_ms": step}


def warm_up(fns, rounds: int = 5) -> None:
    """A few calls of every arm before the timed turns, so that the first
    arm is not timed on a card that has been idle (the float64 references
    run before the turns)."""
    import torch

    for _ in range(rounds):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()


def per_unit(rows, weights):
    keys = rows[0]["ms"].keys()
    return {k: sum(w * r["ms"][k] for w, r in zip(weights, rows)) for k in keys}


def kernel9(libs, card: str) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 18)
    arms = {name: dw_lib(path) for name, path in libs.items()}
    rows = []
    for name, b, h, w, c, count in cs.DW_SHAPES:
        x = torch.randn(b, h, w, c, generator=gen, device="cuda").bfloat16()
        dy = (0.1 * torch.randn(b, h, w, c, generator=gen, device="cuda")).bfloat16()
        exact, size = cs.dw_fp64(x, dy)
        size = size.clamp_min(1e-30)
        errs = {arm: ((dw_run(lib, x, dy).double() - exact).abs() / size).max().item()
                for arm, lib in arms.items() if arm not in DIAGNOSTIC}
        bad = [arm for arm, e in errs.items() if not e <= cs.DW_SUM_RTOL]
        if bad:
            raise AssertionError(f"kernel 9 copies {bad} disagree with float64 at {name}")
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        weight = torch.zeros(c, 1, 7, 7, device="cuda", dtype=torch.bfloat16)
        fns = {arm: (lambda lib=lib: dw_run(lib, x, dy)) for arm, lib in arms.items()}
        fns["cuDNN conv2d_weight"] = lambda: torch.nn.grad.conv2d_weight(
            xn, weight.shape, dyn, padding=3, groups=c)
        xf, dyf = x.float(), dy.float()  # the same kernel on fp32 operands: one FFMA a product
        fns["this checkout, fp32"] = lambda: dw_run(arms["this checkout"], xf, dyf)
        with torch.inference_mode():
            warm_up(fns)
            turns = cs.in_turns(fns, 30, order=tuple(fns))
        ms = {arm: sum(t) / 2 for arm, t in turns.items()}
        cs.log(f"[kernel 9] {name} {(b, h, w, c)} x{count}: "
               + ", ".join(f"{arm} {v:.4f}" for arm, v in ms.items()) + f" ms on {card}")
        rows.append({"name": name, "shape": [b, h, w, c], "count": count, "ms": ms,
                     "turns": turns, "vs_fp64": errs})
        del x, dy, xn, dyn, xf, dyf, exact, size
    step = per_unit(rows, [r["count"] for r in rows])
    cs.log(f"[kernel 9] per {cs.GA_CONVNEXT} train step: "
           + ", ".join(f"{arm} {v:.4f}" for arm, v in step.items()) + f" ms on {card}")
    return {"rows": rows, "per_step_ms": step}


def kernel13(libs, card: str) -> dict:
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 21)
    arms = {name: heads_lib(path) for name, path in libs.items()}
    rows = []
    for tag, windows, heads, count in cs.MAXVIT_FLASH_SHAPES:
        q, k, v, bias = cs.flash_args("13", cs.BENCH_BATCH * windows, heads, 49, cs.FLASH_D,
                                      True, torch.bfloat16, gen)
        mask = bias[None].to(torch.bfloat16)
        fns = {arm: (lambda lib=lib: heads_run(lib, q, k, v, bias)) for arm, lib in arms.items()}
        fns["SDPA"] = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)
        with torch.inference_mode():
            warm_up(fns)
            turns = cs.in_turns(fns, 20, order=tuple(fns))
        ms = {arm: sum(t) / 2 for arm, t in turns.items()}
        cs.log(f"[kernel 13] {tag} {tuple(q.shape)} x{count}: "
               + ", ".join(f"{arm} {v:.4f}" for arm, v in ms.items()) + f" ms on {card}")
        rows.append({"tag": tag, "shape": list(q.shape), "count": count, "ms": ms, "turns": turns})
    forward = per_unit(rows, cs.MAXVIT_FLASH_WEIGHTS)
    cs.log(f"[kernel 13] per {cs.MAXVIT} eval forward, B=256: "
           + ", ".join(f"{arm} {v:.4f}" for arm, v in forward.items()) + f" ms on {card}")
    return {"rows": rows, "per_forward_ms": forward}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="csrc/ of another checkout to compare with")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "kernel_variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"[device] {torch.cuda.get_device_name(0)}; {card}; torch {torch.__version__}")
    args.out.mkdir(parents=True, exist_ok=True)
    jobs = [("dw7_wgrad", CSRC / "dw7_wgrad.cu"),
            ("window_attn_heads_fwd", CSRC / "window_attn_heads_fwd.cu")]
    source = (CSRC / "dw7_wgrad.cu").read_text()
    for i, (name, edits) in enumerate(DW_VARIANTS.items()):
        text = source
        for old, new in edits.items():
            if old not in text:
                raise SystemExit(f"kernel 9 copy {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        copy = args.out / f"dw7_wgrad_copy{i}.cu"
        copy.write_text(text)
        jobs.append((f"dw7_wgrad_copy{i}", copy))
    if args.baseline:
        for name in ("dw7_wgrad", "window_attn_heads_fwd", "window_attn_fwd", "ln_mlp_bwd",
                     "bn_dot_sums"):
            jobs.append((f"baseline_{name}", args.baseline / f"{name}.cu"))
        jobs.append(("window_attn_fwd", CSRC / "window_attn_fwd.cu"))
    jobs.append(("ln_mlp_bwd", CSRC / "ln_mlp_bwd.cu"))
    t0 = time.perf_counter()
    built = build(jobs, args.out)
    cs.log(f"[build] {len(built)} of {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s")
    from imagenet_models_tpu_torch.ops._kernels import Build

    for name in ("dw7_wgrad", "window_attn_heads_fwd", "ln_mlp_bwd"):
        if name in built:
            log = (args.out / f"{name}.nvcc.log").read_text()
            report = cs.code_report(Build(built[name], 0.0, log), name)
            (args.out / f"{name}.code.json").write_text(json.dumps(report, indent=1))
    dw_arms = {"this checkout": built["dw7_wgrad"]}
    if args.baseline:
        dw_arms["baseline"] = built["baseline_dw7_wgrad"]
    for i, name in enumerate(DW_VARIANTS):
        if f"dw7_wgrad_copy{i}" in built:
            dw_arms[name] = built[f"dw7_wgrad_copy{i}"]
    heads_arms = {"this checkout": built["window_attn_heads_fwd"]}
    if args.baseline:
        heads_arms["baseline"] = built["baseline_window_attn_heads_fwd"]
    result = {"card": card, "kernel 9": kernel9(dw_arms, card),
              "kernel 13": kernel13(heads_arms, card)}
    if args.baseline:
        digests = {arm: cs.k12_digest(lambda q, k, v, b, lib=window_lib(built[name]):
                                      window_run(lib, q, k, v, b))
                   for arm, name in (("this checkout", "window_attn_fwd"),
                                     ("baseline", "baseline_window_attn_fwd"))}
        cs.log(f"[kernel 12] output digests: {digests}; the same bits: "
               f"{len(set(digests.values())) == 1}")
        result["kernel 12 digests"] = digests
        from imagenet_models_tpu_torch.ops import _kernels

        _kernels.build_all(["ln_mlp_bwd", "bn_dot_sums"])  # the package's own builds
        result["kernel 2"] = kernel2(old_bwd_lib(built["baseline_ln_mlp_bwd"]), card)
        result["kernel 8"] = kernel8(old_bn_lib(built["baseline_bn_dot_sums"]), card)
    (args.out / "kernel_variants.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time copies of kernels 9 and 13 on the card beside the built kernels and
the library calls, in turns, at the shapes of chip_smoke.py's phases 18 and
21; with a baseline, kernels 1-6 and 9-13 of another checkout beside this
one's.

    python3 scripts/kernel_variants.py [--baseline DIR] [--kernels K ...] [--out DIR]

Kernel 9 (`csrc/dw7_wgrad.cu`): the source as it is; copies with other tile
plans (the `Cfg<P, WL, NC, R>` lines); and diagnostic copies with the
products, the global loads or the step barrier taken out, which give wrong
sums and serve only to show where a step's time goes. Each copy that keeps
the numerics is held to float64 sums (chip_smoke.DW_SUM_RTOL). Kernel 13
(`csrc/window_attn_heads_fwd.cu`): the source as it is beside SDPA. With
`--baseline DIR` (the `csrc/` of another checkout, for example an earlier
commit unpacked with `git archive`), both kernels and kernel 12 are also
built from there and timed in turns with this checkout's; kernel 12
(`csrc/window_attn_fwd.cu`) at the six B=128 shapes of ga_cswin_tiny's
flash route beside SDPA and this checkout's whole wrapper, per forward, by
CUDA events and by the profiler's device time, with its host time a call
(this checkout's wrapper, the baseline checkout's wrapper from
DIR/../ops/flash_attention.py where it exists, and the bare C entry), each
build held to the twin and in bf16 to float64, the fp32 instances' output
bits compared (`chip_smoke.k12_digest`) and HMMA looked for in every bf16
instance; kernels 1 and 2 of that checkout (one whose
kernel 1 has the one-launch C interface, without a workspace or stages, and
whose kernel 2 has this checkout's) are timed in turns with this checkout's:
kernel 1 through a copy of the one-launch wrapper's host code at the four
B=256 stage shapes of map_convnext_tiny with the exact GELU (per eval
forward) and the B=128 ones with the fast GELU (per train step's forward),
and its host time per call at one token tile (each checkout's whole wrapper
and each build's C entry); kernel 2 through this checkout's host code, at the four B=128
stage shapes and per train step (3/3/9/3 launches), its outputs also held to
the baseline's bits; kernels 5 and 6 (`csrc/stripe_attn_{fwd,bwd}.cu`, whose
C interface the baseline shares) through this checkout's wrappers at the
three B=128 stripe shapes of ga_cswin_tiny's path, per forward and per train
step, by CUDA events and by the profiler's device time (and this
checkout's host time a call, wrapper and C entry), both held to the
twins, with a line that says whether every bf16 instance's SASS holds
mma.sync (HMMA), beside a diagnostic copy of kernel 5 without its LePE
epilogue (wrong outputs; it shows the epilogue's share of the time);
kernels 3 and 4 (`csrc/partition_attn_{fwd,bwd}.cu`, whose C interface the
baseline shares) through this checkout's wrappers at the three B=128 stage
shapes of map_maxvit_tiny_tf_224's train step, block and grid, beside SDPA
(its backward for kernel 4), per launch and per train step, by CUDA events
and by the profiler's device time, with the host time a call of this
checkout's wrapper, the baseline's (DIR/../ops/partition_attention.py
around this checkout's library) and the bare C entry, each build held to
the twins, their bf16 outputs compared bit for bit with the baseline's at
every shape of chip_smoke's phase 8 (`partition_bits`), the fp32 instances'
output bits compared (`chip_smoke.k34_digest`), the registers, spills and
SASS counts of both libraries and HMMA looked for in every bf16 instance of
kernel 4, beside a copy of kernel 4 with the bias terms and the dbias sums
out of registers at T <= 64.
Kernels 10 and 11 (`csrc/convnext_branch_{fwd,bwd}.cu`, set 10-11): this
checkout's and the baseline's in turns with the block route (cuDNN's
depthwise conv and its gradients with kernels 1 and 2) at the four B=128
stage shapes of map_convnext_tiny, per forward and per train step, by CUDA
events and by the profiler's device time, this checkout's stage by stage
(the baseline's kernels through copies of the first design's host code, without
stages), both held to the twins, their fp32 output bits compared
(`chip_smoke.k1011_digest`), wgmma and TMA loads looked for in the bf16
GEMM stages (`chip_smoke.check_branch_code`); and kernels 1 and 2 of this
checkout held to the baseline's bits at chip_smoke's phase-3 shapes; and
the conv ring stages alone beside diagnostic copies (RING_VARIANTS: the
conv, the statistics, the per-channel pass, the global reads, the conv
backward's dx and tap roles each taken out; wrong outputs).
`--kernels` picks the sets to time (9, 13, 1, 2, 12, 5-6, 3-4, 10-11; all by
default): kernel 1's comparison needs a
baseline whose kernel 1 has the one-launch C interface, so a later baseline
is given with `--kernels 5-6` or the like. Every library is built with nvcc by hand into
`--out` (one process per source, all started together), with the registers
and SASS counts of this checkout's kernels 1-6 and 9-13
(chip_smoke.code_report).
Needs one NVIDIA GPU.
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
# kernel 5 copies: name -> {text in stripe_attn_fwd.cu: its replacement}
STRIPE_VARIANTS = {"no LePE epilogue": {"add_lepe<false>(o, Vs, W, D, m0, g, lane);": ""}}
# kernel 4 copies: {source: {text: its replacement}}; the same function with
# the bias terms and the dbias sums out of registers at T <= 64: read through
# L1/L2 a window, summed in the partials buffer
PARTITION_VARIANTS = {"bias and dbias sums out of registers": {
    "partition_attn_bwd": {"constexpr bool kRegs = NKB <= 4;": "constexpr bool kRegs = false;"}}}
# kernels 10 and 11 copies, diagnostic (wrong outputs; they show where the
# conv ring stages' time goes): name -> {file: {text: its replacement}}
RING_VARIANTS = {
    "no conv": {"convnext_branch_ring.cuh": {
        "    for (int it = tid; it < items; it += kRingThreads) {":
        "    for (int it = tid; it < 0; it += kRingThreads) {"}},
    "no statistics": {"convnext_branch_ring.cuh": {
        "    for (int t0 = 0; t0 < k.swv; t0 += kRingThreads / G) {":
        "    for (int t0 = 0; t0 < 0; t0 += kRingThreads / G) {"}},
    "no per-channel pass": {"convnext_branch_ring.cuh": {
        "    for (int it = tid; it < P * tpp; it += kRingThreads) {":
        "    for (int it = tid; it < 0; it += kRingThreads) {"}},
    "no global reads": {"convnext_branch_ring.cuh": {
        "                     valid);\n  }\n}": "                     false);\n  }\n}"}},
    "no dx role": {"convnext_branch_bwd.cu": {
        "    if (active && !tap_role) {": "    if (false) {"}},
    "no tap role": {"convnext_branch_bwd.cu": {
        "    } else if (active) {": "    } else if (false) {"}},
}
DIAGNOSTIC = ("no products", "no global loads", "no step barrier", "no LePE epilogue",
              *RING_VARIANTS)
# the kernels the script times, by the numbers of their TPU kernels; 1, 2,
# 3, 4, 5, 6 and 12 only beside a baseline
KERNEL_SETS = ("9", "13", "1", "2", "12", "5-6", "3-4", "10-11")
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build(jobs, out: Path) -> dict:
    """nvcc each (name, source) into out/<name>.so, all at once; returns
    {name: path} of those that built (a failure is logged)."""
    from imagenet_models_tpu_torch.ops import _kernels

    procs = {}
    for name, src in jobs:
        so = out / f"{name}.so"
        # -I: a copy written elsewhere finds this checkout's headers (a
        # source's own directory is searched first)
        procs[name] = (subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(CSRC),
                                         "-o", str(so), str(src)], stdout=subprocess.PIPE,
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


def lib_of(path, bind):
    """A library at `path` with the C signatures `bind` sets."""
    lib = ctypes.CDLL(str(path))
    lib.imt_cuda_error_string.argtypes = [I]
    lib.imt_cuda_error_string.restype = ctypes.c_char_p
    return bind(lib)


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


def old_fwd_lib(path):
    lib = ctypes.CDLL(str(path))
    lib.imt_ln_mlp_fwd_bf16.argtypes = [P] * 9 + [LL, I, I, ctypes.c_float, I, P]
    lib.imt_ln_mlp_fwd_bf16.restype = I
    lib.imt_ln_mlp_fwd_supported.argtypes = [I, I]
    lib.imt_ln_mlp_fwd_supported.restype = I
    lib.imt_cuda_error_string.argtypes = [I]
    lib.imt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def old_ln_mlp_fwd(lib, h, ln_s, ln_b, w1, b1, w2, b2, gamma, fast):
    """The baseline's kernel 1 through a copy of its wrapper's host code
    (the one-launch `fused_ln_mlp` of ops/convnext_block.py, before the
    workspace and stages); bf16 weights and fp32 vectors as given."""
    import torch

    n, c = h.shape
    out = torch.empty_like(h)
    err = lib.imt_ln_mlp_fwd_bf16(h.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
                                  b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
                                  out.data_ptr(), n, c, w1.shape[0], 1e-6, int(fast),
                                  torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def old_fused_ln_mlp(lib, h, ln_s, ln_b, w1, b1, w2, b2, gamma, eps=1e-6, gelu_impl="exact"):
    """A copy of the baseline's whole one-launch `fused_ln_mlp` wrapper
    (checks, operand casts, output allocation, the device context and the C
    entry), through this checkout's check helpers, which do the same work."""
    import torch

    from imagenet_models_tpu_torch.ops import convnext_block as cb

    cb._check_gelu(gelu_impl)
    cb._check_tokens("fused_ln_mlp", h)
    w1, w2, (s, b, bb1, bb2, g) = cb._kernel_operands("fused_ln_mlp", h, ln_s, ln_b, w1, b1, w2,
                                                      b2, gamma)
    n, c = h.shape
    hidden = w1.shape[0]
    if not lib.imt_ln_mlp_fwd_supported(c, hidden):
        raise ValueError(f"fused_ln_mlp does not take C={c}, hidden={hidden}")
    out = torch.empty_like(h)
    if not cb._aligned(h, w1, w2, out):
        raise ValueError("fused_ln_mlp needs 16-byte aligned tokens and weights")
    if n == 0:
        return out
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.imt_ln_mlp_fwd_bf16(
            h.data_ptr(), s.data_ptr(), b.data_ptr(), w1.data_ptr(), bb1.data_ptr(),
            w2.data_ptr(), bb2.data_ptr(), g.data_ptr(), out.data_ptr(),
            n, c, hidden, float(eps), int(gelu_impl == "fast"), stream)
    cb._raise_on(lib, err, "ln_mlp_fwd")
    return out


def kernel1(old, card: str) -> dict:
    """Kernel 1 of this checkout and of the baseline in turns at the B=256
    stage shapes with the exact GELU (one eval forward) and the B=128 ones
    with the fast GELU (one train step's forward); both held to the twin
    (chip_smoke.KERNEL_RTOL)."""
    import torch

    from imagenet_models_tpu_torch.ops import convnext_block as cb

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    result = {}
    for batch, gelu in ((cs.BENCH_BATCH, "exact"), (cs.TRAIN_BATCH, "fast")):
        rows = []
        for n, c in cs.stage_shapes(batch):
            args = cs.ln_mlp_args(n, c, gen)
            fast = gelu == "fast"
            with torch.inference_mode():
                ref = cb.plain_ln_mlp(*args, gelu_impl=gelu)
                errs = {"this checkout": cs.rel_err(cb.fused_ln_mlp(*args, gelu_impl=gelu), ref),
                        "baseline": cs.rel_err(old_ln_mlp_fwd(old, *args, fast), ref)}
                if not all(e <= cs.KERNEL_RTOL for e in errs.values()):
                    raise AssertionError(f"kernel 1 at ({n}, {c}) disagrees with its twin: {errs}")
                del ref
                fns = {"this checkout": lambda: cb.fused_ln_mlp(*args, gelu_impl=gelu),
                       "baseline": lambda: old_ln_mlp_fwd(old, *args, fast)}
                iters = max(3, min(50, 2_000_000 // n))
                warm_up(fns, 2)
                turns = cs.in_turns(fns, iters, order=tuple(fns))
            ms = {arm: sum(t) / 2 for arm, t in turns.items()}
            cs.log(f"[kernel 1] {gelu} B={batch} N={n} C={c}: "
                   + ", ".join(f"{arm} {v:.4f}" for arm, v in ms.items()) + f" ms on {card}")
            rows.append({"n": n, "c": c, "ms": ms, "turns": turns, "vs_twin": errs})
            del args
        total = per_unit(rows, cs.STAGE_DEPTHS)
        what = "eval forward" if gelu == "exact" else "train step's forward"
        cs.log(f"[kernel 1] per map_convnext_tiny {what}, B={batch}: "
               + ", ".join(f"{arm} {v:.4f}" for arm, v in total.items()) + f" ms on {card}")
        result[f"B={batch} {gelu}"] = {"rows": rows, "per_forward_ms": total}
    result["host_us"] = kernel1_host(old, card)
    return result


def host_us(fn, calls: int = 200) -> float:
    """Microseconds of host time a call of `fn` takes to enqueue its work:
    `calls` calls timed by the host clock before the one synchronisation
    after them (at a size whose device work is shorter than the host's)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def kernel1_host(old, card: str) -> dict:
    """Kernel 1's host time per call at one token tile of stage 0's width
    (N = 128, C = 96), in turns: each checkout's whole wrapper (this one's:
    checks, workspace, the C entry's tensor maps and three launches; the
    baseline's: checks, output, one launch, through a copy of its host code)
    and each checkout's C entry alone (this one's `_Fwd.run` on a kept call;
    the baseline's bare C call)."""
    import torch

    from imagenet_models_tpu_torch.ops import convnext_block as cb

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1)
    args = cs.ln_mlp_args(128, 96, gen)
    with torch.inference_mode():
        call = cb.ln_mlp_fwd_pipeline(*args)
        fns = {"this checkout, wrapper": lambda: cb.fused_ln_mlp(*args),
               "baseline, wrapper": lambda: old_fused_ln_mlp(old, *args),
               "this checkout, C entry": call.run,
               "baseline, C entry": lambda: old_ln_mlp_fwd(old, *args, False)}
        turns = {arm: [] for arm in fns}
        for arm in tuple(fns) + tuple(fns)[::-1]:
            turns[arm].append(host_us(fns[arm]))
    us = {arm: sum(t) / 2 for arm, t in turns.items()}
    cs.log("[kernel 1] host time per call, N=128 C=96: "
           + ", ".join(f"{arm} {v:.1f}" for arm, v in us.items()) + f" us on {card}")
    return {"us": us, "turns": turns}


def bwd_lib(path):
    """A build of kernel 2 with this checkout's C interface, which the
    baseline shares."""
    def bind(lib):
        lib.imt_ln_mlp_bwd_bf16.argtypes = [P] * 14 + [LL, I, I, ctypes.c_float, I, I, I, P]
        lib.imt_ln_mlp_bwd_bf16.restype = I
        return lib
    return lib_of(path, bind)


def run_bwd(lib, args, g):
    """One call of kernel 2 from the library `lib`, through this checkout's
    host code (`_Bwd`: operands, outputs, workspace, one launch of all its
    stages)."""
    from imagenet_models_tpu_torch.ops import convnext_block as cb

    call = cb._Bwd(args[0], g, *args[1:], 1e-6, "fast")
    call.lib = lib
    call.run()
    return call


def kernel2(old, card: str) -> dict:
    """Kernel 2 of this checkout and of the baseline in turns at the B=128
    stage shapes, through this checkout's host code: both held to the twin
    (chip_smoke.KERNEL_RTOL), and to each other's bits (kernel 2's device
    code is the baseline's; only its helpers moved to hopper_gemm.cuh)."""
    import torch

    from imagenet_models_tpu_torch.ops import _kernels
    from imagenet_models_tpu_torch.ops import convnext_block as cb

    new = _kernels.ln_mlp_bwd_library()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
    rows = []
    for n, c in cs.stage_shapes(cs.TRAIN_BATCH):
        args = cs.ln_mlp_args(n, c, gen)
        g = torch.randn(n, c, generator=gen, device="cuda").to(torch.bfloat16)
        ref = cb.plain_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl="fast")
        calls = {"this checkout": run_bwd(new, args, g), "baseline": run_bwd(old, args, g)}
        errs = {f"{arm} {k}": cs.rel_err(getattr(call, k), ref[i])
                for arm, call in calls.items() for k, i in (("dx", 0), ("dw1", 3))}
        same = all(torch.equal(getattr(calls["this checkout"], k), getattr(calls["baseline"], k))
                   for k in ("dx", "dw1", "dw2", "vecs"))
        if not (all(e <= cs.KERNEL_RTOL for e in errs.values()) and same):
            raise AssertionError(f"kernel 2 at ({n}, {c}) disagrees with its twin or with the "
                                 f"baseline's bits: {errs}, {same}")
        del ref, calls
        fns = {"this checkout": lambda: run_bwd(new, args, g),
               "baseline": lambda: run_bwd(old, args, g)}
        iters = max(3, min(30, 1_000_000 // n))
        warm_up(fns, 2)
        turns = cs.in_turns(fns, iters, order=tuple(fns))
        ms = {arm: sum(t) / 2 for arm, t in turns.items()}
        cs.log(f"[kernel 2] B={cs.TRAIN_BATCH} N={n} C={c}: "
               + ", ".join(f"{arm} {v:.4f}" for arm, v in ms.items())
               + f" ms on {card}; the baseline's bits: {same}")
        rows.append({"n": n, "c": c, "ms": ms, "turns": turns, "vs_twin": errs,
                     "baseline_bits": same})
        del args, g
    step = per_unit(rows, cs.STAGE_DEPTHS)
    cs.log(f"[kernel 2] per map_convnext_tiny train step: "
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


def host_window(lib, old, q, k, v) -> dict:
    """Kernel 12's host time per call (`host_us`) at (q, k, v), in turns:
    this checkout's wrapper, the baseline checkout's wrapper (the module
    `old`, None where the baseline has none; its host code around this
    checkout's library) and the bare C entry on a kept output and stream."""
    import torch

    from imagenet_models_tpu_torch.ops import flash_attention as fa

    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    bw, n, d = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(), bw, n, d, 1, stream)
    fns = {"this checkout, wrapper": lambda: fa.fused_window_attention(q, k, v),
           "C entry": lambda: lib.imt_window_attn_fwd(*args)}
    if old is not None:
        fns["baseline, wrapper"] = lambda: old.fused_window_attention(q, k, v)
    turns = {arm: [] for arm in fns}
    with torch.inference_mode():
        for arm in tuple(fns) + tuple(fns)[::-1]:
            turns[arm].append(host_us(fns[arm]))
    return {"us": {arm: sum(v) / 2 for arm, v in turns.items()}, "turns": turns}


def kernel12(libs, old, card: str) -> dict:
    """Kernel 12 of each build ({arm: library}, called bare) in turns with
    this checkout's whole wrapper and SDPA at the six B=128 shapes of
    ga_cswin_tiny's flash route (chip_smoke's CSWIN_FLASH_SHAPES, no bias),
    each build held to the twin (chip_smoke.KERNEL_RTOL) and to the float64
    function (its error beside the twin's); per launch by CUDA events and by
    the profiler's device time, per forward weighted by the path's launches;
    the host time per call at the stage-3 shape (`host_window`)."""
    import torch
    import torch.nn.functional as F

    from imagenet_models_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 21)
    rows = []
    for tag, windows, n, count in cs.CSWIN_FLASH_SHAPES:
        q, k, v, _ = cs.flash_args("12", cs.TRAIN_BATCH * windows, 1, n, cs.FLASH_D, False,
                                   torch.bfloat16, gen)
        fns = {arm: (lambda lib=lib: window_run(lib, q, k, v, None)) for arm, lib in libs.items()}
        fns["this checkout, wrapper"] = lambda: fa.fused_window_attention(q, k, v)
        fns["SDPA"] = lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)
        with torch.inference_mode():
            ref = fa.plain_fused_window_attention(q, k, v)
            exact = cs.flash_fp64("12", q, k, v, None)
            twin64 = (ref.double() - exact).abs().max().item()
            errs = {}
            for arm in libs:
                got = fns[arm]()
                errs[arm] = {"vs_twin": cs.rel_err(got, ref),
                             "fp64_ratio": (got.double() - exact).abs().max().item()
                             / max(twin64, 1e-30)}
            del ref, exact, got
            if not all(e["vs_twin"] <= cs.KERNEL_RTOL for e in errs.values()):
                raise AssertionError(f"kernel 12 at {tag} disagrees with its twin: {errs}")
            warm_up(fns)
            turns = cs.in_turns(fns, 20, order=tuple(fns))
            device = {arm: sum(ms for name, ms in cs.device_ms_by_kernel(
                fn, calls=10, per_launch=True).items() if name.startswith("window_attn"))
                for arm, fn in fns.items() if arm != "SDPA"}
        ms = {arm: sum(t) / 2 for arm, t in turns.items()}
        cs.log(f"[kernel 12] {tag} {tuple(q.shape)} x{count}: "
               + ", ".join(f"{arm} {v:.4f}" for arm, v in ms.items())
               + " ms by CUDA events; device (the profiler) "
               + ", ".join(f"{arm} {v:.4f}" for arm, v in device.items())
               + "; vs twin / float64 error over the twin's: "
               + ", ".join(f"{arm} {e['vs_twin']:.3g} / {e['fp64_ratio']:.3f}"
                           for arm, e in errs.items()) + f" on {card}")
        rows.append({"tag": tag, "shape": list(q.shape), "count": count, "ms": ms,
                     "device_ms": device, "turns": turns, "errors": errs})
        if tag == "stage3":
            host = host_window(libs["this checkout"], old, q, k, v)
            cs.log(f"[kernel 12] host time per call at {tag} {tuple(q.shape)}: "
                   + ", ".join(f"{arm} {v:.1f}" for arm, v in host["us"].items())
                   + f" us on {card}")
        del q, k, v
    forward = per_unit(rows, cs.CSWIN_FLASH_WEIGHTS)
    device = {arm: sum(r["count"] * r["device_ms"][arm] for r in rows)
              for arm in rows[0]["device_ms"]}
    cs.log(f"[kernel 12] per {cs.GA_CSWIN} forward, B={cs.TRAIN_BATCH}: "
           + ", ".join(f"{arm} {v:.4f}" for arm, v in forward.items())
           + " ms by CUDA events; device "
           + ", ".join(f"{arm} {v:.4f}" for arm, v in device.items()) + f" ms on {card}")
    torch.cuda.empty_cache()
    return {"rows": rows, "per_forward_ms": forward, "per_forward_device_ms": device,
            "host_us": host}


def load_module(path: Path, name: str):
    """The Python module at `path` under `name`, or None where there is none."""
    import importlib.util

    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def stripe_lib(path, fwd: bool):
    """A build of kernel 5 (fwd) or 6 with this checkout's C interface,
    which the baseline shares."""
    from imagenet_models_tpu_torch.ops import _kernels

    return lib_of(path, _kernels.bind_stripe_attn_fwd if fwd else _kernels.bind_stripe_attn_bwd)


STRIPE_LIBS = ("stripe_attn_fwd", "stripe_attn_bwd")
PARTITION_LIBS = ("partition_attn_fwd", "partition_attn_bwd")


def through(libs, fn, names=STRIPE_LIBS):
    """fn() with the package's libraries `names` (a forward's and a
    backward's) replaced by `libs`, so that it runs the wrappers' own host
    code."""
    from imagenet_models_tpu_torch.ops import _kernels

    keep = [getattr(_kernels, f"{n}_library") for n in names]
    for n, lib in zip(names, libs):
        setattr(_kernels, f"{n}_library", lambda lib=lib: lib)
    try:
        return fn()
    finally:
        for n, f in zip(names, keep):
            setattr(_kernels, f"{n}_library", f)


def kernels56(arms, card: str) -> dict:
    """Kernels 5 and 6 of each arm's build ({arm: (forward, backward)
    libraries}) in turns at the three B=128 stripe shapes of ga_cswin_tiny's
    path (chip_smoke's CSWIN_STRIPES: stage 3, the stage-5 block, a gram
    layer), through this checkout's wrappers; each held to the twins
    (chip_smoke.KERNEL_RTOL); per forward and per train step weighted by the
    path's launches."""
    import torch

    from imagenet_models_tpu_torch.ops import stripe_attention as sa

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    result = {}
    for which in ("fwd", "bwd"):
        rows = []
        for name, side, ws, c, nh, count in cs.CSWIN_STRIPES:
            if not count:
                continue
            q, k, v, w9, wb, g = args = cs.stripe_args(cs.TRAIN_BATCH, side, side, c, gen)
            scale = (c // nh) ** -0.5
            if which == "fwd":
                def call():
                    return sa.fused_stripe_attention(q, k, v, w9, wb, ws, nh, scale)
                ref = sa.plain_stripe_attention(q, k, v, w9, wb, ws=ws, nh=nh, scale=scale)
            else:
                def call():
                    return sa.fused_stripe_attention_bwd(q, k, v, w9, wb, g, ws, nh, scale)[:3]
                ref = sa.plain_stripe_attention_bwd(q, k, v, w9, wb, g, ws=ws, nh=nh,
                                                    scale=scale)[:3]
            fns = {arm: (lambda libs=libs: through(libs, call)) for arm, libs in arms.items()
                   if which == "fwd" or arm not in DIAGNOSTIC}
            with torch.inference_mode():
                errs = {arm: [cs.rel_err(o, r) for o, r in zip(
                    (fn(),) if which == "fwd" else fn(), (ref,) if which == "fwd" else ref)]
                    for arm, fn in fns.items() if arm not in DIAGNOSTIC}
                if not all(e <= cs.KERNEL_RTOL for v in errs.values() for e in v):
                    raise AssertionError(f"kernel {5 if which == 'fwd' else 6} at {name} "
                                         f"disagrees with its twin: {errs}")
                del ref
                warm_up(fns, 3)
                turns = cs.in_turns(fns, 30, order=tuple(fns))
                device = {arm: sum(v for k, v in cs.device_ms_by_kernel(
                    fn, calls=10, per_launch=True).items() if k.startswith("stripe_attn"))
                    for arm, fn in fns.items()}
                host = host_us(fns["this checkout"], 100)
            ms = {arm: sum(t) / 2 for arm, t in turns.items()}
            cs.log(f"[kernel {5 if which == 'fwd' else 6}] {name} B={cs.TRAIN_BATCH} "
                   f"{side}x{side} ws={ws} C={c} heads={nh} x{count}: "
                   + ", ".join(f"{arm} {v:.4f}" for arm, v in ms.items())
                   + " ms by CUDA events; device (the profiler) "
                   + ", ".join(f"{arm} {v:.4f}" for arm, v in device.items())
                   + f" ms; this checkout's host time {host:.1f} us a call on {card}")
            rows.append({"name": name, "count": count, "ms": ms, "device_ms": device,
                         "host_us": host, "turns": turns, "vs_twin": errs})
            del args, q, k, v, g
        total = per_unit(rows, [r["count"] for r in rows])
        device = {arm: sum(r["count"] * r["device_ms"][arm] for r in rows) for arm in total}
        what = "forward" if which == "fwd" else "train step"
        cs.log(f"[kernel {5 if which == 'fwd' else 6}] per {cs.GA_CSWIN} {what}, "
               f"B={cs.TRAIN_BATCH}: " + ", ".join(f"{arm} {v:.4f}" for arm, v in total.items())
               + " ms by CUDA events; device " + ", ".join(f"{arm} {v:.4f}"
                                                          for arm, v in device.items())
               + f" ms on {card}")
        result[which] = {"rows": rows, "per_unit_ms": total, "per_unit_device_ms": device}
    torch.cuda.empty_cache()
    return result


def partition_lib(path, fwd: bool):
    """A build of kernel 3 (fwd) or 4 with this checkout's C interface, which
    the baseline shares."""
    from imagenet_models_tpu_torch.ops import _kernels

    return lib_of(path,
                  _kernels.bind_partition_attn_fwd if fwd else _kernels.bind_partition_attn_bwd)


def host_partition(lib, old, which: str, args, part: str) -> dict:
    """Kernel 3's (fwd) or 4's host time per call (`host_us`), in turns:
    this checkout's wrapper, the baseline checkout's wrapper (the module
    `old`, around this checkout's library) and the bare C entry on kept
    outputs and stream."""
    import torch

    from imagenet_models_tpu_torch.ops import partition_attention as pa

    qkv, bias, g = args
    b, h, w, c3 = qkv.shape
    c, nh, (ph, pw), grid = c3 // 3, c3 // 96, cs.PS, int(part == "grid")
    stream = torch.cuda.current_stream().cuda_stream
    if which == "fwd":
        out = torch.empty(b, h, w, c, dtype=qkv.dtype, device=qkv.device)
        ptrs = (qkv.data_ptr(), bias.data_ptr(), out.data_ptr())
        fns = {"this checkout, wrapper": lambda: pa.fused_partition_attention(qkv, bias, part,
                                                                              cs.PS, nh),
               "baseline, wrapper": lambda: old.fused_partition_attention(qkv, bias, part, cs.PS,
                                                                          nh),
               "C entry": lambda: lib.imt_partition_attn_fwd_bf16(*ptrs, b, h, w, c, nh, ph, pw,
                                                                  grid, stream)}
    else:
        blocks = lib.imt_partition_attn_bwd_blocks(b * (h // ph) * (w // pw), nh)
        dqkv = torch.empty_like(qkv)
        part_buf = torch.empty(nh * blocks * (ph * pw) ** 2, dtype=torch.float32, device="cuda")
        dbias = torch.empty_like(bias)
        ptrs = (qkv.data_ptr(), bias.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
                part_buf.data_ptr(), dbias.data_ptr())
        fns = {"this checkout, wrapper": lambda: pa.fused_partition_attention_bwd(
                   qkv, bias, g, part, cs.PS, nh),
               "baseline, wrapper": lambda: old.fused_partition_attention_bwd(
                   qkv, bias, g, part, cs.PS, nh),
               "C entry": lambda: lib.imt_partition_attn_bwd_bf16(*ptrs, b, h, w, c, nh, ph, pw,
                                                                  grid, blocks, stream)}
    if old is None:
        del fns["baseline, wrapper"]
    turns = {arm: [] for arm in fns}
    with torch.inference_mode(which == "fwd"):
        for arm in tuple(fns) + tuple(fns)[::-1]:
            turns[arm].append(host_us(fns[arm], 100))
    return {"us": {arm: sum(v) / 2 for arm, v in turns.items()}, "turns": turns}


def partition_bits(arms, card: str) -> dict:
    """Kernels 3 and 4 of this checkout's build against the baseline's, bit
    for bit, on the bf16 inputs of chip_smoke's phase 8: ATTN_EXTRA_SHAPES
    and the three B=128 stage shapes, block and grid, through this
    checkout's wrappers."""
    import torch

    from imagenet_models_tpu_torch.ops import partition_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 7)
    shapes = [*cs.ATTN_EXTRA_SHAPES,
              *((cs.TRAIN_BATCH, side, side, nh, cs.PS) for side, _, nh in cs.MAXVIT_STAGES)]
    rows = []
    for b, h, w, nh, ps in shapes:
        qkv, bias, g = cs.attn_args(b, h, w, nh, ps, gen)
        for part in ("block", "grid"):
            def run():
                return (pa.fused_partition_attention(qkv, bias, part, ps, nh),
                        *pa.fused_partition_attention_bwd(qkv, bias, g, part, ps, nh))
            mine = through(arms["this checkout"], run, PARTITION_LIBS)
            base = through(arms["baseline"], run, PARTITION_LIBS)
            torch.cuda.synchronize()
            rows.append({"shape": [b, h, w, nh, list(ps)], "part": part,
                         "kernel 3": torch.equal(mine[0], base[0]),
                         "kernel 4": all(map(torch.equal, mine[1:], base[1:]))})
            del mine, base
        del qkv, bias, g
    same = {k: all(r[k] for r in rows) for k in ("kernel 3", "kernel 4")}
    cs.log(f"[kernels 3-4] bf16 outputs the baseline's bits at all {len(rows)} phase-8 shapes: "
           + ", ".join(f"{k} {v}" for k, v in same.items())
           + ("" if all(same.values()) else "; differ at " + ", ".join(
               f"{r['shape']} [{r['part']}] " + "/".join(k for k in same if not r[k])
               for r in rows if not (r["kernel 3"] and r["kernel 4"])))
           + f" on {card}")
    return {"same": same, "rows": rows}


def kernels34(arms, old, card: str) -> dict:
    """Kernels 3 and 4 of each arm's build ({arm: (forward, backward)
    libraries}) in turns with SDPA (its backward for kernel 4) at the three
    B=128 stage shapes of map_maxvit_tiny_tf_224's train step, block and
    grid, through this checkout's wrappers; each build held to the twins
    (chip_smoke.KERNEL_RTOL); per launch by CUDA events and by the
    profiler's device time, per train step weighted by the path's launches
    (chip_smoke.MAXVIT_STAGE_LAUNCHES, block and grid averaged as phase 8
    does); the host time per call at stage 2's block shape
    (`host_partition`)."""
    import torch

    from imagenet_models_tpu_torch.ops import partition_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 7)
    result, host = {}, {}
    for which in ("fwd", "bwd"):
        stages = []
        for side, c, nh in cs.MAXVIT_STAGES:
            args = cs.attn_args(cs.TRAIN_BATCH, side, side, nh, cs.PS, gen)
            qkv, bias, g = args
            rows = []
            for part in ("block", "grid"):
                if which == "fwd":
                    def call():
                        return (pa.fused_partition_attention(qkv, bias, part, cs.PS, nh),)
                    ref = (pa.plain_partition_attention(qkv, bias, part, cs.PS, nh),)
                else:
                    def call():
                        return pa.fused_partition_attention_bwd(qkv, bias, g, part, cs.PS, nh)
                    ref = pa.plain_partition_attention_bwd(qkv, bias, g, part, cs.PS, nh)
                mine = arms["this checkout"][which == "bwd"]  # arms that differ here
                fns = {arm: (lambda libs=libs: through(libs, call, PARTITION_LIBS))
                       for arm, libs in arms.items()
                       if arm == "this checkout" or libs[which == "bwd"] is not mine}
                library = cs.library_fns(args, part, cs.PS, nh)
                fns["SDPA"] = library[which]
                iters = max(5, min(50, 4_000_000 // (cs.TRAIN_BATCH * side * side)))
                with torch.inference_mode(which == "fwd"):
                    errs = {arm: [cs.rel_err(o, r) for o, r in zip(fns[arm](), ref)]
                            for arm in fns if arm != "SDPA"}
                    if not all(e <= cs.KERNEL_RTOL for v in errs.values() for e in v):
                        raise AssertionError(f"kernel {3 if which == 'fwd' else 4} at {side}x"
                                             f"{side} [{part}] disagrees with its twin: {errs}")
                    del ref
                    warm_up(fns, 3)
                    turns = cs.in_turns(fns, iters, order=tuple(fns))
                    device = {arm: sum(v for k, v in cs.device_ms_by_kernel(
                        fn, calls=10, per_launch=True).items() if k.startswith("partition_attn"))
                        for arm, fn in fns.items() if arm != "SDPA"}
                    device["SDPA"] = sum(cs.device_ms_by_kernel(fns["SDPA"], calls=10).values())
                    if side == cs.MAXVIT_STAGES[-1][0] and part == "block":
                        host[which] = host_partition(arms["this checkout"][which == "bwd"], old,
                                                     which, args, part)
                ms = {arm: sum(t) / 2 for arm, t in turns.items()}
                cs.log(f"[kernel {3 if which == 'fwd' else 4}] B={cs.TRAIN_BATCH} {side}x{side} "
                       f"C={c} [{part}]: " + ", ".join(f"{arm} {v:.4f}" for arm, v in ms.items())
                       + " ms by CUDA events; device (the profiler) "
                       + ", ".join(f"{arm} {v:.4f}" for arm, v in device.items())
                       + f" ms on {card}")
                rows.append({"part": part, "ms": ms, "device_ms": device, "turns": turns,
                             "vs_twin": errs})
                del library
            stages.append({"side": side, "c": c, "heads": nh, "rows": rows,
                           "ms": {arm: sum(r["ms"][arm] for r in rows) / 2 for arm in rows[0]["ms"]},
                           "device_ms": {arm: sum(r["device_ms"][arm] for r in rows) / 2
                                         for arm in rows[0]["device_ms"]}})
            del args, qkv, bias, g
        step = {key: {arm: sum(n * st[key][arm] for n, st in zip(cs.MAXVIT_STAGE_LAUNCHES, stages))
                      for arm in stages[0][key]} for key in ("ms", "device_ms")}
        cs.log(f"[kernel {3 if which == 'fwd' else 4}] per {cs.MAXVIT} train step, "
               f"B={cs.TRAIN_BATCH}: " + ", ".join(f"{arm} {v:.4f}" for arm, v in step["ms"].items())
               + " ms by CUDA events; device " + ", ".join(
                   f"{arm} {v:.4f}" for arm, v in step["device_ms"].items()) + f" ms on {card}")
        cs.log(f"[kernel {3 if which == 'fwd' else 4}] host time per call at stage 2 [block]: "
               + ", ".join(f"{arm} {v:.1f}" for arm, v in host[which]["us"].items())
               + f" us on {card}")
        result[which] = {"stages": stages, "per_step_ms": step["ms"],
                         "per_step_device_ms": step["device_ms"], "host_us": host[which]}
    torch.cuda.empty_cache()
    return result


BRANCH_LIBS = ("convnext_branch_fwd", "convnext_branch_bwd")
LN_MLP_LIBS = ("ln_mlp_fwd", "ln_mlp_bwd")


def old_branch_fwd_lib(path):
    """A build of kernel 10 with the first design's one-launch C interface (no
    workspace or stages)."""
    def bind(lib):
        lib.imt_convnext_branch_fwd_supported.argtypes = [I] * 3
        lib.imt_convnext_branch_fwd_supported.restype = I
        lib.imt_convnext_branch_fwd.argtypes = [P] * 11 + [I] * 6 + [ctypes.c_float, P]
        lib.imt_convnext_branch_fwd.restype = I
        return lib
    return lib_of(path, bind)


def old_branch_fwd(lib, x, params, eps=1e-6):
    """The baseline's kernel 10 through a copy of its wrapper's host code
    (the first design's one-launch `fused_convnext_branch` of
    ops/convnext_branch.py), through this checkout's operand helper, which
    does the same work."""
    import torch

    from imagenet_models_tpu_torch.ops import convnext_branch as cbr

    taps, w1, w2, (dwb, s, lb, bb1, bb2, gm) = cbr._operands("fused_convnext_branch", x, *params)
    b, h, w, c = x.shape
    hidden = w1.shape[0]
    if not lib.imt_convnext_branch_fwd_supported(c, hidden, cbr._DTYPES[x.dtype]):
        raise ValueError(f"the baseline's kernel 10 does not take C={c} in {x.dtype}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.imt_convnext_branch_fwd(
            x.data_ptr(), taps.data_ptr(), dwb.data_ptr(), s.data_ptr(), lb.data_ptr(),
            w1.data_ptr(), bb1.data_ptr(), w2.data_ptr(), bb2.data_ptr(), gm.data_ptr(),
            out.data_ptr(), cbr._DTYPES[x.dtype], b, h, w, c, hidden, float(eps), stream)
    cbr._raise_on(lib, err, "baseline convnext_branch_fwd")
    return out


def old_branch_bwd_lib(path):
    """A build of kernel 11 with the first design's C interface (no stages)."""
    def bind(lib):
        lib.imt_convnext_branch_bwd_supported.argtypes = [I] * 3
        lib.imt_convnext_branch_bwd_supported.restype = I
        lib.imt_convnext_branch_bwd_workspace_bytes.argtypes = [I] * 6
        lib.imt_convnext_branch_bwd_workspace_bytes.restype = LL
        lib.imt_convnext_branch_bwd.argtypes = [P] * 17 + [I] * 6 + [ctypes.c_float, P]
        lib.imt_convnext_branch_bwd.restype = I
        return lib
    return lib_of(path, bind)


def old_branch_bwd(lib, x, g, params, eps=1e-6):
    """The baseline's kernel 11 through a copy of its wrapper's host code
    (the first design's `fused_convnext_branch_bwd`: one call of every stage),
    through this checkout's operand helper, which does the same work."""
    import torch

    from imagenet_models_tpu_torch.ops import convnext_branch as cbr

    taps, w1c, w2c, (dwb, s, lb, bb1, bb2, gm) = cbr._operands(
        "fused_convnext_branch_bwd", x, *params)
    b, h, w, c = x.shape
    hidden = w1c.shape[0]
    code = cbr._DTYPES[x.dtype]
    nbytes = lib.imt_convnext_branch_bwd_workspace_bytes(b, h, w, c, hidden, code)
    if nbytes <= 0 or not lib.imt_convnext_branch_bwd_supported(c, hidden, code):
        raise ValueError(f"the baseline's kernel 11 does not take {tuple(x.shape)}")
    dev = x.device
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    ddw = torch.empty(c, 1, 7, 7, dtype=torch.float32, device=dev)
    dw1 = torch.empty(hidden, c, dtype=torch.float32, device=dev)
    dw2 = torch.empty(c, hidden, dtype=torch.float32, device=dev)
    vecs = torch.empty(hidden + 5 * c, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.imt_convnext_branch_bwd(
            x.data_ptr(), g.data_ptr(), taps.data_ptr(), dwb.data_ptr(), s.data_ptr(),
            lb.data_ptr(), w1c.data_ptr(), bb1.data_ptr(), w2c.data_ptr(), bb2.data_ptr(),
            gm.data_ptr(), dx.data_ptr(), ddw.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
            vecs.data_ptr(), workspace.data_ptr(), code, b, h, w, c, hidden, float(eps), stream)
    cbr._raise_on(lib, err, "baseline convnext_branch_bwd")
    db1, db2, dgamma, dln_s, dln_b, ddw_b = torch.split(vecs, [hidden, c, c, c, c, c])
    grads = (ddw, ddw_b, dln_s, dln_b, dw1, db1, dw2, db2, dgamma)
    return (dx,) + tuple(d.to(p.dtype) for d, p in zip(grads, params))


def branch_arms(libs):
    """{arm: (forward(x, params), backward(x, g, params))} of kernels 10 and
    11: this checkout's wrappers around this checkout's build; the
    baseline's kernels through copies of its host code (the first design's C
    interfaces, without stages)."""
    from imagenet_models_tpu_torch.ops import convnext_branch as cbr

    def arm(fwd_lib, bwd_lib, old):
        def fwd(x, params):
            if old:
                return old_branch_fwd(fwd_lib, x, params)
            return through((fwd_lib,), lambda: cbr.fused_convnext_branch(x, *params),
                           ("convnext_branch_fwd",))

        def bwd(x, g, params):
            if old:
                return old_branch_bwd(bwd_lib, x, g, params)
            return through((bwd_lib,), lambda: cbr.fused_convnext_branch_bwd(x, g, *params),
                           ("convnext_branch_bwd",))
        return fwd, bwd

    return {"this checkout": arm(libs["this fwd"], libs["this bwd"], False),
            "baseline": arm(libs["baseline fwd"], libs["baseline bwd"], True)}


def kernels12_bits(ln_libs, card: str) -> dict:
    """Kernels 1 and 2 of this checkout against the baseline's bits at
    chip_smoke's phase-3 shapes (the B=64 stage shapes, the ragged one and
    BWD_EDGE_SHAPES), both GELUs, through this checkout's wrappers: their
    GEMM stages now live in headers that kernels 10 and 11 share, and must
    have moved nothing."""
    import torch

    from imagenet_models_tpu_torch.ops import convnext_block as cb

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    shapes = ([(n, c, 0) for n, c in cs.stage_shapes(64) + [cs.RAGGED_SHAPE]]
              + list(cs.BWD_EDGE_SHAPES))
    moved = []
    with torch.inference_mode():
        for gelu in ("exact", "fast"):
            for n, c, hidden in shapes:
                args = cs.ln_mlp_args(n, c, gen, hidden)
                g = torch.randn(n, c, generator=gen, device="cuda").to(torch.bfloat16)
                outs = {}
                for arm, (f, b) in ln_libs.items():
                    outs[arm] = through((f, b), lambda: (
                        (cb.fused_ln_mlp(*args, gelu_impl=gelu),)
                        + cb.fused_ln_mlp_bwd(args[0], g, *args[1:], gelu_impl=gelu)), LN_MLP_LIBS)
                same = all(torch.equal(a, b) for a, b in zip(outs["this checkout"],
                                                             outs["baseline"]))
                if not same:
                    moved.append((gelu, n, c, hidden))
                del args, g, outs
    cs.log(f"[kernels 1-2] this checkout's outputs are the baseline's bits at {2 * len(shapes)} "
           f"(GELU, shape) cases: {not moved}" + (f"; moved at {moved}" if moved else "")
           + f" on {card}")
    if moved:
        raise AssertionError(f"kernels 1 and 2 moved from the baseline's bits at {moved}")
    return {"cases": 2 * len(shapes), "moved": moved}


def kernels1011(libs, card: str) -> dict:
    """Kernels 10 and 11 of this checkout and of the baseline (`branch_arms`)
    in turns with the block route (chip_smoke.block_route_fns, on this
    checkout's kernels 1 and 2) at the four B=128 stage shapes of
    map_convnext_tiny in bf16: each build held to the twins
    (chip_smoke.KERNEL_RTOL, every output); per launch by CUDA events and by
    the profiler's device time; this checkout's kernel 10 stage by stage; per
    forward (kernel 10) and per train step (kernel 11) weighted by the
    path's launches (chip_smoke.STAGE_DEPTHS)."""
    import torch

    from imagenet_models_tpu_torch.ops import convnext_branch as cbr

    arms = branch_arms(libs)
    ln = libs["this ln"]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 25)
    rows = {"fwd": [], "bwd": []}
    for name, b, h, w, c, count in cs.BRANCH_SHAPES:
        x, g, params = cs.branch_args(b, h, w, c, torch.bfloat16, gen)
        block_fwd, block_bwd = cs.block_route_fns(x, g, params)
        with torch.inference_mode():
            ref = (cbr.plain_convnext_branch(x, *params),) + cbr.plain_convnext_branch_bwd(
                x, g, *params)
            errs = {}
            for arm, (fwd, bwd) in arms.items():
                got = (fwd(x, params),) + bwd(x, g, params)
                errs[arm] = max(cs.rel_err(o, r) for o, r in zip(got, ref))
                del got
            del ref
            if not all(e <= cs.KERNEL_RTOL for e in errs.values()):
                raise AssertionError(f"kernels 10-11 at {name} disagree with their twins: {errs}")
            for which in ("fwd", "bwd"):
                if which == "fwd":
                    fns = {arm: (lambda f=f: f(x, params)) for arm, (f, _) in arms.items()}
                    fns["block route"] = lambda: through(ln, block_fwd, LN_MLP_LIBS)
                else:
                    fns = {arm: (lambda f=f: f(x, g, params)) for arm, (_, f) in arms.items()}
                    fns["block route"] = lambda: through(ln, block_bwd, LN_MLP_LIBS)
                iters = max(3, min(20, 4_000_000 // (b * h * w)) // (1 if which == "fwd" else 2))
                warm_up(fns, 2)
                turns = cs.in_turns(fns, iters, order=tuple(fns))
                device = {arm: sum(cs.device_ms_by_kernel(fn, calls=3).values())
                          for arm, fn in fns.items()}
                if which == "fwd":
                    run = through((libs["this fwd"],), lambda: cbr.convnext_branch_fwd_pipeline(
                        x, *params), ("convnext_branch_fwd",))
                else:
                    run = through((libs["this bwd"],), lambda: cbr.convnext_branch_bwd_pipeline(
                        x, g, *params), ("convnext_branch_bwd",))
                names = cbr.FWD_STAGES if which == "fwd" else cbr.BWD_STAGES
                stages = {st: cs.cuda_ms(lambda s=s: run(s, s + 1), iters)
                          for s, st in enumerate(names)}
                ms = {arm: sum(v) / 2 for arm, v in turns.items()}
                bound, by = cs.branch_bound_ms(b, h, w, c, which == "bwd")
                k = 10 if which == "fwd" else 11
                cs.log(f"[kernel {k}] B={b} {h}x{w} C={c} (x{count} per "
                       f"{'forward' if which == 'fwd' else 'step'}): "
                       + ", ".join(f"{arm} {v:.4f}" for arm, v in ms.items())
                       + " ms by CUDA events; device " + ", ".join(
                           f"{arm} {v:.4f}" for arm, v in device.items())
                       + " ms; this checkout's stages alone " + ", ".join(
                           f"{st} {v:.4f}" for st, v in stages.items())
                       + f"; bound {bound:.4f} ms ({by}) on {card}")
                rows[which].append({"name": name, "shape": [b, h, w, c], "count": count,
                                    "ms": ms, "device_ms": device, "stages_ms": stages,
                                    "turns": turns, "bound_ms": bound, "bound_by": by,
                                    "vs_twin": errs})
        del x, g, params, block_fwd, block_bwd
        torch.cuda.empty_cache()
    result = {}
    for which, unit in (("fwd", "forward"), ("bwd", "train step's backward")):
        total = {key: per_unit([{"ms": r[key]} for r in rows[which]], cs.STAGE_DEPTHS)
                 for key in ("ms", "device_ms")}
        bound = sum(n * r["bound_ms"] for n, r in zip(cs.STAGE_DEPTHS, rows[which]))
        cs.log(f"[kernel {10 if which == 'fwd' else 11}] per map_convnext_tiny {unit} at "
               f"B={cs.TRAIN_BATCH}: " + ", ".join(f"{arm} {v:.4f}" for arm, v in
                                                  total["ms"].items())
               + " ms by CUDA events; device " + ", ".join(
                   f"{arm} {v:.4f}" for arm, v in total["device_ms"].items())
               + f" ms; bound {bound:.4f} ms on {card}")
        result[which] = {"rows": rows[which], "per_unit_ms": total["ms"],
                         "per_unit_device_ms": total["device_ms"], "bound_ms": bound}
    return result


def ring_stages(arms, card: str) -> dict:
    """The conv ring stages of kernels 10 and 11 alone (kernel 10's stage 0;
    kernel 11's stages 0 and 4), each arm's build ({arm: (forward, backward)
    libraries}: this checkout's and the RING_VARIANTS copies) in turns at
    the four B=128 stage shapes, per forward and per step."""
    import torch

    from imagenet_models_tpu_torch.ops import convnext_branch as cbr

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 26)
    rows = []
    for name, b, h, w, c, count in cs.BRANCH_SHAPES:
        x, g, params = cs.branch_args(b, h, w, c, torch.bfloat16, gen)
        fns = {}
        with torch.inference_mode():
            for arm, (fl, bl) in arms.items():
                fwd = through((fl,), lambda: cbr.convnext_branch_fwd_pipeline(x, *params),
                              ("convnext_branch_fwd",))
                bwd = through((bl,), lambda: cbr.convnext_branch_bwd_pipeline(x, g, *params),
                              ("convnext_branch_bwd",))
                fns[(arm, "kernel 10 conv_ln")] = lambda r=fwd: r(0, 1)
                fns[(arm, "kernel 11 conv_ln")] = lambda r=bwd: r(0, 1)
                fns[(arm, "kernel 11 conv_bwd")] = lambda r=bwd: r(4, 5)
            warm_up(fns, 2)
            turns = cs.in_turns(fns, 10, order=tuple(fns))
        ms = {key: sum(v) / 2 for key, v in turns.items()}
        rows.append({"name": name, "count": count, "ms": ms})
        del x, g, params
    total = {key: sum(r["count"] * r["ms"][key] for r in rows) for key in rows[0]["ms"]}
    for arm in arms:
        cs.log(f"[ring stages] {arm}, per map_convnext_tiny forward or step at B={cs.TRAIN_BATCH}: "
               + ", ".join(f"{stage} {v:.4f}" for (a, stage), v in total.items() if a == arm)
               + f" ms (stage 0 shape: " + ", ".join(
                   f"{v:.4f}" for (a, _), v in rows[0]["ms"].items() if a == arm)
               + f") on {card}")
    return {"rows": [{"name": r["name"], "ms": {f"{a} | {s}": v for (a, s), v in r["ms"].items()}}
                     for r in rows],
            "per_unit_ms": {f"{a} | {s}": v for (a, s), v in total.items()}}


def mma_line(report: dict, tag: str) -> None:
    """Logs whether each tensor-core instance of a stripe kernel holds mma
    (HMMA) instructions in its SASS."""
    mma = {name: code.get("HMMA", 0) for name, code in report["sass"].items() if "_mma" in name}
    cs.log(f"[code] {tag}: HMMA in every bf16 instance: "
           f"{bool(mma) and all(mma.values())} ({len(mma)} instances, "
           f"{min(mma.values(), default=0)}-{max(mma.values(), default=0)} HMMA each)")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="csrc/ of another checkout to compare with")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "kernel_variants")
    ap.add_argument("--kernels", nargs="+", default=list(KERNEL_SETS), choices=list(KERNEL_SETS),
                    help="which kernels to time (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"[device] {torch.cuda.get_device_name(0)}; {card}; torch {torch.__version__}")
    args.out.mkdir(parents=True, exist_ok=True)
    want = set(args.kernels)
    if not args.baseline:
        want &= {"9", "13"}
    sources = {"9": ["dw7_wgrad"], "13": ["window_attn_heads_fwd"], "12": ["window_attn_fwd"],
               "1": ["ln_mlp_fwd"], "2": ["ln_mlp_bwd"], "5-6": ["stripe_attn_fwd", "stripe_attn_bwd"],
               "3-4": ["partition_attn_fwd", "partition_attn_bwd"],
               "10-11": [*BRANCH_LIBS, *LN_MLP_LIBS]}
    names = list(dict.fromkeys(n for key in KERNEL_SETS if key in want for n in sources[key]))
    jobs = [(n, CSRC / f"{n}.cu") for n in names]
    if args.baseline:
        jobs += [(f"baseline_{n}", args.baseline / f"{n}.cu") for n in names]
    if "5-6" in want:
        source = (CSRC / "stripe_attn_fwd.cu").read_text()
        for i, (name, edits) in enumerate(STRIPE_VARIANTS.items()):
            text = source
            for old, new in edits.items():
                if old not in text:
                    raise SystemExit(f"kernel 5 copy {name!r}: {old!r} is not in the source")
                text = text.replace(old, new)
            copy = args.out / f"stripe_attn_fwd_copy{i}.cu"
            copy.write_text(text)
            jobs.append((f"stripe_attn_fwd_copy{i}", copy))
    if "3-4" in want:
        for i, (name, files) in enumerate(PARTITION_VARIANTS.items()):
            for src, edits in files.items():
                text = (CSRC / f"{src}.cu").read_text()
                for old, new in edits.items():
                    if old not in text:
                        raise SystemExit(f"{src} copy {name!r}: {old!r} is not in the source")
                    text = text.replace(old, new)
                copy = args.out / f"{src}_copy{i}.cu"
                copy.write_text(text)
                jobs.append((f"{src}_copy{i}", copy))
    if "10-11" in want:
        for i, (name, files) in enumerate(RING_VARIANTS.items()):
            d = args.out / f"ring_copy{i}"
            d.mkdir(exist_ok=True)
            for src in ("convnext_branch_ring.cuh", *BRANCH_LIBS):
                fname = src if src.endswith(".cuh") else f"{src}.cu"
                text = (CSRC / fname).read_text()
                for old, new in files.get(fname, {}).items():
                    if old not in text:
                        raise SystemExit(f"{fname} copy {name!r}: {old!r} is not in the source")
                    text = text.replace(old, new)
                (d / fname).write_text(text)
            jobs += [(f"ring_copy{i}_{n}", d / f"{n}.cu") for n in BRANCH_LIBS]
    if "9" in want:
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
    t0 = time.perf_counter()
    built = build(jobs, args.out)
    cs.log(f"[build] {len(built)} of {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s")
    from imagenet_models_tpu_torch.ops._kernels import Build

    for name in ("dw7_wgrad", "window_attn_fwd", "window_attn_heads_fwd", "ln_mlp_fwd",
                 "ln_mlp_bwd", "stripe_attn_fwd", "stripe_attn_bwd", *PARTITION_LIBS):
        if name in built:
            log = (args.out / f"{name}.nvcc.log").read_text()
            report = cs.code_report(Build(built[name], 0.0, log), name)
            (args.out / f"{name}.code.json").write_text(json.dumps(report, indent=1))
            if name.startswith("stripe") or name in ("window_attn_fwd", "partition_attn_bwd"):
                mma_line(report, name)
    result = {"card": card}
    if "10-11" in want:
        from imagenet_models_tpu_torch.ops import _kernels

        builds = {n: Build(built[n], 0.0, (args.out / f"{n}.nvcc.log").read_text())
                  for n in BRANCH_LIBS}
        result["kernels 10 and 11 code"] = cs.check_branch_code(builds)["summary"]
        ln = {arm: (lib_of(built[f"{pre}ln_mlp_fwd"], _kernels.bind_ln_mlp_fwd),
                    lib_of(built[f"{pre}ln_mlp_bwd"], _kernels.bind_ln_mlp_bwd))
              for arm, pre in (("this checkout", ""), ("baseline", "baseline_"))}
        libs = {"this fwd": lib_of(built["convnext_branch_fwd"], _kernels.bind_convnext_branch_fwd),
                "this bwd": lib_of(built["convnext_branch_bwd"], _kernels.bind_convnext_branch_bwd),
                "baseline fwd": old_branch_fwd_lib(built["baseline_convnext_branch_fwd"]),
                "baseline bwd": old_branch_bwd_lib(built["baseline_convnext_branch_bwd"]),
                "this ln": ln["this checkout"]}
        digests = {arm: cs.k1011_digest(fwd, bwd) for arm, (fwd, bwd) in branch_arms(libs).items()}
        cs.log(f"[kernels 10-11] fp32 output digests: {digests}; the same bits: "
               f"{len(set(digests.values())) == 1}")
        result["kernels 10 and 11 fp32 digests"] = digests
        result["kernels 10 and 11"] = kernels1011(libs, card)
        copies = {name: (lib_of(built[f"ring_copy{i}_convnext_branch_fwd"],
                                _kernels.bind_convnext_branch_fwd),
                         lib_of(built[f"ring_copy{i}_convnext_branch_bwd"],
                                _kernels.bind_convnext_branch_bwd))
                  for i, name in enumerate(RING_VARIANTS)}
        result["ring stages"] = ring_stages(
            {"this checkout": (libs["this fwd"], libs["this bwd"]), **copies}, card)
        result["kernels 1 and 2 bits"] = kernels12_bits(ln, card)
    if "9" in want:
        dw_arms = {"this checkout": built["dw7_wgrad"]}
        if args.baseline:
            dw_arms["baseline"] = built["baseline_dw7_wgrad"]
        for i, name in enumerate(DW_VARIANTS):
            if f"dw7_wgrad_copy{i}" in built:
                dw_arms[name] = built[f"dw7_wgrad_copy{i}"]
        result["kernel 9"] = kernel9(dw_arms, card)
    if "13" in want:
        heads_arms = {"this checkout": built["window_attn_heads_fwd"]}
        if args.baseline:
            heads_arms["baseline"] = built["baseline_window_attn_heads_fwd"]
        result["kernel 13"] = kernel13(heads_arms, card)
    if "12" in want:
        libs = {"this checkout": window_lib(built["window_attn_fwd"]),
                "baseline": window_lib(built["baseline_window_attn_fwd"])}
        digests = {arm: cs.k12_digest(lambda q, k, v, b, lib=lib: window_run(lib, q, k, v, b))
                   for arm, lib in libs.items()}
        cs.log(f"[kernel 12] fp32 output digests: {digests}; the same bits: "
               f"{len(set(digests.values())) == 1}")
        result["kernel 12 fp32 digests"] = digests
        old = load_module(args.baseline.parent / "ops" / "flash_attention.py",
                          "baseline_flash_attention")
        result["kernel 12"] = kernel12(libs, old, card)
    if want & {"1", "2"}:
        from imagenet_models_tpu_torch.ops import _kernels

        _kernels.build_all(["ln_mlp_fwd", "ln_mlp_bwd"])  # the package's own builds
        if "1" in want:
            result["kernel 1"] = kernel1(old_fwd_lib(built["baseline_ln_mlp_fwd"]), card)
        if "2" in want:
            result["kernel 2"] = kernel2(bwd_lib(built["baseline_ln_mlp_bwd"]), card)
    if "5-6" in want:
        arms = {arm: (stripe_lib(built[f"{pre}stripe_attn_fwd"], True),
                      stripe_lib(built[f"{pre}stripe_attn_bwd"], False))
                for arm, pre in (("this checkout", ""), ("baseline", "baseline_"))}
        for i, name in enumerate(STRIPE_VARIANTS):
            if f"stripe_attn_fwd_copy{i}" in built:
                arms[name] = (stripe_lib(built[f"stripe_attn_fwd_copy{i}"], True),
                              arms["this checkout"][1])
        result["kernels 5 and 6"] = kernels56(arms, card)
    if "3-4" in want:
        arms = {arm: (partition_lib(built[f"{pre}partition_attn_fwd"], True),
                      partition_lib(built[f"{pre}partition_attn_bwd"], False))
                for arm, pre in (("this checkout", ""), ("baseline", "baseline_"))}
        for i, name in enumerate(PARTITION_VARIANTS):  # kernel 4 copies, this kernel 3
            if f"partition_attn_bwd_copy{i}" in built:
                arms[name] = (arms["this checkout"][0],
                              partition_lib(built[f"partition_attn_bwd_copy{i}"], False))
        from imagenet_models_tpu_torch.ops import partition_attention as pa

        digests = {arm: through(arms[arm], lambda: cs.k34_digest(pa.fused_partition_attention,
                                                                 pa.fused_partition_attention_bwd),
                                PARTITION_LIBS) for arm in ("this checkout", "baseline")}
        cs.log(f"[kernels 3-4] fp32 output digests: {digests}; the same bits: "
               f"{len(set(digests.values())) == 1}")
        result["kernels 3 and 4 fp32 digests"] = digests
        result["kernels 3 and 4 bf16 bits"] = partition_bits(arms, card)
        old = load_module(args.baseline.parent / "ops" / "partition_attention.py",
                          "baseline_partition_attention")
        result["kernels 3 and 4"] = kernels34(arms, old, card)
    (args.out / "kernel_variants.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

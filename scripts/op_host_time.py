#!/usr/bin/env python3
"""What calling kernels 1 and 5 through their `imtpu::` custom ops costs on
the host, and whether it shows in the models that call them: the custom op
(`torch.library.custom_op`, this checkout's wrappers) beside the same real
function registered with the lower-level `torch.library.Library`
define/impl, the wrappers of another checkout and the bare C entries.

    python3 scripts/op_host_time.py [--baseline DIR] [--out FILE]

Host time a call: each route called 200 times at a size whose device work is
shorter than the host's (kernel 1 at one token tile of stage 0, N = 128,
C = 96; kernel 5 at one image's stage-3 stripes of ga_cswin_tiny), timed by
the host clock before the one synchronisation after them, routes in turns.
Then map_convnext_tiny (18 calls of kernel 1 a forward) and ga_cswin_tiny
(27 of kernel 5) with each route patched in for its kernel's wrapper
(`ops.convnext_block.fused_ln_mlp`, `ops.stripe_attention.fused_stripe_attention`):
eval img/s at B=256 and train img/s at B=128 (chip_smoke.py's models and
recipes), the routes in turns (in order, then back) ROUNDS times over,
each turn after warm-up calls of every route.

DIR is the root of another checkout, for example the parent commit unpacked
with `git archive`: its `ops/convnext_block.py` and `ops/stripe_attention.py`
are loaded beside this package (with their op namespace renamed where they
define ops, so that both register) and call this checkout's kernel
libraries, whose C interfaces they must share. Its kernel-5 route takes
`pixel_rows` copies before the wrapper, where a checkout that calls the
kernel through a ctypes wrapper makes them. Prints one JSON line with the
card's name and power limit, and appends it to FILE with --out. Needs one
NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

# rounds of turns (the routes in order, then back) of every measurement
ROUNDS = 2
# iterations a turn: eval forwards, train steps of each model
ITERS = {"map_convnext_tiny": (20, 20), "ga_cswin_tiny": (10, 6)}


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def library_route(op_def, lib):
    """The real function of `op_def` (a `torch.library.custom_op`)
    registered as `<lib's namespace>::<its name>` through
    `torch.library.Library` define and a CUDA impl; returns the new op's
    overload."""
    import torch

    schema = str(op_def._opoverload._schema).split("::", 1)[1]
    name = schema.split("(", 1)[0]
    lib.define(schema)
    lib.impl(name, op_def._init_fn, "CUDA")
    return getattr(getattr(torch.ops, lib.ns), name).default


def baseline_module(root: Path, rel: str, name: str):
    """DIR's module at `rel`, loaded as `name` beside this package, its
    `imtpu` op namespace (if it defines ops) renamed `imtpu_baseline`."""
    source = (root / "imagenet_models_tpu_torch" / rel).read_text()
    source = source.replace('"imtpu::', '"imtpu_baseline::').replace(
        "torch.ops.imtpu.", "torch.ops.imtpu_baseline.")
    module = importlib.util.module_from_spec(importlib.util.spec_from_loader(name, loader=None))
    module.__file__ = str(root / "imagenet_models_tpu_torch" / rel)
    sys.modules[name] = module
    exec(compile(source, module.__file__, "exec"), module.__dict__)
    return module


def host_us(fn, calls: int = 200) -> float:
    """Microseconds of host time a call of `fn` takes to enqueue its work."""
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


def turns(fns, measure) -> dict:
    """measure(fns[route]) for every route in order, then back, ROUNDS
    times; returns {route: [value, ...]}."""
    out = {r: [] for r in fns}
    for _ in range(ROUNDS):
        for r in tuple(fns) + tuple(fns)[::-1]:
            out[r].append(measure(fns[r]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("op_host_time: no CUDA device", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    from imagenet_models_tpu_torch.ops import _kernels
    from imagenet_models_tpu_torch.ops import convnext_block as cb
    from imagenet_models_tpu_torch.ops import stripe_attention as sa
    from imagenet_models_tpu_torch.train.state import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    _kernels.build_all(["ln_mlp_fwd", "ln_mlp_bwd", "stripe_attn_fwd", "stripe_attn_bwd"])

    lib = torch.library.Library("imtpu_host_time", "DEF")
    lib_ln = library_route(cb._ln_mlp_fwd_op, lib)
    lib_st = library_route(sa._stripe_attn_fwd_op, lib)
    routes = {
        "ln": {"op": cb.fused_ln_mlp,
               "library": lambda h, ln_s, ln_b, w1, b1, w2, b2, gamma, eps=1e-6,
               gelu_impl="exact": lib_ln(h, ln_s, ln_b, w1, b1, w2, b2, gamma, float(eps),
                                         gelu_impl)},
        "st": {"op": sa.fused_stripe_attention,
               "library": lambda q, k, v, w9, wb, ws, nh, scale: lib_st(
                   q, k, v, w9, wb, ws, nh, float(scale))},
    }
    if args.baseline:
        old_cb = baseline_module(args.baseline.resolve(), "ops/convnext_block.py",
                                 "baseline_convnext_block")
        old_sa = baseline_module(args.baseline.resolve(), "ops/stripe_attention.py",
                                 "baseline_stripe_attention")
        routes["ln"]["baseline"] = old_cb.fused_ln_mlp
        routes["st"]["baseline"] = lambda q, k, v, *a: old_sa.fused_stripe_attention(
            sa.pixel_rows(q), sa.pixel_rows(k), sa.pixel_rows(v), *a)
    result = {"card": card, "torch": torch.__version__,
              "baseline": str(args.baseline) if args.baseline else None, "rounds": ROUNDS,
              "host_us": {}, "models": {}}

    # host time a call, and the bare C entries
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 33)
    ln_args = cs.ln_mlp_args(128, 96, gen)
    _, side, ws, c, heads, _ = cs.CSWIN_STRIPES[2]
    qkv = torch.randn(1, side, side, 3 * c, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    w9 = 0.1 * torch.randn(9, c, generator=gen, device="cuda")
    wb = 0.1 * torch.randn(1, c, generator=gen, device="cuda")
    st_args = (q, k, v, w9, wb, ws, heads, (c // heads) ** -0.5)
    call = cb.ln_mlp_fwd_pipeline(*ln_args)
    out = torch.empty(1, side, side, c, dtype=q.dtype, device="cuda")
    st_lib = _kernels.stripe_attn_fwd_library()
    c_args = (q.data_ptr(), sa._pixel_ld(q), k.data_ptr(), sa._pixel_ld(k), v.data_ptr(),
              sa._pixel_ld(v), w9.data_ptr(), wb.data_ptr(), out.data_ptr(), 1, side, side, c,
              heads, ws, sa._scale_in(st_args[-1], q.dtype),
              torch.cuda.current_stream().cuda_stream)
    for kernel, key, a, c_entry in ((1, "ln", ln_args, call.run),
                                    (5, "st", st_args,
                                     lambda: st_lib.imt_stripe_attn_fwd_bf16(*c_args))):
        ref = routes[key]["op"](*a)
        fns = {}
        for route, fn in routes[key].items():
            if not torch.equal(fn(*a), ref):
                raise AssertionError(f"kernel {kernel}: route {route} disagrees with the op")
            fns[route] = lambda fn=fn, a=a: fn(*a)
        fns["C entry"] = c_entry
        with torch.inference_mode():
            t = turns(fns, host_us)
        us = {r: sum(v) / len(v) for r, v in t.items()}
        result["host_us"][kernel] = {"us": us, "turns": t}
        cs.log(f"[host] kernel {kernel}: host time a call "
               + ", ".join(f"{r} {v:.1f}" for r, v in us.items()) + f" us on {card}")

    # the models that call them, each route patched in for its kernel's wrapper
    for name, (module, attr, key) in (("map_convnext_tiny", (cb, "fused_ln_mlp", "ln")),
                                      (cs.GA_CSWIN, (sa, "fused_stripe_attention", "st"))):
        if name == cs.GA_CSWIN:
            state, opt, loss_fn = cs.ga_trainer(cs.GA_CSWIN, torch.bfloat16)
            kw = dict(dec_lam=-0.8, ema_decay=cs.GA_EMA)
        else:
            state, opt, loss_fn = cs.make_trainer()
            kw = dict(dec_lam=-0.8, ema_decay=0.9999)
        step = make_train_step(state.model, opt, loss_fn, **kw)
        x = torch.randn(cs.BENCH_BATCH, cs.IMG, cs.IMG, 3, generator=gen, device="cuda")
        images, targets = cs.train_batch()
        step_gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
        original = getattr(module, attr)
        eval_iters, train_iters = ITERS[name]

        def routed(fn, run):
            # the op's real function counts its launches on the module's
            # wrapper, which is `fn` while `fn` is patched in
            if not hasattr(fn, "launches"):
                fn.launches = 0

            def go():
                setattr(module, attr, fn)
                try:
                    run()
                finally:
                    setattr(module, attr, original)
            return go

        def forward():
            with torch.inference_mode():
                state.model(x)

        row = {}
        for what, run, iters, batch in (
                ("eval", forward, eval_iters, cs.BENCH_BATCH),
                ("train", lambda: step(state, images, targets, step_gen), train_iters,
                 cs.TRAIN_BATCH)):
            state.model.train(what == "train")
            fns = {r: routed(fn, run) for r, fn in routes[key].items()}
            for fn in fns.values():
                for _ in range(2):
                    fn()
            t = turns(fns, lambda fn: cs.cuda_ms(fn, iters))
            runs = {r: [batch * 1000.0 / ms for ms in v] for r, v in t.items()}
            img_s = {r: sum(v) / len(v) for r, v in runs.items()}
            row[what] = {"img_s": img_s, "turns": runs, "iters": iters}
            cs.log(f"[model] {name} {what} B={batch}: " + ", ".join(
                f"{r} {v:.1f} img/s (turns {', '.join(f'{u:.1f}' for u in runs[r])})"
                for r, v in img_s.items()) + f" on {card}")
        result["models"][name] = row
        del state, opt, step, x, images, targets
        torch.cuda.empty_cache()

    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

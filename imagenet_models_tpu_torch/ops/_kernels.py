"""Build and load the package's CUDA kernels.

Each kernel is one `csrc/*.cu` file with a plain C interface (shared device
helpers in `csrc/*.cuh`). It is compiled with `nvcc` for sm_90a into a shared
library at first use and loaded with `ctypes`; nothing is compiled or loaded
when this module is imported. The library's file name carries a hash of the
sources and the flags, so an edited source is never served a stale build.
Builds go to `_build/` beside this package's `csrc/` (listed in .gitignore).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
KERNELS = ("ln_mlp_fwd", "ln_mlp_bwd", "partition_attn_fwd", "partition_attn_bwd",
           "stripe_attn_fwd", "stripe_attn_bwd", "bn_moments", "bn_dot_sums", "dw7_wgrad",
           "window_attn_fwd", "window_attn_heads_fwd", "convnext_branch_fwd",
           "convnext_branch_bwd")


@dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # 0.0 when an existing build was reused
    log: str        # nvcc's output, including ptxas's register/shared-memory report


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, Build]:
    """Compile `csrc/<name>.cu` into `_build/lib<name>-<hash>.so` for each name
    whose library does not exist yet, one nvcc process per source, all started
    together. Raises with nvcc's output if any build fails."""
    builds: Dict[str, Build] = {}
    running = {}
    for name in names:
        out = _target(name)
        if out.exists():
            builds[name] = Build(out, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, out, tmp, time.perf_counter())
    failed = []
    for name, (proc, out, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        builds[name] = Build(out, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return builds


def build(name: str) -> Build:
    """Compile one kernel's library, unless it exists."""
    return build_all([name])[name]


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def launch(entry: Callable[..., int], index: int, *args) -> int:
    """entry(*args, stream) on the current stream of CUDA device `index`,
    passed as its raw handle (no torch.cuda.Stream is built), with that
    device made current where it is not (a context switch only then)."""
    if index == torch.cuda.current_device():
        return entry(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return entry(*args, torch._C._cuda_getCurrentRawStream(index))


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(name).path))
    lib.imt_cuda_error_string.argtypes = [_I]
    lib.imt_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def ln_mlp_fwd_library() -> ctypes.CDLL:
    """The LN+MLP forward kernel's library (kernel 1), built on first call."""
    return bind_ln_mlp_fwd(_load("ln_mlp_fwd"))


def bind_ln_mlp_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C signatures of a build of kernel 1's library."""
    lib.imt_ln_mlp_fwd_supported.argtypes = [_I, _I]
    lib.imt_ln_mlp_fwd_supported.restype = _I
    lib.imt_ln_mlp_fwd_workspace_bytes.argtypes = [_LL, _I, _I]
    lib.imt_ln_mlp_fwd_workspace_bytes.restype = _LL
    for dt in ("bf16", "f32"):
        getattr(lib, f"imt_ln_mlp_fwd_{dt}").argtypes = [_P] * 10 + [_LL, _I, _I, _F, _I, _I, _I, _P]
        getattr(lib, f"imt_ln_mlp_fwd_{dt}").restype = _I
    lib.imt_ln_mlp_fwd_f32_workspace_bytes.argtypes = [_LL, _I, _I]
    lib.imt_ln_mlp_fwd_f32_workspace_bytes.restype = _LL
    return lib


@functools.cache
def ln_mlp_bwd_library() -> ctypes.CDLL:
    """The LN+MLP backward kernel's library (kernel 2), built on first call."""
    return bind_ln_mlp_bwd(_load("ln_mlp_bwd"))


def bind_ln_mlp_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C signatures of a build of kernel 2's library."""
    lib.imt_ln_mlp_bwd_supported.argtypes = [_I, _I]
    lib.imt_ln_mlp_bwd_supported.restype = _I
    lib.imt_ln_mlp_bwd_workspace_bytes.argtypes = [_LL, _I, _I]
    lib.imt_ln_mlp_bwd_workspace_bytes.restype = _LL
    for dt in ("bf16", "f32"):
        getattr(lib, f"imt_ln_mlp_bwd_{dt}").argtypes = [_P] * 14 + [_LL, _I, _I, _F, _I, _I, _I, _P]
        getattr(lib, f"imt_ln_mlp_bwd_{dt}").restype = _I
    lib.imt_ln_mlp_bwd_f32_workspace_bytes.argtypes = [_LL, _I, _I]
    lib.imt_ln_mlp_bwd_f32_workspace_bytes.restype = _LL
    return lib


def bind_partition_attn_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C signatures of a build of kernel 3's library."""
    for dt in ("bf16", "f32"):
        getattr(lib, f"imt_partition_attn_fwd_{dt}").argtypes = [_P] * 3 + [_I] * 8 + [_P]
        getattr(lib, f"imt_partition_attn_fwd_{dt}").restype = _I
    return lib


def bind_partition_attn_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C signatures of a build of kernel 4's library."""
    lib.imt_partition_attn_bwd_blocks.argtypes = [_LL, _I]
    lib.imt_partition_attn_bwd_blocks.restype = _I
    for dt in ("bf16", "f32"):
        getattr(lib, f"imt_partition_attn_bwd_{dt}").argtypes = [_P] * 6 + [_I] * 9 + [_P]
        getattr(lib, f"imt_partition_attn_bwd_{dt}").restype = _I
    return lib


@functools.cache
def partition_attn_fwd_library() -> ctypes.CDLL:
    """The partition-attention forward kernel's library (kernel 3), built on
    first call."""
    return bind_partition_attn_fwd(_load("partition_attn_fwd"))


@functools.cache
def partition_attn_bwd_library() -> ctypes.CDLL:
    """The partition-attention backward kernel's library (kernel 4), built on
    first call."""
    return bind_partition_attn_bwd(_load("partition_attn_bwd"))


def bind_stripe_attn_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C signatures of a build of kernel 5's library."""
    for dt in ("bf16", "f32"):
        getattr(lib, f"imt_stripe_attn_fwd_{dt}").argtypes = ([_P, _LL] * 3 + [_P] * 3 + [_I] * 6
                                                              + [_F, _P])
        getattr(lib, f"imt_stripe_attn_fwd_{dt}").restype = _I
    return lib


def bind_stripe_attn_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C signatures of a build of kernel 6's library."""
    lib.imt_stripe_attn_bwd_blocks.argtypes = [_LL, _I]
    lib.imt_stripe_attn_bwd_blocks.restype = _I
    for dt in ("bf16", "f32"):
        getattr(lib, f"imt_stripe_attn_bwd_{dt}").argtypes = ([_P, _LL] * 4 + [_P] * 7 + [_I] * 7
                                                              + [_F, _F, _P])
        getattr(lib, f"imt_stripe_attn_bwd_{dt}").restype = _I
    return lib


@functools.cache
def stripe_attn_fwd_library() -> ctypes.CDLL:
    """The stripe-attention + LePE forward kernel's library (kernel 5), built
    on first call."""
    return bind_stripe_attn_fwd(_load("stripe_attn_fwd"))


@functools.cache
def stripe_attn_bwd_library() -> ctypes.CDLL:
    """The stripe-attention + LePE backward kernel's library (kernel 6), built
    on first call."""
    return bind_stripe_attn_bwd(_load("stripe_attn_bwd"))


def _bn_plan(lib: ctypes.CDLL) -> None:
    lib.imt_bn_plan.argtypes = [_LL, _I, ctypes.POINTER(_LL)]
    lib.imt_bn_plan.restype = _I


@functools.cache
def bn_moments_library() -> ctypes.CDLL:
    """The BatchNorm forward statistics kernel's library (kernel 7), built on
    first call."""
    lib = _load("bn_moments")
    _bn_plan(lib)
    lib.imt_bn_moments.argtypes = [_P, _LL, _I, _LL, _I, _P, _P, _P]
    lib.imt_bn_moments.restype = _I
    return lib


@functools.cache
def bn_dot_sums_library() -> ctypes.CDLL:
    """The BatchNorm backward sums kernel's library (kernel 8), built on first
    call."""
    lib = _load("bn_dot_sums")
    _bn_plan(lib)
    lib.imt_bn_dot_sums.argtypes = [_P, _LL, _I, _P, _LL, _I, _LL, _I, _P, _P, _P]
    lib.imt_bn_dot_sums.restype = _I
    return lib


@functools.cache
def dw7_wgrad_library() -> ctypes.CDLL:
    """The depthwise 7x7 weight-gradient kernel's library (kernel 9), built
    on first call."""
    lib = _load("dw7_wgrad")
    lib.imt_dw7_wgrad_slabs.argtypes = [_I] * 4
    lib.imt_dw7_wgrad_slabs.restype = _I
    lib.imt_dw7_wgrad.argtypes = [_P, _P] + [_I] * 5 + [_P] * 3
    lib.imt_dw7_wgrad.restype = _I
    return lib


@functools.cache
def window_attn_fwd_library() -> ctypes.CDLL:
    """The fused window-attention forward kernel's library (kernel 12), built
    on first call."""
    lib = _load("window_attn_fwd")
    lib.imt_window_attn_fwd_supported.argtypes = [_I, _I]
    lib.imt_window_attn_fwd_supported.restype = _I
    lib.imt_window_attn_fwd.argtypes = [_P] * 5 + [_LL, _I, _I, _I, _P]
    lib.imt_window_attn_fwd.restype = _I
    return lib


@functools.cache
def window_attn_heads_fwd_library() -> ctypes.CDLL:
    """The per-head-bias window-attention forward kernel's library (kernel
    13), built on first call."""
    lib = _load("window_attn_heads_fwd")
    lib.imt_window_attn_heads_fwd_supported.argtypes = [_I, _I]
    lib.imt_window_attn_heads_fwd_supported.restype = _I
    lib.imt_window_attn_heads_fwd.argtypes = [_P] * 5 + [_LL, _I, _I, _I, _I, _P]
    lib.imt_window_attn_heads_fwd.restype = _I
    return lib


@functools.cache
def convnext_branch_fwd_library() -> ctypes.CDLL:
    """The fused ConvNeXt branch forward kernel's library (kernel 10), built
    on first call."""
    return bind_convnext_branch_fwd(_load("convnext_branch_fwd"))


def bind_convnext_branch_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C signatures of a build of kernel 10's library."""
    lib.imt_convnext_branch_fwd_supported.argtypes = [_I] * 3
    lib.imt_convnext_branch_fwd_supported.restype = _I
    lib.imt_convnext_branch_fwd_workspace_bytes.argtypes = [_I] * 6
    lib.imt_convnext_branch_fwd_workspace_bytes.restype = _LL
    lib.imt_convnext_branch_fwd.argtypes = [_P] * 12 + [_I] * 6 + [_F, _I, _I, _P]
    lib.imt_convnext_branch_fwd.restype = _I
    return lib


@functools.cache
def convnext_branch_bwd_library() -> ctypes.CDLL:
    """The fused ConvNeXt branch backward kernel's library (kernel 11), built
    on first call."""
    return bind_convnext_branch_bwd(_load("convnext_branch_bwd"))


def bind_convnext_branch_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C signatures of a build of kernel 11's library."""
    lib.imt_convnext_branch_bwd_supported.argtypes = [_I] * 3
    lib.imt_convnext_branch_bwd_supported.restype = _I
    lib.imt_convnext_branch_bwd_workspace_bytes.argtypes = [_I] * 6
    lib.imt_convnext_branch_bwd_workspace_bytes.restype = _LL
    lib.imt_convnext_branch_bwd.argtypes = [_P] * 17 + [_I] * 6 + [_F, _I, _I, _P]
    lib.imt_convnext_branch_bwd.restype = _I
    return lib

"""Build and load the package's CUDA kernels.

Each kernel is one `csrc/*.cu` file with a plain C interface. It is compiled
with `nvcc` for sm_90a into a shared library at first use and loaded with
`ctypes`; nothing is compiled or loaded when this module is imported. The
library's file name carries a hash of the source and the flags, so an edited
source is never served a stale build. Builds go to `_build/` beside this
package's `csrc/` (listed in .gitignore).
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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


def build(name: str) -> Build:
    """Compile `csrc/<name>.cu` into `_build/lib<name>-<hash>.so`, unless that exists."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return Build(out, seconds, log)


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.cache
def ln_mlp_fwd_library() -> ctypes.CDLL:
    """The LN+MLP forward kernel's library, built on first call."""
    lib = ctypes.CDLL(str(build("ln_mlp_fwd").path))
    lib.imt_ln_mlp_fwd_bf16.argtypes = [_P] * 9 + [_LL, _I, _I, _F, _P]
    lib.imt_ln_mlp_fwd_bf16.restype = _I
    lib.imt_ln_mlp_fwd_supported.argtypes = [_I, _I]
    lib.imt_ln_mlp_fwd_supported.restype = _I
    lib.imt_cuda_error_string.argtypes = [_I]
    lib.imt_cuda_error_string.restype = ctypes.c_char_p
    return lib

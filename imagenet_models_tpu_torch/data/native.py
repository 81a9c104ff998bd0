"""ctypes binding of the native (C++) decode pipeline, built at first use,
with a fallback to PIL. Port of imagenet_models_tpu/data/native.py.

The source is the port's own copy, `native/imtpu_loader.cpp`. It is compiled
with g++ into `_build/` beside this package's sources (listed in .gitignore),
under a file name that carries a hash of the source and the flags, so an
edited source is never served a stale build. Where g++ or libjpeg is absent
the build fails, a warning is logged and the loader decodes with PIL. This is
a host decoder: the GIL is released for each foreign call, and
`decode_batch` runs an internal std::thread pool.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_logger = logging.getLogger("imagenet_models_tpu_torch")
_lock = threading.Lock()
_lib = None
_tried = False

SOURCE = Path(__file__).resolve().parent.parent / "native" / "imtpu_loader.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
# the JAX package's Makefile flags: the same compiler choices give the same
# bytes from both packages' decoders on one host
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared"]
LIBS = ["-ljpeg", "-lpthread"]


def _cpu_flags() -> bytes:
    """This host's CPU feature flags: -march=native builds for them, so a
    build from another host (a copied tree) is not reused."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def _target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    digest.update(_cpu_flags())
    return BUILD_DIR / f"libimtpu_loader-{digest.hexdigest()[:16]}.so"


def _build_and_load() -> ctypes.CDLL:
    so = _target()
    if not so.exists():
        _logger.info("building the native loader (%s)...", SOURCE)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                               str(SOURCE), *LIBS], capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed (exit {proc.returncode}): {proc.stderr[-2000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.imtpu_decode_batch.restype = ctypes.c_int
    lib.imtpu_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    return lib


def get_native_lib():
    """The loaded library, or None where it could not be built (PIL then)."""
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            try:
                _lib = _build_and_load()
                _logger.info("native decode pipeline loaded")
            except (OSError, RuntimeError) as e:
                _logger.warning("native loader unavailable (%s); using PIL", e)
        return _lib


INTERP_CODES = {"bilinear": 0, "bicubic": 1, "random": 2}


def decode_batch(paths, seeds, size: int, mode: str, interpolation: str = "bicubic",
                 hflip: float = 0.5, vflip: float = 0.0,
                 scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 crop_pct: float = 0.875, num_threads: int = 0) -> np.ndarray:
    """Decode a batch of JPEGs to (N, size, size, 3) uint8. mode: train|eval.

    Train mode honours every pixel-affecting recipe knob: interpolation
    (bilinear, bicubic or 'random' per image), the hflip/vflip
    probabilities and the RandomResizedCrop --scale/--ratio ranges."""
    lib = get_native_lib()
    if lib is None:
        raise RuntimeError("the native loader is not available on this host")
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_seeds = (ctypes.c_uint64 * n)(*[int(s) & (2 ** 64 - 1) for s in seeds])
    nt = num_threads or os.cpu_count() or 1
    fails = lib.imtpu_decode_batch(
        c_paths, c_seeds, n, size, 0 if mode == "train" else 1,
        INTERP_CODES[interpolation], ctypes.c_float(hflip), ctypes.c_float(vflip),
        ctypes.c_float(scale[0]), ctypes.c_float(scale[1]),
        ctypes.c_float(ratio[0]), ctypes.c_float(ratio[1]),
        ctypes.c_float(crop_pct), nt,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if fails:
        _logger.warning("%d/%d images failed native decode (grey-filled)", fails, n)
    return out

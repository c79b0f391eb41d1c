"""The host library of exact quad IoUs (csrc/polyiou.cpp), built with g++
at first use and loaded with ctypes (counterpart of devkit/polygon.py's
_load_native, which loads a library that setup_native.py built).

The library lands in build/orientedreppoints_tpu_torch/host-<hash>/
beside the package's checkout, keyed on a hash of the source and the
flags.  Each build writes a file tagged with its process id and renames
it into place, so processes that build at once each load a whole
library.  A failed build raises; nothing falls back.

No torch here: the merge's spawn workers import numpy and the devkit
only (devkit/result_merge.py)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "polyiou.cpp"
BUILD_ROOT = _PKG.parent / "build" / "orientedreppoints_tpu_torch"
# no -march=native: the build directory may move to another host; no
# contraction into fused multiply-adds, which round once where numpy's
# separate multiply and add round twice
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off"]

_D = ctypes.POINTER(ctypes.c_double)
_N = ctypes.c_int64
SIGNATURES = {
    "poly_iou_pairs": [_D, _D, _N, _D],
    "poly_iou_matrix": [_D, _N, _D, _N, _D],
    "poly_iou_one_many": [_D, _D, _N, _D],
}

_lib = None
build_seconds = None  # g++ wall time of this process's build (0: cached)


def lib_path() -> Path:
    """Where the library of this hash of source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"host-{h.hexdigest()[:16]}" / "libpolyiou.so"


def build() -> tuple[Path, float]:
    """Compile csrc/polyiou.cpp unless this hash is built.  Returns
    (library path, seconds spent compiling)."""
    path = lib_path()
    if path.exists():
        return path, 0.0
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f"libpolyiou.{os.getpid()}.so"
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"g++ cannot run: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}"
                           f"\n{res.stdout}{res.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
    return path, time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _lib, build_seconds
    if _lib is None:
        path, build_seconds = build()
        handle = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = None
        _lib = handle
    return _lib


def _quads(polys) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(polys, np.float64).reshape(-1, 8))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_D)


def poly_iou_pairs(polys1, polys2) -> np.ndarray:
    """(n,) IoU(polys1[i], polys2[i]) of two (n, 8) arrays; polys2 may be
    one quad, then paired with every row of polys1."""
    p1 = _quads(polys1)
    p2 = _quads(np.broadcast_to(np.asarray(polys2, np.float64).reshape(-1, 8),
                                p1.shape))
    out = np.empty(len(p1), np.float64)
    lib().poly_iou_pairs(_ptr(p1), _ptr(p2), len(p1), _ptr(out))
    return out


def poly_iou_matrix(polys1, polys2) -> np.ndarray:
    """(n, m) IoU(polys1[i], polys2[j])."""
    p1, p2 = _quads(polys1), _quads(polys2)
    out = np.empty((len(p1), len(p2)), np.float64)
    lib().poly_iou_matrix(_ptr(p1), len(p1), _ptr(p2), len(p2), _ptr(out))
    return out


def poly_iou_one_many(quad, polys) -> np.ndarray:
    """(n,) IoU(quad, polys[k]), quad the clipped subject."""
    q, p = _quads(quad), _quads(polys)
    if len(q) != 1:
        raise ValueError(f"poly_iou_one_many: one quad, got {len(q)}")
    out = np.empty(len(p), np.float64)
    lib().poly_iou_one_many(_ptr(q), _ptr(p), len(p), _ptr(out))
    return out

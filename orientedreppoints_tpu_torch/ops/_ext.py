"""Build and load the CUDA kernels of ``csrc/`` (plain C ABI + ctypes).

At first use every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
one shared library under ``build/orientedreppoints_tpu_torch/<hash>/``
(next to the package's checkout), keyed on a hash of the sources and the
flags, then loaded with ctypes.  A failed build raises; nothing falls back.

Each exported C function launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()`` as an int; ``launch`` raises if
that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "orientedreppoints_tpu_torch"
# -fmad=false: no fused multiply-adds, so the kernels round as their plain
# PyTorch versions (separate multiply and add) do
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo"]

P = ctypes.c_void_p
I = ctypes.c_int
F32 = ctypes.c_float
# exported function -> argument types (pointers and the stream are c_void_p)
SIGNATURES = {
    "orp_min_area_rect": [P, P, P, P, I, P],
    "orp_quad_over_mask": [P, P, P, I, I, I, F32, P],
    "orp_nms_scan": [P, P, P, P, I, I, P],
    "orp_deform_sample_pair_f32": [P, P, P, P, P, P, I, I, I, I, P],
    "orp_deform_sample_pair_bf16": [P, P, P, P, P, P, I, I, I, I, P],
    "orp_deform_sample_pair_bwd_f32": [P] * 8 + [I, I, I, I, P],
    "orp_deform_sample_pair_bwd_bf16": [P] * 8 + [I, I, I, I, P],
    "orp_hull_quad_iou": [P, P, P, P, I, I, I, P],
}

_lib = None
build_seconds = None  # nvcc wall time of this process's build (0: cached)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> tuple[Path, float]:
    """Compile csrc/*.cu unless this hash of sources and flags is built.
    Returns (library path, seconds spent compiling)."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode() + src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "liborp_kernels.so"
    if lib_path.exists():
        return lib_path, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"liborp_kernels.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}"
                           f"\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all or none
    return lib_path, time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib, build_seconds
    if _lib is None:
        path, build_seconds = build()
        handle = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, *args) -> None:
    """Call an exported launcher; raise on a nonzero cudaGetLastError."""
    err = getattr(lib(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_cuda(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Validate a kernel input: CUDA, dtype, contiguity and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.device.index != 0:
        # the library carries its own CUDA runtime, whose current device is
        # the first one; multi-GPU serving is not ported yet
        raise NotImplementedError(f"{name}: kernels run on cuda:0 only")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")

"""Build and load the CUDA kernels of ``csrc/`` (plain C ABI + ctypes).

At first use every ``csrc/*.cu`` is compiled for ``sm_90a``, one ``nvcc``
for each source, all started together, and linked into one shared library
under ``build/orientedreppoints_tpu_torch/<hash>/`` (next to the package's
checkout), keyed on a hash of the sources, the headers they include
(``csrc/*.cuh``) and the flags, then loaded with ctypes.  A failed build
raises; nothing falls back.

Each exported C function takes the ordinal of its tensors' device and
the stream to launch on, makes that device current for the launch (the
library's own CUDA runtime does not see PyTorch's current device), allocates
nothing, and returns ``cudaGetLastError()`` as an int; ``launch`` passes the
device and stream of one input and raises if the result is not 0.
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
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-lineinfo"]

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F32 = ctypes.c_float
# exported function -> argument types (pointers and the stream are c_void_p);
# every one ends (..., device ordinal, stream)
SIGNATURES = {
    "orp_min_area_rect": [P, P, P, P, I, I, P],
    "orp_quad_over_mask": [P, P, P, I, I, F32, I, P],
    "orp_nms_scan": [P, P, P, P, I, I, I, P],
    "orp_deform_sample_pair_f32": [P, P, P, P, P, P, I, I, I, I, I, P],
    "orp_deform_sample_pair_bf16": [P, P, P, P, P, P, I, I, I, I, I, P],
    # ..., gtab, goff, work, work_bytes, rows, C, K, num_levels, ...
    "orp_deform_sample_pair_bwd_f32": [P] * 9 + [LL, I, I, I, I, I, P],
    "orp_deform_sample_pair_bwd_bf16": [P] * 9 + [LL, I, I, I, I, I, P],
    # the same two kernels at one table (the b pointers unused)
    "orp_deform_sample_f32": [P, P, P, P, P, P, I, I, I, I, I, P],
    "orp_deform_sample_bf16": [P, P, P, P, P, P, I, I, I, I, I, P],
    "orp_deform_sample_bwd_f32": [P] * 9 + [LL, I, I, I, I, I, P],
    "orp_deform_sample_bwd_bf16": [P] * 9 + [LL, I, I, I, I, I, P],
    "orp_hull_quad_iou": [P, P, P, P, P, P, I, I, I, I, P],
    "orp_quad_iou_full": [P, P, P, I, I, I, I, P],
    "orp_quad_iou_tri": [P, P, P, P, I, I, I, I, P],
    # points, quads, weight, giou, dgiou (weight and dgiou null: forward)
    "orp_convex_giou": [P, P, P, P, P, I, I, P],
}

_lib = None
build_seconds = None  # nvcc wall time of this process's build (0: cached)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path() -> Path:
    """Where the library of this hash of sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "liborp_kernels.so"


def built_path() -> Path | None:
    """The built library of the current sources, or None; builds nothing."""
    path = _lib_path()
    return path if path.exists() else None


def build() -> tuple[Path, float]:
    """Compile csrc/*.cu unless this hash of sources, headers and flags is
    built.  Returns (library path, seconds spent compiling)."""
    sources = sorted(CSRC.glob("*.cu"))
    lib_path = _lib_path()
    out_dir = lib_path.parent
    if lib_path.exists():
        return lib_path, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    tmp = out_dir / f"liborp_kernels.{tag}.so"
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    t0 = time.perf_counter()
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    results = [(cmd, p.communicate()[0], p.returncode)
               for cmd, p in zip(compiles, procs)]
    link = [nvcc, "-shared", *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]
    if all(rc == 0 for _, _, rc in results):
        res = subprocess.run(link, capture_output=True, text=True)
        results.append((link, res.stdout + res.stderr, res.returncode))
    for cmd, log, rc in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{log}")
    for obj in objs:
        obj.unlink()
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


def launch(name: str, *args, on: torch.Tensor) -> None:
    """Call an exported launcher with args, then the device ordinal and
    the current stream of `on`'s device; raise on a nonzero
    cudaGetLastError."""
    err = getattr(lib(), name)(*args, on.device.index, stream_ptr(on))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_dtype_shape(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Validate a kernel input's dtype and shape."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def check_cuda(t: torch.Tensor, name: str, dtype, shape=None,
               device: torch.device | None = None) -> None:
    """Validate a kernel input: CUDA, on `device` (the other inputs'),
    dtype, contiguity and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, the other inputs on "
                         f"{device}")
    check_dtype_shape(t, name, dtype, shape)
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")

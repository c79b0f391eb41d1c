#!/usr/bin/env python
"""What the f32 quad-IoU kernels (csrc/quad_iou.cu: the full matrix and its
upper triangle) spend their time on, on one NVIDIA GPU.

    python tools/profile_torch_quad_iou.py [--reps 20] [--against DIR]

Builds csrc/quad_iou.cu as it is and with parts of its work dropped, and
times each build on chip_smoke.py's own data (nms_quads from the seed of
its quad-kernel phase: the full matrix of image 0, N = M = 4096; the
triangle at B 4 with TRI_NV):
  - "no_clip": each pair's IoU is a cheap function of the pair (no clip),
    the loads, the tile's clip quads and the stores as in the kernel;
  - "no_store": the results are only summed, a store never taken;
  - "memset_only" (triangle): the launcher's memset and no kernel;
  - "no_memset" (triangle): the kernel without the launcher's memset;
  - "tile32": 32 x 32 tiles, one warp a block.
The dropped builds give wrong results; only their times are kept.
--against DIR builds the same file of another checkout's csrc/ (for
instance the parent commit's, unpacked beside the repo): the two run in
turns (other, this, this, other) on the same inputs, and their outputs are
compared bit for bit (its launchers must take the device ordinal before
the stream, as this checkout's do).  Prints the compiler's register and spill lines of
this source, then one JSON line a kernel with the card's name and power
limit.  The profiler of the machine gives no hardware counters, so the
split of a kernel's time is measured this way.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = osp.join(ROOT, "orientedreppoints_tpu_torch", "csrc")

PAIR = ("        iou = pair_iou<V, TILE>(hx, hy, V, q, &s_ax[0][tid], "
        "&s_ay[0][tid],\n"
        "                                &s_bx[0][tid], &s_by[0][tid]);\n")
CHEAP = "        iou = hx[0] * hy[1] + q.area;\n"
STORE = "    if (vec && g + GROUP <= cols) {\n"
SUM = ("    if (v[0] + v[1] + v[2] + v[3] + v[4] + v[5] + v[6] + v[7] == "
       "-1.f)\n      dst[g] = 0.f;\n    if (false) {\n")
SCALAR = "    } else {\n#pragma unroll\n"
LAUNCH = ("      quad_iou_kernel<true><<<dim3((unsigned)tiles, B), TILE, 0, "
          "s>>>(\n          a, c, nv, out, N, M, P, vec);\n")
MEMSET = "cudaMemsetAsync(out, 0, (size_t)B * N * M * sizeof(float), s);"
TILE = "constexpr int TILE = 64; "
VARIANTS = {"kernel": [], "no_clip": [(PAIR, CHEAP)],
            "no_store": [(STORE, SUM), (SCALAR, "    } else if (false) {\n")],
            "memset_only": [(LAUNCH, "")],
            "no_memset": [(MEMSET, "cudaSuccess;")],
            "tile32": [(TILE, "constexpr int TILE = 32; ")]}
TRI_ONLY = ("memset_only", "no_memset")
ENTRIES = {"full": "orp_quad_iou_full", "tri": "orp_quad_iou_tri"}


def build(against: str | None) -> tuple[dict, str]:
    """Compile every variant of this source (and the other checkout's file
    as it is) into its own library; returns (name -> library, the
    compiler's resource lines for this source)."""
    from orientedreppoints_tpu_torch.ops import _ext

    with open(osp.join(CSRC, "quad_iou.cu")) as f:
        text = f.read()
    with open(osp.join(CSRC, "clip_ring.cuh")) as f:
        key = hashlib.sha256((text + f.read()).encode()).hexdigest()[:16]
    out = osp.join(ROOT, "build", "profile_torch_quad_iou", key)
    os.makedirs(out, exist_ok=True)
    sources = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel source changed; "
                                   "update this tool's substitutions")
            src = src.replace(old, new)
        sources[name] = (osp.join(out, f"quad_iou_{name}.cu"), CSRC)
        with open(sources[name][0], "w") as f:
            f.write(src)
    if against:
        sources["other"] = (osp.join(against, "quad_iou.cu"), against)
    procs = {}
    for name, (src, inc) in sources.items():
        extra = ["-Xptxas", "-v"] if name == "kernel" else []
        procs[name] = subprocess.Popen(
            [_ext._nvcc(), *_ext.NVCC_FLAGS, *extra, "-I", inc, "-shared",
             "-o", osp.join(out, f"quad_iou_{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, resources = {}, ""
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if name == "kernel":
            resources = "\n".join(line for line in log.splitlines()
                                  if "registers" in line or "spill" in line
                                  or "Compiling entry" in line)
        lib = ctypes.CDLL(osp.join(out, f"quad_iou_{name}.so"))
        libs[name] = {}
        for kind, entry in ENTRIES.items():
            fn = getattr(lib, entry)
            fn.argtypes = _ext.SIGNATURES[entry]
            fn.restype = ctypes.c_int
            libs[name][kind] = fn
    return libs, resources


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs, resources = build(args.against)
    print(resources, flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ordinal = torch.cuda.current_device()
    rng = np.random.default_rng(chip_smoke.SEED + 2)  # phase_quad_kernels
    n = chip_smoke.NQ
    q4 = torch.tensor(chip_smoke.nms_quads(rng, 4, n), dtype=torch.float32,
                      device=dev)
    q = q4[:1].contiguous()
    nv = torch.tensor(chip_smoke.TRI_NV, dtype=torch.int32, device=dev)
    cases = {
        "full": (q, lambda fn, out: fn(q.data_ptr(), q.data_ptr(),
                                       out.data_ptr(), 1, n, n, ordinal,
                                       stream)),
        "tri": (q4, lambda fn, out: fn(q4.data_ptr(), q4.data_ptr(),
                                       nv.data_ptr(), out.data_ptr(), 4, n,
                                       n, ordinal, stream)),
    }
    order = ["other", "kernel", "kernel", "other"] if args.against else \
        ["kernel"]
    for kind, (x, launch) in cases.items():
        outs = {name: torch.empty((x.shape[0], n, n), device=dev)
                for name in libs}
        times = {name: [] for name in libs}

        def timed(name):
            def call():
                err = launch(libs[name][kind], outs[name])
                if err:
                    raise RuntimeError(f"{name} {kind}: CUDA error {err}")
            times[name].append(chip_smoke.cuda_ms(call, args.reps))
        for name in order:
            timed(name)
        for name in VARIANTS:
            if name != "kernel" and (kind == "tri" or name not in TRI_ONLY):
                timed(name)
        line = dict(kernel=kind, batch=x.shape[0], n=n, card=card,
                    **{f"{k}_ms": v for k, v in times.items() if v})
        if args.against:
            line["differing_bits_vs_other"] = chip_smoke.differing_bits(
                outs["kernel"], outs["other"])
        print(json.dumps(line), flush=True)
        del outs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

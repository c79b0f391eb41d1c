#!/usr/bin/env python
"""What the rotated-NMS kernels spend their time on, on one NVIDIA GPU.

    python tools/profile_torch_nms.py [--reps 20]

Builds csrc/quad_over.cu and csrc/nms_scan.cu as they are and with parts of
their work dropped, and times each build on chip_smoke.py's NMS candidates
(nms_quads, N 4096, nv N) at batch 4 and batch 1:
  - over-mask "stage0": each live pair runs only the test that decides
    whether its first clip stage keeps a vertex (the loop over the tile's
    columns and that test), no clip;
  - scan "no_or": the helper warps OR nothing into the removed bitmask;
    "no_chain": warp 0 keeps every live candidate of a block (no chain);
    "neither": both dropped, what is left is the per-block overhead.
The dropped builds give wrong results; only their times are kept.  Prints
one JSON line a kernel and batch with the card's name and power limit.  The
profiler of the machine gives no hardware counters, so the split of a
kernel's time is measured this way.
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

PAIR = ("    const float iou = pair_iou<V, TILE>(hx, hy, V, q, &s_ax[0][tid],\n"
        "                                        &s_ay[0][tid], &s_bx[0][tid],\n"
        "                                        &s_by[0][tid]);\n"
        "    if (iou > thr) word |= 1ull << t;\n")
STAGE0 = ("    bool in = false;\n"
          "#pragma unroll\n"
          "    for (int c = 0; c < V; ++c)\n"
          "      in |= side_of(q.ex[0], q.ey[0], q.cx[0], q.cy[0], hx[c],\n"
          "                    hy[c]) >= 0.f;\n"
          "    if (in) word |= 1ull << t;\n")
HELPERS = ("    } else if (k >= 1) {\n", "    } else if (false) {\n")
CHAIN = [("          if (alo & (1u << r)) alo &= ~d[r];\n", "          ;\n"),
         ("          if (ahi & (1u << r)) ahi &= ~d[r];\n", "          ;\n")]
VARIANTS = {
    "quad_over": {"kernel": [], "stage0": [(PAIR, STAGE0)]},
    "nms_scan": {"kernel": [], "no_or": [HELPERS], "no_chain": CHAIN,
                 "neither": [HELPERS] + CHAIN},
}
ENTRY = {"quad_over": "orp_quad_over_mask", "nms_scan": "orp_nms_scan"}


def build() -> dict:
    """Compile every variant into its own library; returns (source,
    variant) -> the launcher."""
    from orientedreppoints_tpu_torch.ops import _ext

    texts = {}
    for stem in VARIANTS:
        with open(osp.join(CSRC, f"{stem}.cu")) as f:
            texts[stem] = f.read()
    key = hashlib.sha256("".join(texts.values()).encode()).hexdigest()[:16]
    out = osp.join(ROOT, "build", "profile_torch_nms", key)
    os.makedirs(out, exist_ok=True)
    procs = {}
    for stem, variants in VARIANTS.items():
        for name, subs in variants.items():
            text = texts[stem]
            for old, new in subs:
                if text.count(old) != 1:
                    raise RuntimeError(f"{stem} {name}: the kernel source "
                                       "changed; update this tool's "
                                       "substitutions")
                text = text.replace(old, new)
            src = osp.join(out, f"{stem}_{name}.cu")
            with open(src, "w") as f:
                f.write(text)
            procs[stem, name] = subprocess.Popen(
                [_ext._nvcc(), *_ext.NVCC_FLAGS, "-I", CSRC, "-shared", "-o",
                 osp.join(out, f"{stem}_{name}.so"), src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (stem, name), p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {stem} {name}:\n{log}")
        fn = getattr(ctypes.CDLL(osp.join(out, f"{stem}_{name}.so")),
                     ENTRY[stem])
        fn.argtypes = _ext.SIGNATURES[ENTRY[stem]]
        fn.restype = ctypes.c_int
        libs[stem, name] = fn
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke
    from orientedreppoints_tpu_torch.ops import quad_iou

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ordinal = torch.cuda.current_device()
    rng = np.random.default_rng(chip_smoke.SEED)
    n, thr = chip_smoke.NQ, chip_smoke.NMS_THR
    for b in (4, 1):
        q = torch.tensor(chip_smoke.nms_quads(rng, b, n), dtype=torch.float32,
                         device=dev)
        nv = torch.full((b,), n, dtype=torch.int32, device=dev)
        words = quad_iou.quad_over_mask_plain(q, thr, nv)
        valid = torch.ones((b, n), dtype=torch.bool, device=dev)
        out = torch.empty_like(words)
        keep = torch.empty_like(valid)
        calls = {
            "quad_over": lambda fn: fn(q.data_ptr(), nv.data_ptr(),
                                       out.data_ptr(), b, n, thr, ordinal,
                                       stream),
            "nms_scan": lambda fn: fn(words.data_ptr(), valid.data_ptr(),
                                      nv.data_ptr(), keep.data_ptr(), b, n,
                                      ordinal, stream),
        }
        for stem, variants in VARIANTS.items():
            ms = {}
            for name in variants:
                def call(fn=libs[stem, name], stem=stem):
                    err = calls[stem](fn)
                    if err:
                        raise RuntimeError(f"CUDA error {err} at launch")
                ms[name] = chip_smoke.cuda_ms(call, args.reps)
            print(json.dumps(dict(kernel=stem, batch=b, n=n, card=card,
                                  **{f"{k}_ms": v for k, v in ms.items()})),
                  flush=True)
        del q, words, out, keep
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

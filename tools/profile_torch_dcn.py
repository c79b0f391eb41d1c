#!/usr/bin/env python
"""What bounds the paired-DCN forward kernel, on one NVIDIA GPU.

    python tools/profile_torch_dcn.py [--reps 20]

Builds csrc/deform_sample.cu as it is and twice more with one side of its
work dropped: "loads" keeps the gathers and the lerps and stores nothing
(a store stays behind a test of the lerped sums that random tables never
pass, so that nothing is optimised away); "stores" keeps the stores and
reads no table.  Times the three in bf16 (C 256, K 9, seeded random tables
and offsets of std 3 px) at chip_smoke.py's serving (1344^2, batch 4),
training (1344^2, batch 2) and 2016^2 TTA (batch 2) pyramids, with each
shape's byte bound, and prints one JSON line a shape with the card's name
and power limit.  The profiler of the machine gives no hardware counters,
so the split of the kernel's time is measured this way.
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

import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)

STORES = ("      Ch::store(out_a + at, va);\n"
          "      Ch::store(out_b + at, vb);\n")
LOADS = ("        ra[c] = Ch::load(table_a + at);\n"
         "        rb[c] = Ch::load(table_b + at);\n")
VARIANTS = {
    "kernel": [],
    "loads": [(STORES, "      float s = 0.f;\n"
                       "#pragma unroll\n"
                       "      for (int i = 0; i < E; ++i)\n"
                       "        s += va[i] + vb[i];\n"
                       "      if (s == 1234.5f) {\n" + STORES + "      }\n")],
    "stores": [(LOADS, "        ra[c] = typename Ch::Raw{};\n"
                       "        rb[c] = typename Ch::Raw{};\n"
                       "        (void)at;\n")],
}


def build(src_text: str) -> dict:
    """Compile each variant into its own library; returns name -> CDLL."""
    from orientedreppoints_tpu_torch.ops import _ext

    key = hashlib.sha256(src_text.encode()).hexdigest()[:16]
    out = osp.join(ROOT, "build", "profile_torch_dcn", key)
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src_text
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel source changed; "
                                   "update this tool's substitutions")
            text = text.replace(old, new)
        src = osp.join(out, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_ext._nvcc(), *_ext.NVCC_FLAGS, "-shared", "-o",
             osp.join(out, f"{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(osp.join(out, f"{name}.so"))
        fn = lib.orp_deform_sample_pair_bf16
        fn.argtypes = _ext.SIGNATURES["orp_deform_sample_pair_bf16"]
        libs[name] = fn
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke
    from orientedreppoints_tpu_torch.ops import deform_conv

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    src = osp.join(ROOT, "orientedreppoints_tpu_torch", "csrc",
                   "deform_sample.cu")
    with open(src) as f:
        libs = build(f.read())
    dev = torch.device("cuda")
    torch.manual_seed(chip_smoke.SEED)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, levels in (("serving", chip_smoke.LEVELS),
                          ("train", chip_smoke.TRAIN_LEVELS),
                          ("tta_2016", chip_smoke.TTA_LEVELS)):
        rows = sum(b * h * w for b, h, w in levels)
        ta = torch.randn(rows, 256, device=dev).to(torch.bfloat16)
        tb = torch.randn(rows, 256, device=dev).to(torch.bfloat16)
        offs = (torch.randn(rows, 18, device=dev) * 3).to(torch.bfloat16)
        out_a = torch.empty((rows, 9 * 256), dtype=torch.bfloat16, device=dev)
        out_b = torch.empty_like(out_a)
        lv = deform_conv._levels_arg(levels)
        ms = {}
        for name, fn in libs.items():
            def call(fn=fn):
                err = fn(ta.data_ptr(), tb.data_ptr(), offs.data_ptr(), lv,
                         out_a.data_ptr(), out_b.data_ptr(), rows, 256, 9,
                         len(levels), stream)
                if err:
                    raise RuntimeError(f"CUDA error {err} at launch")
            ms[name] = chip_smoke.cuda_ms(call, args.reps)
        nbytes, ops = chip_smoke.dcn_bytes_ops(rows, 256, 9, 2, False)
        print(json.dumps(dict(
            shape=shape, rows=rows, dtype="bfloat16", card=card,
            kernel_ms=ms["kernel"], loads_only_ms=ms["loads"],
            stores_only_ms=ms["stores"],
            store_bytes=2 * rows * 9 * 256 * 2,
            gather_bytes=rows * 9 * 4 * 2 * 256 * 2,
            **chip_smoke.bound(nbytes, ops))), flush=True)
        del ta, tb, offs, out_a, out_b
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

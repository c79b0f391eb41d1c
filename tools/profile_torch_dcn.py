#!/usr/bin/env python
"""What bounds the paired-DCN forward and backward kernels, on one NVIDIA
GPU.

    python tools/profile_torch_dcn.py [--reps 20] [--part all|forward|backward]
                                      [--csrc DIR] [--against DIR]

Forward: builds csrc/deform_sample.cu as it is and twice more with one side
of its work dropped: "loads" keeps the gathers and the lerps and stores
nothing (a store stays behind a test of the lerped sums that random tables
never pass, so that nothing is optimised away); "stores" keeps the stores
and reads no table.  Times the three in bf16 (C 256, K 9, seeded random
tables and offsets of std 3 px) at chip_smoke.py's serving (1344^2, batch
4), training (1344^2, batch 2) and 2016^2 TTA (batch 2) pyramids.

Backward: builds csrc/deform_sample_bwd.cu as it is and more ways:
"loads" issues no global atomic (each stays behind a test that never
passes); "atomics" reads no table row (neither the window's nor a far
corner's); "grads" does neither; "no_phase1" and "no_phase2" leave out the
offset grads' pass or the table grads' pass of each slice.  Times them
with bf16 tables at the training pyramid (the step's only launch), with
the wrapper's zero-fill of the f32 scratch and its rounding to bf16 timed
apart.  --csrc points at another checkout's csrc/ (for
instance the parent commit's, unpacked beside the repo): the tool knows
the layout of the kernel before its redesign too (one warp a sample,
scalar f32 atomics, bf16 grads) and takes whichever layout the source has.
Its launchers must take the device ordinal before the stream, as this
checkout's do; an older source is timed with its own checkout's tool.
--against DIR times DIR's sources and --csrc's in turns on one card, in
the order DIR, --csrc, --csrc, DIR (an A/B of two commits' kernels).

Prints one JSON line a shape and part with each time, the byte bound and
the card's name and power limit.  The profiler of the machine gives no
hardware counters, so the split of a kernel's time is measured this way.
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

# the forward's stores and loads, in the kernel templated on the table
# count and before it
STORES = ("      Ch::store(out_a + at, va);\n"
          "      if constexpr (NT == 2) Ch::store(out_b + at, vb);\n",
          "      Ch::store(out_a + at, va);\n"
          "      Ch::store(out_b + at, vb);\n")
LOADS = ("        ra[c] = Ch::load(table_a + at);\n"
         "        if constexpr (NT == 2) rb[c] = Ch::load(table_b + at);\n",
         "        ra[c] = Ch::load(table_a + at);\n"
         "        rb[c] = Ch::load(table_b + at);\n")


def fwd_variants(text: str) -> dict:
    """The forward's variants for whichever layout text has."""
    stores, loads = next((st, ld) for st, ld in zip(STORES, LOADS)
                         if text.count(st) == 1 and text.count(ld) == 1)
    return {
        "kernel": [],
        "loads": [(stores, "      float s = 0.f;\n"
                           "#pragma unroll\n"
                           "      for (int i = 0; i < E; ++i)\n"
                           "        s += va[i] + vb[i];\n"
                           "      if (s == 1234.5f) {\n" + stores
                   + "      }\n")],
        "stores": [(loads, "        ra[c] = typename Ch::Raw{};\n"
                           "        rb[c] = typename Ch::Raw{};\n"
                           "        (void)at;\n")],
    }

# csrc/deform_sample_bwd.cu as redesigned: tiles binned in shared memory,
# slices staged by cp.async, f32 grads (the scratch's row stride NT * C
# since the kernel is templated on the table count, 2 * C before)
def bwd_no_scatter(stride):
    window = (f"      red_v4(gcol + (size_t)row * {stride}, acc[0], acc[1], "
              "acc[2], acc[3]);\n")
    far = f"      red_v4(gcol + (size_t)row * {stride}, to_f32("
    return [(window, "      if (acc[0] == 1234.5f)\n" + window),
            (far, "      if (cw == 1234.5f)\n" + far)]


BWD_STAGE = ("      if (y >= 0 && y < h && x >= 0 && x < w)\n"
             "        cp_async16(reinterpret_cast<char*>(tdst")
BWD_FAR_LOAD = ("            Quad<T>::load(table + (size_t)(img_base + (yx.x + "
                "(c >> 1)) * w +\n")
BWD_NO_TABLES = [
    (BWD_STAGE, BWD_STAGE.replace("y < h", "y < -1")),
    (BWD_FAR_LOAD, "            for (int i = 0; i < 4; ++i) v[c][i] = 0.f;\n"
                   "            if (false)\n" + BWD_FAR_LOAD)]
BWD_PHASE1 = ("      const float2 wyx = s < NS ? pw[s] : make_float2(-1.f, "
              "0.f);\n")
BWD_PHASE2 = "    for (int i = grp; i < NW; i += GROUPS) {\n"
BWD_PHASE2_FAR = "    for (int i = grp; i < nfar; i += GROUPS) {\n"
# the same kernel before its redesign (one warp a sample, scalar loads and
# f32 atomics, bf16 grads)
OLD_SCATTER = "      if (ok[c] && cw[c] != 0.f) {\n"
OLD_TABLES = (
    "      va[c] = ok[c] ? to_f32(table_a[trow[c] * C + ch]) : 0.f;\n"
    "      vb[c] = ok[c] ? to_f32(table_b[trow[c] * C + ch]) : 0.f;\n")
OLD_NO_TABLES = "      va[c] = 0.f;\n      vb[c] = 0.f;\n"
OLD_NEVER = "      if (ok[c] && cw[c] == 1234.5f) {\n"
def tile_variants(stride):
    return {
        "kernel": [],
        "loads": bwd_no_scatter(stride),
        "atomics": BWD_NO_TABLES,
        "grads": bwd_no_scatter(stride) + BWD_NO_TABLES,
        # phase 1 (offset grads) or phase 2 (table grads) left out
        "no_phase1": [(BWD_PHASE1, BWD_PHASE1.replace(
            "s < NS ? pw[s] : ", ""))],
        "no_phase2": [(BWD_PHASE2, BWD_PHASE2.replace("= grp", "= NW + grp")),
                      (BWD_PHASE2_FAR,
                       BWD_PHASE2_FAR.replace("= grp", "= nfar + grp"))],
    }


BWD_LAYOUTS = {
    "tiles": (torch.float32, tile_variants("NT * C")),
    "tiles_pair": (torch.float32, tile_variants("2 * C")),
    "scalar_atomics": (torch.bfloat16, {
        "kernel": [],
        "loads": [(OLD_SCATTER, OLD_NEVER)],
        "atomics": [(OLD_TABLES, OLD_NO_TABLES)],
        "grads": [(OLD_SCATTER, OLD_NEVER), (OLD_TABLES, OLD_NO_TABLES)],
    }),
}


def build(csrc: str, src_text: str, variants: dict, symbol: str,
          tag: str) -> dict:
    """Compile each variant of src_text (a file of csrc, whose headers it
    includes) into its own library; returns name -> the loaded function
    symbol."""
    from orientedreppoints_tpu_torch.ops import _ext

    csrc = osp.abspath(csrc)
    key = hashlib.sha256((csrc + src_text).encode()).hexdigest()[:16]
    out = osp.join(ROOT, "build", "profile_torch_dcn", f"{tag}_{key}")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        if osp.exists(osp.join(out, f"{name}.so")):  # an earlier turn's
            continue
        text = src_text
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{tag} {name}: the kernel source "
                                   "changed; update this tool's "
                                   "substitutions")
            text = text.replace(old, new)
        src = osp.join(out, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_ext._nvcc(), *_ext.NVCC_FLAGS, "-I", csrc, "-shared", "-o",
             osp.join(out, f"{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {name}:\n{log}")
    libs = {}
    for name in variants:
        fn = getattr(ctypes.CDLL(osp.join(out, f"{name}.so")), symbol)
        fn.argtypes = _ext.SIGNATURES[symbol]
        libs[name] = fn
    return libs


def bwd_layout(text: str):
    """The backward layout whose substitutions all match text once."""
    for name, (gdt, variants) in BWD_LAYOUTS.items():
        if all(text.count(old) == 1 for subs in variants.values()
               for old, _ in subs):
            return name, gdt, variants
    raise RuntimeError("deform_sample_bwd.cu matches no known layout; "
                       "update this tool's substitutions")


def checked(fn):
    def call(*args):
        err = fn(*args)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")
    return call


def profile_forward(csrc, card, reps):
    import chip_smoke
    from orientedreppoints_tpu_torch.ops import deform_conv

    with open(osp.join(csrc, "deform_sample.cu")) as f:
        text = f.read()
    libs = build(csrc, text, fwd_variants(text),
                 "orp_deform_sample_pair_bf16", "fwd")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ordinal = torch.cuda.current_device()
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
            args = (ta.data_ptr(), tb.data_ptr(), offs.data_ptr(), lv,
                    out_a.data_ptr(), out_b.data_ptr(), rows, 256, 9,
                    len(levels), ordinal, stream)
            ms[name] = chip_smoke.cuda_ms(lambda f=checked(fn): f(*args),
                                          reps)
        nbytes, ops = chip_smoke.dcn_bytes_ops(rows, 256, 9, 2, False)
        print(json.dumps(dict(
            part="forward", csrc=csrc, shape=shape, rows=rows,
            dtype="bfloat16",
            card=card, kernel_ms=ms["kernel"], loads_only_ms=ms["loads"],
            stores_only_ms=ms["stores"],
            store_bytes=2 * rows * 9 * 256 * 2,
            gather_bytes=rows * 9 * 4 * 2 * 256 * 2,
            **chip_smoke.bound(nbytes, ops))), flush=True)
        del ta, tb, offs, out_a, out_b
        torch.cuda.empty_cache()


def profile_backward(csrc, card, reps):
    import chip_smoke
    from orientedreppoints_tpu_torch.ops import deform_conv

    with open(osp.join(csrc, "deform_sample_bwd.cu")) as f:
        text = f.read()
    layout, gdt, variants = bwd_layout(text)
    libs = build(csrc, text, variants, "orp_deform_sample_pair_bwd_bf16",
                 layout)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ordinal = torch.cuda.current_device()
    levels = chip_smoke.TRAIN_LEVELS
    rows, c, k = sum(b * h * w for b, h, w in levels), 256, 9
    ta, tb = (torch.randn(rows, c, device=dev).to(torch.bfloat16)
              for _ in range(2))
    offs = (torch.randn(rows, 2 * k, device=dev) * 3).to(torch.bfloat16)
    ga, gb = (torch.randn(rows, k * c, device=dev).to(gdt) for _ in range(2))
    gtab = torch.zeros((rows, 2 * c), dtype=torch.float32, device=dev)
    goff = torch.empty((rows, 2 * k), dtype=torch.bfloat16, device=dev)
    lv = deform_conv._levels_arg(levels)
    args = (ta.data_ptr(), tb.data_ptr(), offs.data_ptr(), ga.data_ptr(),
            gb.data_ptr(), lv, gtab.data_ptr(), goff.data_ptr(), rows, c, k,
            len(levels), ordinal, stream)
    ms = {name: chip_smoke.cuda_ms(lambda f=checked(fn): f(*args), reps)
          for name, fn in libs.items()}
    zero_ms = chip_smoke.cuda_ms(lambda: torch.zeros_like(gtab), reps)
    round_ms = chip_smoke.cuda_ms(lambda: gtab.to(torch.bfloat16), reps)
    elem = 4 if gdt == torch.float32 else 2
    nbytes, ops = chip_smoke.dcn_bytes_ops(rows, c, k, 2, True, grad_elem=elem)
    print(json.dumps(dict(
        part="backward", csrc=csrc, layout=layout, shape="train", rows=rows,
        dtype="bfloat16", grad_dtype=str(gdt).split(".")[-1], card=card,
        kernel_ms=ms["kernel"], loads_only_ms=ms["loads"],
        atomics_only_ms=ms["atomics"], grads_only_ms=ms["grads"],
        **{f"{name}_ms": t for name, t in ms.items()
           if name.startswith("no_")},
        zero_fill_ms=zero_ms, round_ms=round_ms,
        grad_bytes=2 * rows * k * c * elem,
        gather_bytes=rows * k * 4 * 2 * c * 2,
        scatter_values=rows * k * 4 * 2 * c,
        **chip_smoke.bound(nbytes, ops))), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--part", choices=("all", "forward", "backward"),
                    default="all")
    ap.add_argument("--csrc", default=osp.join(
        ROOT, "orientedreppoints_tpu_torch", "csrc"))
    ap.add_argument("--against", help="another csrc/: timed in turns with "
                    "--csrc's, A B B A")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    turns = ([args.against, args.csrc, args.csrc, args.against]
             if args.against else [args.csrc])
    for csrc in turns:
        torch.manual_seed(chip_smoke.SEED)
        if args.part in ("all", "forward"):
            profile_forward(csrc, card, args.reps)
        if args.part in ("all", "backward"):
            profile_backward(csrc, card, args.reps)


if __name__ == "__main__":
    main()

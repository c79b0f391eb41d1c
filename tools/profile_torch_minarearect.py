#!/usr/bin/env python
"""Time the min-area-rect kernel at the port's call shapes, on one NVIDIA
GPU.

    python tools/profile_torch_minarearect.py [--reps 200] [--against DIR]

Builds csrc/minarearect.cu into a library of its own and times the raw
launch, its outputs allocated once and the card kept busy ahead of the
timed launches (so that the time is the device's, not the host's launch
rate), on chip_smoke.point_sets at the serving decode's 25,304 sets and
the training step's 2,048 (APAA's init and refine rects) and 75,212
(convex_iou's hulls).  --against DIR builds the same file of another
checkout's csrc/ (for instance the parent commit's, unpacked beside the
repo): the two run in turns (other, this, this, other) on the same inputs,
and their hulls and counts are compared bit for bit, their rects within
chip_smoke.RECT_TOL up to ties (its launcher must take the device ordinal
before the stream, as this checkout's does).  Prints one JSON line a
shape with the card's name and power limit.
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
SHAPES = (("serving", 25304), ("train_apaa", 2048),
          ("train_convex_iou", 75212))


def build(csrc: str, tag: str):
    """nvcc csrc/minarearect.cu into its own library; the launcher."""
    from orientedreppoints_tpu_torch.ops import _ext

    src = osp.join(csrc, "minarearect.cu")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    out = osp.join(ROOT, "build", "profile_torch_minarearect", f"{tag}_{key}")
    os.makedirs(out, exist_ok=True)
    lib = osp.join(out, "minarearect.so")
    res = subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, "-shared", "-o",
                          lib, src], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{res.stdout}"
                           f"{res.stderr}")
    fn = ctypes.CDLL(lib).orp_min_area_rect
    fn.argtypes = _ext.SIGNATURES["orp_min_area_rect"]
    return fn


def run(fn, pts):
    n = pts.shape[0]
    outs = (torch.empty((n, 8), device=pts.device),
            torch.empty((n, 9, 2), device=pts.device),
            torch.empty((n,), dtype=torch.int32, device=pts.device))
    stream = torch.cuda.current_stream().cuda_stream
    ordinal = torch.cuda.current_device()
    args = (pts.data_ptr(), *(o.data_ptr() for o in outs), n, ordinal, stream)

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")
    return outs, call


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    fns = {"this": build(osp.join(ROOT, "orientedreppoints_tpu_torch",
                                  "csrc"), "this")}
    order = ["this"]
    if args.against:
        fns["other"] = build(args.against, "other")
        order = ["other", "this", "this", "other"]
    rng = np.random.default_rng(chip_smoke.SEED)
    for shape, n in SHAPES:
        pts = torch.tensor(chip_smoke.point_sets(rng, n), dtype=torch.float32,
                           device="cuda")
        runs = {name: run(fn, pts) for name, fn in fns.items()}
        times = {name: [] for name in fns}
        for name in order:
            times[name].append(chip_smoke.cuda_ms(runs[name][1], args.reps))
        line = dict(shape=shape, sets=n, card=card,
                    **{f"{name}_ms": t for name, t in times.items()},
                    **chip_smoke.bound(n * (72 + 108),
                                       chip_smoke.min_area_rect_ops(
                                           runs["this"][0][2])))
        if "other" in runs:
            (r1, h1, c1), (r0, h0, c0) = runs["this"][0], runs["other"][0]
            err, ties, ok = chip_smoke.rect_check(r1, r0, pts)
            line.update(hull_count_identical=bool(
                torch.equal(h1, h0) and torch.equal(c1, c0)),
                rect_max_abs_err=err, rect_ties=ties, rect_ok=ok)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Time the hard-aug warps' two lerp forms on the host.

    python tools/time_torch_warp.py [--reps 20]

data.warp forms the two lerps along x of its bilinear remap in float64,
which holds them exactly, and the fused multiply-add it emulates (fma32)
only where some source coordinate lies in (0, 2^-20).  The two give the
same bits.  This script times the two warps of a hard-aug sample, each
with the float64 lerp and with fma32 alone, in turns (float64, fma32,
fma32, float64) on the same seeded inputs: PolyMosaic's crop of a 1024^2
mosaic onto 512^2 (synth_r50_512_hard_aug.py's scale and translate) and
PolyRandomRotate's rotation of a 512^2 tile.  It checks the two outputs
are equal and prints one JSON line a warp with the milliseconds a call,
the host's CPU and torch's thread count.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import time

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)


def cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    from orientedreppoints_tpu_torch.data import pipelines, warp

    rng = np.random.RandomState(0)
    mosaic = pipelines.PolyMosaic(degrees=0, translate=0.1, scale=0.25,
                                  shear=0, perspective=0.0)
    canvas = rng.randint(0, 256, (1024, 1024, 3)).astype(np.uint8)
    tile = rng.randint(0, 256, (512, 512, 3)).astype(np.uint8)
    no_gts = np.zeros((0, 8), np.float32), np.zeros((0,), np.int64)
    angle = rng.uniform(-180, 180)
    rot = warp.get_rotation_matrix_2d((255.5, 255.5), angle, 1.0)
    cases = {
        "mosaic_crop_1024_to_512": lambda: mosaic.random_perspective(
            canvas, *no_gts, 512, np.random.RandomState(1))[0],
        "rotate_512": lambda: warp.warp_affine(tile, rot, (512, 512)),
    }
    exact = warp._lerp_fits_float64
    for name, call in cases.items():
        times = {"float64": [], "fma32": []}
        outs = {}
        for form in ("float64", "fma32", "fma32", "float64"):
            warp._lerp_fits_float64 = (exact if form == "float64"
                                       else lambda sx: False)
            outs[form] = call()
            t0 = time.perf_counter()
            for _ in range(args.reps):
                call()
            times[form].append((time.perf_counter() - t0) / args.reps * 1e3)
        warp._lerp_fits_float64 = exact
        print(json.dumps(dict(
            warp=name, reps=args.reps, cpu=cpu_name(),
            cpu_count=os.cpu_count(), torch_threads=torch.get_num_threads(),
            float64_ms=times["float64"], fma32_ms=times["fma32"],
            equal=bool(np.array_equal(outs["float64"], outs["fma32"])))),
            flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Read the min-area-rect kernel's ties against its plain version, on one
NVIDIA GPU.

    python tools/rect_ties_torch.py [--sets 1000000] [--batches 8] [--out FILE]

Two kinds of point sets go through the kernel (ops.minarearect) and the
training step's plain version (ops.geometry.min_area_rect): chip_smoke's
point_sets (a 1344^2 canvas, 24 px spread) and sub-pixel sets like an
untrained head's reppoints (centres over a 512^2 image, a spread drawn
log-uniform in [0.05, 2] px).  For every box whose corners differ by more
than chip_smoke.RECT_TOL it reads the relative gap between the areas of
the two float32 rects' corners (a rule on them would allow 2 TIE_RTOL), and
for each rect chip_smoke.tie_check's readings (the corner distance to
the nearest float64 box of its set over the tolerance, and the share of
the tie band that the boxes within it use), and the angles from the
rect's side to the nearest and the second-nearest direction between two
of the set's points.  Prints one JSON line a kind with the card's name and
power limit, and writes every differing box to --out as JSON lines.
"""

from __future__ import annotations

import argparse
import json
import math
import os.path as osp
import subprocess
import sys

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)


def sub_pixel_sets(rng, n):
    """n 9-point sets: centres over a 512^2 image, spread 0.05-2 px."""
    c = rng.uniform(0, 512, (n, 1, 2))
    s = np.exp(rng.uniform(math.log(0.05), math.log(2.0), (n, 1, 1)))
    return (c + s * rng.normal(0, 1, (n, 9, 2))).reshape(n, 18)


def side_gaps(points, rects):
    """Angles (rad) from each rect's longer side to the nearest and the
    second-nearest direction between two of its set's points, mod 90 deg."""
    p = points.view(points.shape[0], -1, 2).double()
    i, j = torch.triu_indices(p.shape[1], p.shape[1], 1, device=p.device)
    d = p[:, j] - p[:, i]
    r = rects.view(-1, 4, 2).double()
    sides = torch.stack([r[:, 1] - r[:, 0], r[:, 2] - r[:, 1]], 1)
    side = sides[torch.arange(r.shape[0], device=r.device),
                 sides.norm(dim=-1).argmax(1)]
    gap = torch.remainder(torch.atan2(d[..., 1], d[..., 0])
                          - torch.atan2(side[:, 1], side[:, 0])[:, None],
                          math.pi / 2)
    gap = torch.minimum(gap, math.pi / 2 - gap).sort(1).values
    return gap[:, 0], gap[:, 1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sets", type=int, default=1_000_000)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import chip_smoke as cs
    from orientedreppoints_tpu_torch.ops import geometry, minarearect

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = open(args.out, "w") if args.out else None
    for kind, make in (("point_sets", cs.point_sets),
                       ("sub_pixel", sub_pixel_sets)):
        rng = np.random.default_rng(cs.SEED)
        line = dict(kind=kind, sets=0, off=0, corner_rule_fails=0,
                    tie_check_fails=0, rect_check_ok=True,
                    max_corner_gap_rel=0.0, median_area_px2=[])
        for _ in range(args.batches):
            p = torch.tensor(make(rng, args.sets), dtype=torch.float32,
                             device="cuda")
            got = minarearect.min_area_rect(p)
            want = geometry.min_area_rect(p)
            line["sets"] += args.sets
            line["median_area_px2"].append(float(cs.rect_area(want).median()))
            line["rect_check_ok"] &= cs.rect_check(got, want, p)[2]
            off = cs.rect_err(got, want) > cs.RECT_TOL
            if not bool(off.any()):
                continue
            pts, g, w = p[off], got[off], want[off]
            ag, aw = cs.rect_area(g), cs.rect_area(w)
            corner_gap = (ag - aw).abs() / aw.clamp(min=1e-30)
            reading = {}
            for name, r in (("got", g), ("want", w)):
                over, band, ok = cs.tie_check(pts, r)
                near, second = side_gaps(pts, r)
                reading[name] = dict(corner_err_over_tol=over,
                                     tie_band_use=band,
                                     ok=ok, nearest_rad=near,
                                     second_rad=second)
            ok = reading["got"]["ok"] & reading["want"]["ok"]
            line["off"] += int(off.sum())
            line["corner_rule_fails"] += int(
                (corner_gap > 2 * geometry.TIE_RTOL).sum())
            line["tie_check_fails"] += int((~ok).sum())
            line["max_corner_gap_rel"] = max(line["max_corner_gap_rel"],
                                             float(corner_gap.max()))
            for key in ("corner_err_over_tol", "tie_band_use",
                        "nearest_rad"):
                line[f"max_{key}"] = max(
                    line.get(f"max_{key}", 0.0),
                    *(float(reading[n][key].max()) for n in reading))
            line["min_second_rad"] = min(
                line.get("min_second_rad", math.inf),
                *(float(reading[n]["second_rad"].min()) for n in reading))
            if out:
                for k in range(pts.shape[0]):
                    out.write(json.dumps(dict(
                        kind=kind, points=pts[k].tolist(), got=g[k].tolist(),
                        want=w[k].tolist(), got_corner_area=float(ag[k]),
                        want_corner_area=float(aw[k]),
                        corner_gap_rel=float(corner_gap[k]),
                        **{f"{n}_{key}": float(reading[n][key][k])
                           for n in reading for key in
                           ("corner_err_over_tol", "tie_band_use",
                            "nearest_rad", "second_rad")})) + "\n")
        line["median_area_px2"] = float(np.median(line["median_area_px2"]))
        print(json.dumps(dict(card=card, **line)), flush=True)
    if out:
        out.close()


if __name__ == "__main__":
    main()

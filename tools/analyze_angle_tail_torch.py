#!/usr/bin/env python
"""Attribute a class's mAOE tail: detector error vs evaluator convention
(counterpart of tools/analyze_angle_tail.py, on the port's devkit).

The mAOE evaluator scores angles in the devkit's square-aware v3
convention (core/rbox.py poly2rbox_v3, parity-tested vs the reference's
mAOE_evaluation.py): boxes with edge ratio < 1.15 take the candidate
angle nearer 0, longer boxes take the longest-edge angle.  For classes
whose aspect-ratio range STRADDLES 1.15 (e.g. the hard-synthetic plane
spec, ratio 1.0-1.4), a prediction whose ratio lands on the other side
of the threshold than its gt is scored under a different convention and
can contribute a near-90-degree error even when the predicted rectangle
is visually correct.

For every matched detection (same IoU>ovthresh matching as eval_maoe)
this tool reports, per gt-ratio bucket:
  * the scored v3 error,
  * the mod-90 error (angle distance up to rectangle symmetry — what an
    orientation-agnostic convention would score),
  * how many pairs straddle the 1.15 threshold.
If the scored error collapses under mod-90 and concentrates in straddling
pairs, the tail is the evaluator convention at the ratio boundary, not a
localization regression.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np

from orientedreppoints_tpu_torch.core.rbox import poly2rbox_v3
from orientedreppoints_tpu_torch.devkit.evaluation import (
    _hbb_iou_prefilter, _load_dets, _load_gt,
)
from orientedreppoints_tpu_torch.devkit.polygon import poly_iou


def edge_ratio(poly8):
    p = np.asarray(poly8, np.float64).reshape(4, 2)
    e1 = np.linalg.norm(p[0] - p[1])
    e2 = np.linalg.norm(p[1] - p[2])
    return max(e1, e2) / max(min(e1, e2), 1e-12)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--det", required=True,
                    help="Task1 det path pattern, e.g. merged/Task1_{:s}.txt")
    ap.add_argument("--anno", required=True,
                    help="labelTxt pattern, e.g. val_raw/labelTxt/{:s}.txt")
    ap.add_argument("--images_dir", required=True,
                    help="dir of val images (stem list)")
    ap.add_argument("--classname", default="plane")
    ap.add_argument("--ovthresh", type=float, default=0.7)
    args = ap.parse_args(argv)

    names = sorted(osp.splitext(f)[0] for f in os.listdir(args.images_dir))
    class_recs, _ = _load_gt(args.anno, names, args.classname)
    image_ids, confidence, BB = _load_dets(args.det.format(args.classname))
    order = np.argsort(-confidence)
    BB = BB[order]
    image_ids = [image_ids[i] for i in order]

    rows = []
    for d in range(len(image_ids)):
        R = class_recs.get(image_ids[d])
        if R is None or R["bbox"].size == 0:
            continue
        bb = BB[d]
        cand = np.where(_hbb_iou_prefilter(R["bbox"], bb) > 0)[0]
        if len(cand) == 0:
            continue
        overlaps = np.array([poly_iou(R["bbox"][j], bb) for j in cand])
        k = int(np.argmax(overlaps))
        if overlaps[k] <= args.ovthresh:
            continue
        gt = R["bbox"][cand[k]]
        th_d = poly2rbox_v3(bb[None])[0, 4]
        th_g = poly2rbox_v3(gt[None])[0, 4]
        err = abs(th_d - th_g) * 57.32  # the evaluator's scored error
        m = (err % 90.0)
        err_mod90 = min(m, 90.0 - m)
        # mod180 separates the two >45deg failure shapes: a near-180 scored
        # error with SMALL mod180 is a branch WRAP (det/gt at opposite ends
        # of the evaluator's [-45,135) angle range, orientation actually
        # correct — the reference applies no wrap, quirk mirrored in
        # eval_maoe); mod180 ~ 90 is a genuine TRANSPOSITION (long axis
        # perpendicular to gt)
        m180 = err % 180.0
        err_mod180 = min(m180, 180.0 - m180)
        rg, rd = edge_ratio(gt), edge_ratio(bb)
        rows.append(dict(err=err, err_mod90=err_mod90, err_mod180=err_mod180,
                         gt_ratio=rg, det_ratio=rd,
                         wrap=bool(err > 45.0 and err_mod180 < 20.0),
                         # only meaningful for clearly-elongated gts: a
                         # mod180~90 flip on a near-square gt is the
                         # documented longest-edge convention, not a
                         # detector transposition
                         transposed=bool(err_mod180 >= 45.0 and rg >= 1.25),
                         straddle=(rg < 1.15) != (rd < 1.15)))

    buckets = [(1.0, 1.15), (1.15, 1.25), (1.25, 10.0)]
    out = {"classname": args.classname, "n_matched": len(rows),
           "scored_mAOE": round(float(np.mean([r["err"] for r in rows])), 2)
           if rows else None,
           "mod90_mAOE": round(float(np.mean(
               [r["err_mod90"] for r in rows])), 2) if rows else None,
           "n_wrap": int(sum(bool(r["wrap"]) for r in rows)),
           "n_transposed": int(sum(bool(r["transposed"]) for r in rows)),
           "scored_mAOE_excl_wrap": round(float(np.mean(
               [r["err"] for r in rows if not r["wrap"]])), 2)
           if any(not r["wrap"] for r in rows) else None,
           "buckets": []}
    for lo, hi in buckets:
        sel = [r for r in rows if lo <= r["gt_ratio"] < hi]
        if not sel:
            continue
        out["buckets"].append({
            "gt_ratio": f"[{lo},{hi})",
            "n": len(sel),
            "scored": round(float(np.mean([r["err"] for r in sel])), 2),
            "mod90": round(float(np.mean([r["err_mod90"] for r in sel])), 2),
            "straddle_frac": round(float(np.mean(
                [r["straddle"] for r in sel])), 3),
            "scored_when_straddle": round(float(np.mean(
                [r["err"] for r in sel if r["straddle"]])), 2)
            if any(r["straddle"] for r in sel) else None,
        })
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())

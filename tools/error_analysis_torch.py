#!/usr/bin/env python
"""Per-class detection error analysis over DOTA Task1 results
(counterpart of tools/error_analysis.py, on the port's devkit).

Oriented-task analogue of the reference's tools/coco_error_analysis.py
(COCO progressive-PR breakdown): for each class, AP is recomputed under
progressively forgiving settings so the stacked differences attribute the
error mass:

  C75  AP at polygon IoU 0.75
  C50  AP at polygon IoU 0.50
  Loc  AP at IoU 0.10            (localization errors forgiven)
  Cls  AP at 0.10, detections matching a gt of ANOTHER class removed
       (class confusion forgiven; COCO's Sim+Oth collapsed — DOTA has no
       category hierarchy)
  BG   Cls with all remaining unmatched detections removed
       (background false positives forgiven)
  FN   1.0                        (remaining gap = missed ground truth)

Outputs one JSON (per class and mean) and, with --plot, a stacked PR
curve PNG per class.

Usage:
  python3 tools/error_analysis_torch.py \
      --det work/task1_merged/Task1_{:s}.txt \
      --anno data/val/labelTxt/{:s}.txt --images work/val_names.txt \
      --out work/error_analysis.json [--plot work/plots/]
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np

from orientedreppoints_tpu_torch.devkit import dota_utils as util
from orientedreppoints_tpu_torch.devkit.evaluation import (
    _hbb_iou_prefilter, _imagenames, _load_dets, _load_gt, voc_ap,
)
from orientedreppoints_tpu_torch.devkit.polygon import poly_iou


def _pr(detections, class_recs, npos, ovthresh, use_07_metric):
    """PR + AP over pre-matched detections: detections is a list of
    (image_id, best_iou, gt_index) sorted by confidence."""
    nd = len(detections)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    det_flags = {k: [False] * len(v["bbox"]) for k, v in class_recs.items()}
    for d, (img, ovmax, jmax) in enumerate(detections):
        R = class_recs.get(img)
        if R is None or ovmax <= ovthresh or jmax < 0:
            fp[d] = 1.0
            continue
        if R["difficult"][jmax]:
            continue
        if det_flags[img][jmax]:
            fp[d] = 1.0
        else:
            det_flags[img][jmax] = True
            tp[d] = 1.0
    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def _match_all(image_ids, BB, class_recs):
    """Best-gt polygon IoU per detection against one class's records."""
    out = []
    for d in range(len(image_ids)):
        R = class_recs.get(image_ids[d])
        ovmax, jmax = -np.inf, -1
        if R is not None and R["bbox"].size > 0:
            hbb = _hbb_iou_prefilter(R["bbox"], BB[d])
            cand = np.where(hbb > 0)[0]
            if len(cand):
                ious = np.array(
                    [poly_iou(R["bbox"][j], BB[d]) for j in cand])
                k = int(np.argmax(ious))
                ovmax, jmax = float(ious[k]), int(cand[k])
        out.append((image_ids[d], ovmax, jmax))
    return out


def analyze_class(detpath, annopath, imagenames, classname, classnames,
                  use_07_metric=False):
    class_recs, npos = _load_gt(annopath, imagenames, classname)
    image_ids, confidence, BB = _load_dets(detpath.format(classname))
    if len(image_ids) == 0:
        return None
    order = np.argsort(-confidence)
    BB = BB[order]
    image_ids = [image_ids[i] for i in order]
    matches = _match_all(image_ids, BB, class_recs)

    res = {}
    for name, thr in (("C75", 0.75), ("C50", 0.5), ("Loc", 0.1)):
        res[name] = _pr(matches, class_recs, npos, thr, use_07_metric)[2]

    # Cls: drop detections that (still unmatched at 0.1) match another
    # class's gt at IoU > 0.1 — those are class-confusion errors
    other_recs = {
        c: _load_gt(annopath, imagenames, c)[0]
        for c in classnames if c != classname
    }
    keep = []
    for d, (img, ovmax, jmax) in enumerate(matches):
        if ovmax > 0.1:
            keep.append(d)
            continue
        confused = False
        for recs in other_recs.values():
            R = recs.get(img)
            if R is None or R["bbox"].size == 0:
                continue
            hbb = _hbb_iou_prefilter(R["bbox"], BB[d])
            cand = np.where(hbb > 0)[0]
            if len(cand) and max(
                    poly_iou(R["bbox"][j], BB[d]) for j in cand) > 0.1:
                confused = True
                break
        if not confused:
            keep.append(d)
    cls_matches = [matches[d] for d in keep]
    res["Cls"] = _pr(cls_matches, class_recs, npos, 0.1, use_07_metric)[2]

    # BG: additionally drop every remaining unmatched detection
    bg_matches = [m for m in cls_matches if m[1] > 0.1]
    res["BG"] = _pr(bg_matches, class_recs, npos, 0.1, use_07_metric)[2]
    res["FN"] = 1.0
    res["npos"] = npos
    res["ndet"] = len(matches)
    return res


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--det", required=True,
                   help="detpath format string, e.g. dir/Task1_{:s}.txt")
    p.add_argument("--anno", required=True,
                   help="annopath format string, e.g. dir/{:s}.txt")
    p.add_argument("--images", required=True,
                   help="imageset file or comma-separated names")
    p.add_argument("--classes", default=None,
                   help="comma-separated; default DOTA-1.0 15 classes")
    p.add_argument("--out", default="error_analysis.json")
    p.add_argument("--plot", default=None, help="directory for PR PNGs")
    p.add_argument("--voc07", action="store_true")
    args = p.parse_args(argv)

    if osp.exists(args.images):
        imagenames = _imagenames(args.images)
    else:
        imagenames = args.images.split(",")
    classnames = (args.classes.split(",") if args.classes
                  else list(util.DOTA10_CLASSES))

    results = {}
    for c in classnames:
        r = analyze_class(args.det, args.anno, imagenames, c, classnames,
                          use_07_metric=args.voc07)
        if r is not None:
            results[c] = r
            print(f"{c}: " + " ".join(
                f"{k}={v:.3f}" for k, v in r.items()
                if k in ("C75", "C50", "Loc", "Cls", "BG")))

    keys = ("C75", "C50", "Loc", "Cls", "BG")
    mean = {k: float(np.mean([r[k] for r in results.values()]))
            for k in keys} if results else {}
    out = {"per_class": results, "mean": mean}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print("mean:", json.dumps(mean))

    if args.plot and results:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(args.plot, exist_ok=True)
        for c, r in results.items():
            fig, ax = plt.subplots(figsize=(5, 4))
            vals = [r[k] for k in keys] + [1.0]
            labels = list(keys) + ["FN"]
            prev = 0.0
            for v, lb in zip(vals, labels):
                ax.bar(lb, v - prev, bottom=prev)
                prev = v
            ax.set_ylim(0, 1)
            ax.set_title(f"{c} error breakdown")
            ax.set_ylabel("AP")
            fig.tight_layout()
            fig.savefig(osp.join(args.plot, f"{c}.png"), dpi=120)
            plt.close(fig)
        print("plots ->", args.plot)
    return 0


if __name__ == "__main__":
    sys.exit(main())

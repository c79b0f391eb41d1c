"""Offline evaluators on DOTA files: Task1 oriented mAP, Task2
horizontal mAP, mAOE and UCAS-AOD (counterpart of devkit/evaluation.py).

  * Task1 (DOTA_devkit/dota_evaluation_task1.py): VOC AP per class at IoU
    0.5 with the exact polygon IoU (devkit/native.py's host library)
    behind an axis-aligned prefilter,
    difficult gts ('1' or '2') out of npos and neither TP nor FP, greedy
    matching in confidence order;
  * Task2 (dota_evaluation_task2.py): the same with the axis-aligned IoU;
  * mAOE (mAOE_evaluation.py:48-171): for every detection whose best gt
    IoU exceeds the threshold, |theta_det - theta_gt| * 57.32 degrees in
    the square-aware v3 angle convention, averaged per class, then over
    classes;
  * HRSC2016 (hrsc2016_evaluation.py:87-269): the Task1 VOC AP of the one
    class "ship", with the VOC-07 11-point metric by default.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from ..core.rbox import poly2rbox_v3
from . import dota_utils as util
from .native import poly_iou_pairs


def voc_ap(rec, prec, use_07_metric=False):
    """PASCAL VOC AP: 11-point when use_07_metric, else the area under the
    interpolated precision-recall curve."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _load_gt(annopath: str, imagenames, classname: str):
    class_recs = {}
    npos = 0
    for name in imagenames:
        objs = [
            o for o in util.parse_dota_poly(annopath.format(name))
            if o["name"] == classname
        ]
        bbox = np.array([o["poly"] for o in objs]).reshape(-1, 8)
        difficult = np.array(
            [o["difficult"] == "1" or o["difficult"] == "2" for o in objs],
            dtype=bool,
        )
        npos += int((~difficult).sum())
        class_recs[name] = dict(
            bbox=bbox, difficult=difficult, det=[False] * len(objs)
        )
    return class_recs, npos


def _load_dets(detfile: str):
    image_ids, confidences, polys = [], [], []
    if osp.exists(detfile):
        with open(detfile) as f:
            for line in f:
                parts = line.strip().split(" ")
                if len(parts) < 10:
                    continue
                image_ids.append(parts[0])
                confidences.append(float(parts[1]))
                polys.append([float(v) for v in parts[2:10]])
    return (
        image_ids,
        np.asarray(confidences, np.float64),
        np.asarray(polys, np.float64).reshape(-1, 8),
    )


def _hbb_iou_prefilter(gt_polys, det_poly):
    """Axis-aligned IoU of one det with each gt, with the reference's +1
    pixel convention: the gate before the exact polygon IoU."""
    gx1 = gt_polys[:, 0::2].min(1)
    gy1 = gt_polys[:, 1::2].min(1)
    gx2 = gt_polys[:, 0::2].max(1)
    gy2 = gt_polys[:, 1::2].max(1)
    bx1, by1 = det_poly[0::2].min(), det_poly[1::2].min()
    bx2, by2 = det_poly[0::2].max(), det_poly[1::2].max()
    iw = np.maximum(np.minimum(gx2, bx2) - np.maximum(gx1, bx1) + 1.0, 0.0)
    ih = np.maximum(np.minimum(gy2, by2) - np.maximum(gy1, by1) + 1.0, 0.0)
    inters = iw * ih
    uni = (
        (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
        + (gx2 - gx1 + 1.0) * (gy2 - gy1 + 1.0)
        - inters
    )
    return inters / uni


def voc_eval_poly(detpath: str, annopath: str, imagenames, classname: str,
                  ovthresh: float = 0.5, use_07_metric: bool = False,
                  hbb: bool = False):
    """Per-class oriented VOC evaluation -> (rec, prec, ap); with hbb the
    overlap is the axis-aligned IoU of the polygons' boxes (+1 pixel
    convention) with every gt, the DOTA Task2 evaluator's.

    detpath: format string with {:s} for the class name; annopath: format
    string with {:s} for the image name.
    """
    class_recs, npos = _load_gt(annopath, imagenames, classname)
    image_ids, confidence, BB = _load_dets(detpath.format(classname))
    nd = len(image_ids)
    if nd == 0:
        return np.zeros(0), np.zeros(0), 0.0
    # np.argsort's default sort is not stable: equal scores keep whatever
    # order it gives, the same as the reference's on the same array
    order = np.argsort(-confidence)
    BB = BB[order]
    image_ids = [image_ids[i] for i in order]

    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        R = class_recs.get(image_ids[d])
        if R is None:
            fp[d] = 1.0
            continue
        bb = BB[d]
        ovmax, jmax = -np.inf, -1
        gts = R["bbox"]
        if gts.size > 0:
            hbb_ovr = _hbb_iou_prefilter(gts, bb)
            if hbb:
                overlaps = hbb_ovr
                cand = np.arange(len(gts))
            else:
                cand = np.where(hbb_ovr > 0)[0]
                overlaps = poly_iou_pairs(gts[cand], bb)
            if len(cand) > 0 and overlaps.size > 0:
                k = int(np.argmax(overlaps))
                ovmax = overlaps[k]
                jmax = int(cand[k])
        if ovmax > ovthresh:
            if not R["difficult"][jmax]:
                if not R["det"][jmax]:
                    tp[d] = 1.0
                    R["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def eval_dota_task1(detpath: str, annopath: str, imagesetfile_or_names,
                    classnames=util.DOTA10_CLASSES, ovthresh: float = 0.5,
                    use_07_metric: bool = True):
    """DOTA Task1 mAP over oriented polygons -> (mAP, {class: ap})."""
    imagenames = _imagenames(imagesetfile_or_names)
    aps = {}
    for c in classnames:
        _, _, ap = voc_eval_poly(
            detpath, annopath, imagenames, c, ovthresh, use_07_metric
        )
        aps[c] = ap
    return float(np.mean(list(aps.values()))), aps


def eval_dota_task2(detpath: str, annopath: str, imagesetfile_or_names,
                    classnames=util.DOTA10_CLASSES, ovthresh: float = 0.5,
                    use_07_metric: bool = True):
    """DOTA Task2 mAP over horizontal boxes -> (mAP, {class: ap})."""
    imagenames = _imagenames(imagesetfile_or_names)
    aps = {}
    for c in classnames:
        _, _, ap = voc_eval_poly(detpath, annopath, imagenames, c, ovthresh,
                                 use_07_metric, hbb=True)
        aps[c] = ap
    return float(np.mean(list(aps.values()))), aps


def eval_maoe(detpath: str, annopath: str, imagesetfile_or_names,
              classnames=util.DOTA10_CLASSES, ovthresh: float = 0.5,
              return_mod90: bool = False):
    """Mean absolute orientation error over matched detections
    (mAOE_evaluation.py:48-171) -> (mAOE degrees, {class: aoe}).

    The reference's behaviour is kept: every detection matching a gt
    contributes (no gt dedup), angles are not wrapped, and radians become
    degrees by 57.32.  Its main() evaluates at ovthresh=0.7.  With
    return_mod90 it also returns the error folded into [0, 45] degrees,
    min(e mod 90, 90 - e mod 90): (mAOE, {class: aoe}, mAOE_mod90,
    {class: aoe_mod90}).
    """
    imagenames = _imagenames(imagesetfile_or_names)
    per_class = {}
    per_class_mod90 = {}
    for c in classnames:
        class_recs, _ = _load_gt(annopath, imagenames, c)
        image_ids, confidence, BB = _load_dets(detpath.format(c))
        if len(image_ids) == 0:
            continue
        order = np.argsort(-confidence)
        BB = BB[order]
        image_ids = [image_ids[i] for i in order]
        errors = []
        for d in range(len(image_ids)):
            R = class_recs.get(image_ids[d])
            if R is None or R["bbox"].size == 0:
                continue
            bb = BB[d]
            cand = np.where(_hbb_iou_prefilter(R["bbox"], bb) > 0)[0]
            if len(cand) == 0:
                continue
            overlaps = poly_iou_pairs(R["bbox"][cand], bb)
            k = int(np.argmax(overlaps))
            if overlaps[k] > ovthresh:
                th_d = poly2rbox_v3(bb[None])[0, 4]
                th_g = poly2rbox_v3(R["bbox"][cand[k]][None])[0, 4]
                errors.append(abs(th_d - th_g) * 57.32)
        if errors:
            per_class[c] = float(np.mean(errors))
            folded = np.minimum(np.mod(errors, 90.0),
                                90.0 - np.mod(errors, 90.0))
            per_class_mod90[c] = float(np.mean(folded))
    if not per_class:
        return (0.0, {}, 0.0, {}) if return_mod90 else (0.0, {})
    maoe = float(np.mean(list(per_class.values())))
    if not return_mod90:
        return maoe, per_class
    maoe_mod90 = float(np.mean(list(per_class_mod90.values())))
    return maoe, per_class, maoe_mod90, per_class_mod90


def eval_hrsc2016_map(detpath: str, annopath: str, imagesetfile_or_names,
                      ovthresh: float = 0.5, use_07_metric: bool = True):
    """HRSC2016 ship AP (hrsc2016_evaluation.py:87-269)."""
    names = _imagenames(imagesetfile_or_names)
    _, _, ap = voc_eval_poly(detpath, annopath, names, "ship", ovthresh,
                             use_07_metric)
    return ap


UCAS_AOD_CLASSES = ("car", "airplane")


def eval_ucasaod(detpath: str, annopath: str, imagesetfile_or_names,
                 ovthresh: float = 0.7, use_07_metric: bool = True):
    """UCAS-AOD oriented mAP -> (mAP, {class: ap}): the Task1 evaluator
    with the classes car and airplane, IoU 0.7 and the VOC-07 11-point
    metric (ucasaod_evaluation.py:268-291)."""
    return eval_dota_task1(detpath, annopath, imagesetfile_or_names,
                           classnames=UCAS_AOD_CLASSES, ovthresh=ovthresh,
                           use_07_metric=use_07_metric)


def _imagenames(src):
    """A list of image names, or an image-set file of one name a line."""
    if isinstance(src, (list, tuple)):
        return list(src)
    with open(src) as f:
        return [line.strip() for line in f if line.strip()]

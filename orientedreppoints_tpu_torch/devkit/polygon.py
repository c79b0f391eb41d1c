"""Exact polygon geometry on the host in numpy (counterpart of
devkit/polygon.py's numpy path, which replaces DOTA_devkit's polyiou and
shapely): Sutherland-Hodgman clips, areas, IoU, and greedy and soft
polygon NMS."""

from __future__ import annotations

import numpy as np


def clip_polygon(subject: np.ndarray, clip_rect) -> np.ndarray:
    """Sutherland-Hodgman clip of an (n, 2) polygon by the axis-aligned
    rect (xmin, ymin, xmax, ymax) -> (m, 2), possibly empty."""
    xmin, ymin, xmax, ymax = clip_rect

    def clip_edge(poly, inside, intersect):
        if len(poly) == 0:
            return poly
        out = []
        prev = poly[-1]
        prev_in = inside(prev)
        for cur in poly:
            cur_in = inside(cur)
            if cur_in:
                if not prev_in:
                    out.append(intersect(prev, cur))
                out.append(cur)
            elif prev_in:
                out.append(intersect(prev, cur))
            prev, prev_in = cur, cur_in
        return np.asarray(out).reshape(-1, 2)

    def ix(p, q, x):
        t = (x - p[0]) / (q[0] - p[0])
        return np.array([x, p[1] + t * (q[1] - p[1])])

    def iy(p, q, y):
        t = (y - p[1]) / (q[1] - p[1])
        return np.array([p[0] + t * (q[0] - p[0]), y])

    poly = np.asarray(subject, dtype=np.float64).reshape(-1, 2)
    poly = clip_edge(poly, lambda p: p[0] >= xmin, lambda p, q: ix(p, q, xmin))
    poly = clip_edge(poly, lambda p: p[0] <= xmax, lambda p, q: ix(p, q, xmax))
    poly = clip_edge(poly, lambda p: p[1] >= ymin, lambda p, q: iy(p, q, ymin))
    poly = clip_edge(poly, lambda p: p[1] <= ymax, lambda p, q: iy(p, q, ymax))
    return poly


def clip_polygon_poly(subject: np.ndarray,
                      clip_poly: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman clip of a polygon by a convex polygon (turned
    counter-clockwise first)."""
    poly = np.asarray(subject, dtype=np.float64).reshape(-1, 2)
    cp = np.asarray(clip_poly, dtype=np.float64).reshape(-1, 2)
    if polygon_area_signed(cp) < 0:
        cp = cp[::-1]
    n = len(cp)
    for i in range(n):
        if len(poly) == 0:
            break
        a, b = cp[i], cp[(i + 1) % n]
        e = b - a
        out = []
        prev = poly[-1]

        def side(p):
            return e[0] * (p[1] - a[1]) - e[1] * (p[0] - a[0])

        prev_side = side(prev)
        for cur in poly:
            cur_side = side(cur)
            if cur_side >= 0:
                if prev_side < 0:
                    t = prev_side / (prev_side - cur_side)
                    out.append(prev + t * (cur - prev))
                out.append(cur)
            elif prev_side >= 0:
                t = prev_side / (prev_side - cur_side)
                out.append(prev + t * (cur - prev))
            prev, prev_side = cur, cur_side
        poly = np.asarray(out).reshape(-1, 2)
    return poly


def polygon_area_signed(poly: np.ndarray) -> float:
    p = np.asarray(poly, dtype=np.float64).reshape(-1, 2)
    if len(p) < 3:
        return 0.0
    x, y = p[:, 0], p[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def polygon_area(poly: np.ndarray) -> float:
    return abs(polygon_area_signed(poly))


def orient_ccw(poly: np.ndarray) -> np.ndarray:
    """The polygon with positive (counter-clockwise) signed area."""
    p = np.asarray(poly, dtype=np.float64).reshape(-1, 2)
    return p if polygon_area_signed(p) >= 0 else p[::-1]


def poly_iou(poly1, poly2) -> float:
    """Exact IoU of two convex polygons, (8,) or (n, 2) each."""
    p1 = orient_ccw(np.asarray(poly1, np.float64).reshape(-1, 2))
    p2 = orient_ccw(np.asarray(poly2, np.float64).reshape(-1, 2))
    inter = polygon_area(clip_polygon_poly(p1, p2))
    a1, a2 = polygon_area(p1), polygon_area(p2)
    union = a1 + a2 - inter
    if union <= 0:
        return 0.0
    return inter / union


def poly_iou_matrix(polys1: np.ndarray, polys2: np.ndarray) -> np.ndarray:
    """(n, m) exact IoU between two (k, 8) polygon arrays."""
    p1 = np.asarray(polys1, np.float64).reshape(-1, 8)
    p2 = np.asarray(polys2, np.float64).reshape(-1, 8)
    return np.array([[poly_iou(a, b) for b in p2] for a in p1], np.float64)


def poly_nms(dets: np.ndarray, thresh: float) -> list[int]:
    """Greedy polygon NMS of (n, 9) [poly(8), score] -> kept indices, best
    first (py_cpu_nms_poly_fast, ResultMerge_multi_process.py:60-121): the
    exact IoU only for pairs whose axis-aligned boxes overlap (the +1 pixel
    convention); suppression where IoU > thresh."""
    dets = np.asarray(dets, np.float64)
    if len(dets) == 0:
        return []
    obbs = dets[:, :8]
    x1 = obbs[:, 0::2].min(1)
    y1 = obbs[:, 1::2].min(1)
    x2 = obbs[:, 0::2].max(1)
    y2 = obbs[:, 1::2].max(1)
    scores = dets[:, 8]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        w = np.maximum(0.0, xx2 - xx1)
        h = np.maximum(0.0, yy2 - yy1)
        hbb_inter = w * h
        hbb_ovr = hbb_inter / (areas[i] + areas[rest] - hbb_inter)
        cand = np.where(hbb_ovr > 0)[0]
        for j in cand:
            hbb_ovr[j] = poly_iou(obbs[i], obbs[rest[j]])
        order = rest[np.where(hbb_ovr <= thresh)[0]]
    return keep


def soft_poly_nms(dets: np.ndarray, iou_thr: float, method: str = "linear",
                  sigma: float = 0.5, min_score: float = 1e-3):
    """Soft rotated NMS on the host (the reference CPU soft_rnms,
    nms_wrapper.py:120-175): take the best live score, then decay every
    other live score by its exact IoU with that box -- linear: s *= 1 - iou
    where iou > iou_thr; gaussian: s *= exp(-iou^2 / sigma); any other
    method ('original'): s = 0 where iou > iou_thr -- and drop the boxes
    that fall below min_score.

    dets: (n, 9) [poly(8), score] -> (kept dets (k, 9) with their decayed
    scores, in pick order; their indices (k,))."""
    dets = np.asarray(dets, np.float64).copy()
    n = len(dets)
    keep_dets, keep_inds = [], []
    scores = dets[:, 8].copy()
    alive = np.ones(n, bool)
    while alive.any():
        live = np.where(alive)[0]
        i = live[np.argmax(scores[live])]
        keep_dets.append(np.concatenate([dets[i, :8], [scores[i]]]))
        keep_inds.append(int(i))
        alive[i] = False
        for j in np.where(alive)[0]:
            iou = poly_iou(dets[i, :8], dets[j, :8])
            if method == "linear":
                if iou > iou_thr:
                    scores[j] *= 1.0 - iou
            elif method == "gaussian":
                scores[j] *= np.exp(-(iou * iou) / sigma)
            elif iou > iou_thr:
                scores[j] = 0.0
            if scores[j] < min_score:
                alive[j] = False
    return np.asarray(keep_dets).reshape(-1, 9), np.asarray(keep_inds)

"""Rotated box <-> polygon conversions on the host (numpy; counterpart of
core/rbox.py's rbox2poly with its best-begin-point order, poly2rbox, and
poly2rbox_v3 after DOTA_devkit/dota_poly2rbox.py)."""

from __future__ import annotations

import numpy as np

PI = np.pi


def rbox2poly(rboxes: np.ndarray) -> np.ndarray:
    """(n, 5) [cx, cy, w, h, angle] -> (n, 8) float32 corner polygons:
    tl, tr, br, bl of the box rotated by angle (radians), in float64, then
    cast and put in best-begin-point order."""
    rboxes = np.asarray(rboxes, dtype=np.float64).reshape(-1, 5)
    cx, cy, w, h, ang = rboxes.T
    dx, dy = w / 2, h / 2
    local_x = np.stack([-dx, dx, dx, -dx], axis=1)
    local_y = np.stack([-dy, -dy, dy, dy], axis=1)
    cos, sin = np.cos(ang)[:, None], np.sin(ang)[:, None]
    gx = cos * local_x - sin * local_y + cx[:, None]
    gy = sin * local_x + cos * local_y + cy[:, None]
    polys = np.stack([gx, gy], axis=2).reshape(-1, 8).astype(np.float32)
    return get_best_begin_point(polys)


def poly2rbox(polys: np.ndarray) -> np.ndarray:
    """(n, 8) corner polygons -> (n, 5) float32 [cx, cy, w, h, angle] in
    float64 arithmetic: width the longer of edges (p0, p1) and (p1, p2),
    the angle along it normalized to [-pi/4, 3pi/4), the centre halfway
    between p0 and p2 (the hard-aug transforms filter on these)."""
    polys = np.asarray(polys, dtype=np.float64).reshape(-1, 8)
    p = polys.reshape(-1, 4, 2)
    e1 = np.linalg.norm(p[:, 0] - p[:, 1], axis=1)
    e2 = np.linalg.norm(p[:, 1] - p[:, 2], axis=1)
    wide = e1 > e2
    width = np.where(wide, e1, e2)
    height = np.where(wide, e2, e1)
    ang1 = np.arctan2(p[:, 1, 1] - p[:, 0, 1], p[:, 1, 0] - p[:, 0, 0])
    ang2 = np.arctan2(p[:, 3, 1] - p[:, 0, 1], p[:, 3, 0] - p[:, 0, 0])
    angle = np.where(wide, ang1, ang2)
    angle = (angle + PI / 4) % PI - PI / 4
    cx = (p[:, 0, 0] + p[:, 2, 0]) / 2
    cy = (p[:, 0, 1] + p[:, 2, 1]) / 2
    return np.stack([cx, cy, width, height, angle], axis=1).astype(
        np.float32)


def get_best_begin_point(polys: np.ndarray) -> np.ndarray:
    """Each polygon cyclically shifted so that its corners lie nearest, as
    a sum of distances, to its axis-aligned box's corners (xmin, ymin),
    (xmax, ymin), (xmax, ymax), (xmin, ymax); the first best shift wins."""
    p = np.asarray(polys, dtype=np.float32).reshape(-1, 4, 2)
    lo, hi = p.min(axis=1), p.max(axis=1)
    ref = np.stack([lo, np.stack([hi[:, 0], lo[:, 1]], 1), hi,
                    np.stack([lo[:, 0], hi[:, 1]], 1)], axis=1)
    shifts = np.stack([np.roll(p, -k, axis=1) for k in range(4)], axis=1)
    dists = np.linalg.norm(shifts - ref[:, None], axis=3).sum(axis=2)
    return shifts[np.arange(len(p)), dists.argmin(axis=1)].reshape(-1, 8)


def poly2rbox_v3(polys: np.ndarray) -> np.ndarray:
    """(n, 8) -> (n, 5) float32 in the devkit's square-aware convention
    (poly2rbox_single_v3): where max_edge / min_edge < 1.15 both candidate
    angles are normalized to [-pi/4, 3pi/4) and the one of smaller |angle|
    wins, with width the longer edge; otherwise width is the longer of
    edges (p0, p1) and (p1, p2) and the angle runs along it.  The mAOE
    evaluator scores angles in this convention."""
    polys = np.asarray(polys, dtype=np.float64).reshape(-1, 8)
    p = polys.reshape(-1, 4, 2)
    e1 = np.linalg.norm(p[:, 0] - p[:, 1], axis=1)
    e2 = np.linalg.norm(p[:, 1] - p[:, 2], axis=1)
    ang1 = np.arctan2(p[:, 1, 1] - p[:, 0, 1], p[:, 1, 0] - p[:, 0, 0])
    ang2 = np.arctan2(p[:, 3, 1] - p[:, 0, 1], p[:, 3, 0] - p[:, 0, 0])
    n1 = (ang1 + PI / 4) % PI - PI / 4
    n2 = (ang2 + PI / 4) % PI - PI / 4
    max_e = np.maximum(e1, e2)
    min_e = np.minimum(e1, e2)
    near_square = max_e / np.maximum(min_e, 1e-12) < 1.15
    square_angle = np.where(np.abs(n1) > np.abs(n2), n2, n1)
    long_angle = np.where(e1 > e2, n1, n2)
    angle = np.where(near_square, square_angle, long_angle)
    width = np.where(near_square, max_e, np.where(e1 > e2, e1, e2))
    height = np.where(near_square, min_e, np.where(e1 > e2, e2, e1))
    cx = (p[:, 0, 0] + p[:, 2, 0]) / 2
    cy = (p[:, 0, 1] + p[:, 2, 1]) / 2
    return np.stack([cx, cy, width, height, angle], axis=1).astype(
        np.float32)

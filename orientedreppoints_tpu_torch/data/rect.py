"""OpenCV 5.0's convexHull, minAreaRect and boxPoints of a small integer
point set, rebuilt in Python for CorrectBox (cv2 is not a dependency of
the port).

CorrectBox snaps each ground-truth polygon to the corners of its
minimum-area rectangle, and which corner comes first decides the edge the
loss's polygons start from, so the corners must be cv2's in value and in
order.  Each function follows OpenCV's float32 code path step by step:

  * convex_hull: the float path of cv2.convexHull(points,
    clockwise=False): points sorted by (x, y, index), Sklansky's scan of
    the four quarter chains with double convexity (collinear points
    dropped), the hull of a segment mirrored, then the cyclic shift that
    makes the hull's indices run in order where it can;
  * min_area_rect: rotatingCalipers in float32: edge vectors and their
    inverse lengths (1 / sqrt in double), the four calipers started at
    the bottom, right, top and left points, the caliper to advance chosen
    by the sign of a cross product of the edge vectors (not by cosines),
    the area kept with <= (the last smallest); then cv2.minAreaRect's
    centre and size (sqrt in double of the float vectors), the hull's 2-
    and 1-point branches, and its angle: atan2 in double, shifted by 90
    degrees (swapping width and height) into [-90, 0);
  * box_points: RotatedRect::points: a = sin / 2, b = cos / 2 in float32,
    each corner centre -/+ a h -/+ b w.

The points are integers (CorrectBox casts them to int64 first), so the
hull is exact and the float32 arithmetic reproduces cv2's bit for bit
(tests/test_torch_train_data.py: every tested quad, degenerate ones
included).
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32
_HALF = _F32(0.5)
_F32_MAX = _F32(np.finfo(np.float32).max)


def _sign(v) -> int:
    return (v > 0) - (v < 0)


def _sklansky(pts, order, start, end, stack, base, nsign, sign2) -> int:
    """One monotone chain from sorted position start to end onto
    stack[base:]; returns its length."""
    incr = 1 if end > start else -1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    if start == end or pts[order[start]] == pts[order[end]]:
        stack[base] = start
        return 1
    stack[base:base + 3] = [pprev, pcur, pnext]
    size = 3
    end += incr
    while pnext != end:
        cury = pts[order[pcur]][1]
        by = pts[order[pnext]][1] - cury
        if _sign(by) != nsign:
            ax = pts[order[pcur]][0] - pts[order[pprev]][0]
            bx = pts[order[pnext]][0] - pts[order[pcur]][0]
            ay = cury - pts[order[pprev]][1]
            convexity = ay * bx - ax * by
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack[base + size] = pnext
                size += 1
            elif pprev == start:
                pcur = pnext
                stack[base + 1] = pcur
                pnext += incr
                stack[base + 2] = pnext
            else:
                stack[base + size - 2] = pnext
                pcur = pprev
                pprev = stack[base + size - 4]
                size -= 1
        else:
            pnext += incr
            stack[base + size - 1] = pnext
    return size - 1


def _cyclic_shift(hull: list[int]) -> list[int]:
    """Rotate the hull so that its indices ascend (or descend) where a
    rotation can make them."""
    n = len(hull)
    min_i = max_i = lt = 0
    for i in range(1, n):
        lt += hull[i - 1] < hull[i]
        if 1 < lt < i - 1:
            break
        if hull[i] < hull[min_i]:
            min_i = i
        if hull[i] > hull[max_i]:
            max_i = i
    if abs(max_i - min_i) not in (1, n - 1) or 1 < lt < n - 2:
        return hull
    ascending = (max_i + 1) % n == min_i
    i0 = min_i if ascending else max_i
    if i0 == 0:
        return hull
    out = hull[i0:] + hull[:i0]
    if all(ascending == (a < b) for a, b in zip(out, out[1:])):
        return out
    return hull


def convex_hull(pts) -> list[int]:
    """Indices of cv2.convexHull(pts, clockwise=False) for (n, 2) integer
    points, n >= 1."""
    pts = [(float(x), float(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    total = len(pts)
    order = sorted(range(total), key=lambda i: (pts[i][0], pts[i][1], i))
    miny = maxy = 0
    for i in range(1, total):
        y = pts[order[i]][1]
        if pts[order[miny]][1] > y:
            miny = i
        if pts[order[maxy]][1] < y:
            maxy = i
    if pts[order[0]] == pts[order[-1]]:
        return [order[0]]
    stack = [0] * (total + 2)
    # upper half: counter-clockwise output takes the right chain first
    tl = _sklansky(pts, order, 0, maxy, stack, 0, -1, 1)
    tl_stack = stack[:tl]
    tr = _sklansky(pts, order, total - 1, maxy, stack, tl, -1, -1)
    tr_stack = stack[tl:tl + tr]
    hull = [order[k] for k in tr_stack[:-1]]
    hull += [order[k] for k in reversed(tl_stack[1:])]
    stop = tl_stack[1] if tl > 2 else tr_stack[-2] if tr > 2 else -1
    # lower half
    bl = _sklansky(pts, order, 0, miny, stack, 0, 1, -1)
    bl_stack = stack[:bl]
    br = _sklansky(pts, order, total - 1, miny, stack, bl, 1, 1)
    br_stack = stack[bl:bl + br]
    if stop >= 0:
        check = (bl_stack[1] if bl > 2 else
                 br_stack[2 - bl] if bl + br > 2 else -1)
        if check == stop or (check >= 0
                             and pts[order[check]] == pts[order[stop]]):
            # all points on one line: the lower chain mirrors the upper
            bl, br = min(bl, 2), min(br, 2)
    hull += [order[k] for k in bl_stack[:bl - 1]]
    hull += [order[k] for k in reversed(br_stack[1:br])]
    return _cyclic_shift(hull) if len(hull) >= 3 else hull


def _rotating_calipers(xs, ys):
    """cv2's rotatingCalipers(CALIPERS_MINAREARECT) over a hull of n >= 3
    float32 vertices -> the rect's corner and its two side vectors."""
    n = len(xs)
    vx, vy, inv = [], [], []
    left = bottom = right = top = 0
    for i in range(n):
        if xs[i] < xs[left]:
            left = i
        if xs[i] > xs[right]:
            right = i
        if ys[i] > ys[top]:
            top = i
        if ys[i] < ys[bottom]:
            bottom = i
        j = (i + 1) % n
        dx, dy = float(xs[j] - xs[i]), float(ys[j] - ys[i])
        vx.append(_F32(dx))
        vy.append(_F32(dy))
        inv.append(_F32(1.0 / math.sqrt(dx * dx + dy * dy)))
    orientation = _F32(0)
    ax, ay = float(vx[-1]), float(vy[-1])
    for i in range(n):
        bx, by = float(vx[i]), float(vy[i])
        convexity = ax * by - ay * bx
        if convexity != 0:
            orientation = _F32(1 if convexity > 0 else -1)
            break
        ax, ay = bx, by
    if orientation == 0:
        raise ValueError("rotating calipers: the hull has no area")
    base_a, base_b = orientation, _F32(0)
    seq = [bottom, right, top, left]
    minarea, best = _F32_MAX, None
    for _ in range(n):
        # each caliper's edge turned into caliper 0's frame; advance the
        # one that is furthest clockwise (ties: the first)
        rot = [(vx[seq[0]], vy[seq[0]]), (vy[seq[1]], -vx[seq[1]]),
               (-vx[seq[2]], -vy[seq[2]]), (-vy[seq[3]], vx[seq[3]])]
        main = 0
        for i in range(1, 4):
            if rot[i][1] * rot[main][0] - rot[i][0] * rot[main][1] < 0:
                main = i
        p = seq[main]
        lx, ly = vx[p] * inv[p], vy[p] * inv[p]
        base_a, base_b = ((lx, ly), (ly, -lx), (-lx, -ly), (-ly, lx))[main]
        seq[main] = (p + 1) % n
        width = ((xs[seq[1]] - xs[seq[3]]) * base_a
                 + (ys[seq[1]] - ys[seq[3]]) * base_b)
        height = (-(xs[seq[2]] - xs[seq[0]]) * base_b
                  + (ys[seq[2]] - ys[seq[0]]) * base_a)
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    i0, a1, width, b1, height, i5 = best
    a2, b2 = -b1, a1
    c1 = a1 * xs[i0] + ys[i0] * b1
    c2 = a2 * xs[i5] + ys[i5] * b2
    idet = _F32(1) / (a1 * b2 - a2 * b1)
    px = (c1 * b2 - c2 * b1) * idet
    py = (a1 * c2 - a2 * c1) * idet
    return (px, py), (a1 * width, b1 * width), (a2 * height, b2 * height)


def min_area_rect(pts):
    """cv2.minAreaRect of (n, 2) integer points -> ((cx, cy), (w, h),
    angle) as float32 values, the angle in degrees in [-90, 0)."""
    pts = np.asarray(pts).reshape(-1, 2)
    hull = pts[convex_hull(pts)].astype(np.float32)
    xs, ys = list(hull[:, 0]), list(hull[:, 1])
    n = len(xs)
    if n > 2:
        o, v1, v2 = _rotating_calipers(xs, ys)
        cx = o[0] + (v1[0] + v2[0]) * _HALF
        cy = o[1] + (v1[1] + v2[1]) * _HALF
        w = math.sqrt(float(v1[0]) ** 2 + float(v1[1]) ** 2)
        h = math.sqrt(float(v2[0]) ** 2 + float(v2[1]) ** 2)
        angle = math.atan2(float(v1[1]), float(v1[0]))
    elif n == 2:
        cx = (xs[0] + xs[1]) * _HALF
        cy = (ys[0] + ys[1]) * _HALF
        dx, dy = float(xs[1] - xs[0]), float(ys[1] - ys[0])
        w, h = math.sqrt(dx * dx + dy * dy), 0.0
        angle = math.atan2(dy, dx)
    else:
        cx, cy, w, h, angle = xs[0], ys[0], 0.0, 0.0, 0.0
    w, h = _F32(w), _F32(h)
    while angle >= 0:
        angle -= math.pi / 2
        w, h = h, w
    while angle < -math.pi / 2:
        angle += math.pi / 2
        w, h = h, w
    return (_F32(cx), _F32(cy)), (w, h), _F32(angle * 180 / math.pi)


def box_points(rect) -> np.ndarray:
    """cv2.boxPoints(rect) -> (4, 2) float32 corners."""
    (cx, cy), (w, h), angle = rect
    cx, cy, w, h = _F32(cx), _F32(cy), _F32(w), _F32(h)
    t = float(_F32(angle)) * math.pi / 180.0
    b = _F32(math.cos(t)) * _HALF
    a = _F32(math.sin(t)) * _HALF
    ah, bw, bh, aw = a * h, b * w, b * h, a * w
    return np.array([[cx - ah - bw, cy + bh - aw],
                     [cx + ah - bw, cy - bh - aw],
                     [cx + ah + bw, cy - bh + aw],
                     [cx - ah + bw, cy + bh + aw]], np.float32)

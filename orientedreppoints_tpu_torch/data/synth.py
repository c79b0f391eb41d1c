"""Synthetic DOTA-style scenes for the closed-loop quality benchmark
(counterpart of data/synth.py): oriented coloured rectangles with
per-class size, aspect and colour on a textured background, labelled in
DOTA's labelTxt format.  The default "easy" scenes have 6 separable
classes; the hard ones (HARD_RENDER_KWARGS) have all 15 DOTA classes in
colliding colour families, denser packing, heavier noise, a brightness
ramp and 40 unlabelled distractors a scene.

The JAX package draws with cv2 5.0, which the port does not use.  Its
calls are rebuilt here in numpy from cv2's own integer arithmetic, and
equal cv2 bit for bit (tests/test_torch_synth.py), off-image vertices and
end points included:

  * cv2.resize(..., INTER_CUBIC) of the float32 background:
    host.resize_cubic, OpenCV's own loops (cv2 takes IPP there, whose
    weights round otherwise: a pixel in ~30,000 ends one grey level off);
  * cv2.fillPoly of one polygon (fill_poly): the polygon's edges drawn as
    8-connected lines, then cv2's edge-collection fill in 16.16 fixed
    point with each edge's slope truncated, built from the edge clipped
    to the image where it leaves it; each row fills its sorted crossings
    in pairs, from the left one rounded up to the right one rounded down;
  * cv2.line (draw_line): at thickness 1 the segment clipped to the image
    (clipLine), then Bresenham from its left end; thicker, the segment
    clipped to the image grown by the thickness, a quad of the segment's
    width in 16.16 fixed point filled as a convex polygon, and a round
    cap at each end from cv2's integer circle fill;
  * cv2.ellipse(..., 0, 360, colour, -1) (fill_ellipse): the angle rounded
    to a whole degree, ellipse2Poly's outline from cv2's table of sines
    (7 decimals) at a step set by the larger axis, filled as a convex
    polygon;
  * cv2.polylines(..., closed): draw_line of each edge;
  * cv2.circle(..., -1) (fill_circle): cv2's Circle fill, each row of the
    midpoint walk filled between its ends.

The random stream is drawn in the reference's order, so polygons, names
and labels are the reference's exactly.  generate_synth_dota writes the
images as .npy (BGR uint8, as cv2 stores them) unless asked for PNG (the
JAX generator's files) or BMP, through data/image_io.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from ..devkit import dota_utils as util
from ..host import resize_cubic
from . import image_io

# name -> (BGR colour, (min_long, max_long), (min_aspect, max_aspect))
SYNTH_CLASS_SPECS = {
    "plane": ((60, 60, 230), (44, 64), (1.0, 1.3)),
    "bridge": ((160, 160, 160), (90, 150), (5.0, 8.0)),
    "small-vehicle": ((230, 120, 40), (16, 26), (1.8, 2.4)),
    "large-vehicle": ((40, 200, 230), (34, 52), (2.2, 3.0)),
    "ship": ((230, 220, 80), (44, 76), (2.8, 3.6)),
    "storage-tank": ((240, 240, 240), (26, 42), (1.0, 1.15)),
}

# the hard benchmark: all 15 DOTA-1.0 classes in colliding colour families
# (telling them apart takes shape and size)
SYNTH_HARD_CLASS_SPECS = {
    "plane": ((60, 60, 230), (34, 54), (1.0, 1.4)),
    "baseball-diamond": ((50, 140, 90), (40, 60), (1.0, 1.25)),
    "bridge": ((150, 150, 150), (70, 140), (4.5, 8.0)),
    "ground-track-field": ((60, 170, 80), (90, 130), (1.5, 2.0)),
    "small-vehicle": ((200, 120, 60), (10, 20), (1.7, 2.4)),
    "large-vehicle": ((210, 130, 50), (26, 44), (2.2, 3.2)),
    "ship": ((200, 200, 90), (30, 64), (2.6, 3.8)),
    "tennis-court": ((90, 60, 160), (36, 50), (1.8, 2.2)),
    "basketball-court": ((100, 70, 150), (44, 62), (1.5, 1.9)),
    "storage-tank": ((235, 235, 235), (18, 36), (1.0, 1.15)),
    "soccer-ball-field": ((55, 160, 95), (60, 90), (1.3, 1.7)),
    "roundabout": ((225, 225, 225), (36, 56), (1.0, 1.1)),
    "harbor": ((120, 100, 80), (50, 100), (3.5, 5.5)),
    "swimming-pool": ((190, 150, 60), (22, 40), (1.4, 2.0)),
    "helicopter": ((70, 70, 210), (24, 40), (1.5, 2.1)),
}

HARD_RENDER_KWARGS = dict(
    specs=SYNTH_HARD_CLASS_SPECS,
    color_jitter=24.0,
    noise=20.0,
    pack=0.55,
    n_distractors=40,
    brightness_gradient=True,
)

_XY_SHIFT = 16  # cv2's fixed-point fraction bits
_XY_ONE = 1 << _XY_SHIFT
_XY_HALF = _XY_ONE >> 1
# cv2's SinTable: sin of 0..450 whole degrees as 7-decimal float literals
_SIN_TABLE = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(
    np.float32).astype(np.float64)


def _rot_rect_poly(cx, cy, w, h, angle):
    c, s = np.cos(angle), np.sin(angle)
    corners = np.array(
        [[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]]
    )
    return corners @ np.array([[c, s], [-s, c]]) + [cx, cy]


def _cdiv(a: int, b: int) -> int:
    """C's integer division, truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def clip_line(w: int, h: int, p1, p2):
    """cv2.clipLine to the w x h rectangle -> (inside, p1, p2): the end
    points as clipLine leaves them, also where it returns False (each
    crossing computed in double and truncated toward zero)."""
    (x1, y1), (x2, y2) = (int(v) for v in p1), (int(v) for v in p2)
    if w <= 0 or h <= 0:
        return False, (x1, y1), (x2, y2)
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def line_pixels(a, b) -> tuple[np.ndarray, np.ndarray]:
    """(ys, xs) of cv2's 8-connected line from a to b (integer points
    inside the image): Bresenham from the left end, one pixel a step along
    the major axis, the minor one after m_i = (2 d_minor i + d_major - 1)
    // (2 d_major) steps."""
    (xa, ya), (xb, yb) = (int(v) for v in a), (int(v) for v in b)
    if xb < xa:
        (xa, ya), (xb, yb) = (xb, yb), (xa, ya)
    dx, dy = xb - xa, yb - ya
    sy = 1 if dy >= 0 else -1
    ady = abs(dy)
    major, minor = (ady, dx) if ady > dx else (dx, ady)
    i = np.arange(major + 1)
    m = (2 * minor * i + major - 1) // (2 * major) if major else i
    if ady > dx:
        return ya + sy * i, xa + m
    return ya + sy * m, xa + i


def _colour(img, color):
    """The colour as cv2 stores it in img: rounded to the image's dtype."""
    return np.asarray(color, np.float64).astype(img.dtype)


def _thin_line(img, p1, p2, col) -> None:
    """cv2's Line: the segment clipped to the image, then line_pixels."""
    h, w = img.shape[:2]
    if not all(0 <= p[0] < w and 0 <= p[1] < h for p in (p1, p2)):
        inside, p1, p2 = clip_line(w, h, p1, p2)
        if not inside:
            return
    ys, xs = line_pixels(p1, p2)
    img[ys, xs] = col


def _fixed_line(img, p1, p2, col) -> None:
    """cv2's Line2, the 8-connected line between 16.16 fixed-point points
    that outlines a convex fill: clipped to the image in fixed point, one
    step a pixel along the major axis from the lower end, the minor
    coordinate advanced by the truncated slope, and the far end's pixel."""
    h, w = img.shape[:2]
    inside, (x1, y1), (x2, y2) = clip_line(w << _XY_SHIFT, h << _XY_SHIFT,
                                           p1, p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:
            dy = -dy
            (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
        k = np.arange(((x2 - x1) >> _XY_SHIFT) + 1)
        xs = ((x1 + _XY_HALF) >> _XY_SHIFT) + k
        ys = (y1 + _XY_HALF
              + k * _cdiv(dy << _XY_SHIFT, abs(dx) | 1)) >> _XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
        k = np.arange(((y2 - y1) >> _XY_SHIFT) + 1)
        ys = ((y1 + _XY_HALF) >> _XY_SHIFT) + k
        xs = (x1 + _XY_HALF
              + k * _cdiv(dx << _XY_SHIFT, abs(dy) | 1)) >> _XY_SHIFT
    ys = np.append(ys, (y2 + _XY_HALF) >> _XY_SHIFT)
    xs = np.append(xs, (x2 + _XY_HALF) >> _XY_SHIFT)
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    img[ys[ok], xs[ok]] = col


def _hline(img, y: int, x1: int, x2: int, col) -> None:
    """Pixels x1..x2 of row y, clipped to the image."""
    h, w = img.shape[:2]
    if 0 <= y < h and x2 >= 0 and x1 < w:
        img[y, max(x1, 0):min(x2, w - 1) + 1] = col


def _fill_circle(img, cx: int, cy: int, radius: int, col) -> None:
    """cv2's Circle with fill: the midpoint walk of one octant, each step
    filling the rows cy +- dy over cx +- dx and cy +- dx over cx +- dy."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy),
                        (cy + dx, dy)):
            _hline(img, y, cx - half, cx + half, col)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _fill_convex(img, v: list, col) -> None:
    """cv2's FillConvexPoly of 16.16 fixed-point vertices v (line type 8):
    the outline by _fixed_line, then from the top vertex (the first of
    the lowest y) one edge walks forward and one backward, each a start x
    and a slope rounded to nearest, and each row from y_min to y_max
    (rounded, and at most the last row) fills between the two, both
    rounded to nearest."""
    h, w = img.shape[:2]
    n = len(v)
    p0 = v[-1]
    for p in v:
        _fixed_line(img, p0, p, col)
        p0 = p
    xs = [p[0] for p in v]
    ys = [p[1] for p in v]
    xmin, xmax = ((min(xs) + _XY_HALF) >> _XY_SHIFT,
                  (max(xs) + _XY_HALF) >> _XY_SHIFT)
    ymin, ymax = ((min(ys) + _XY_HALF) >> _XY_SHIFT,
                  (max(ys) + _XY_HALF) >> _XY_SHIFT)
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    top = ys.index(min(ys))
    idx, step = [top, top], [1, n - 1]
    x, dx, ye = [-_XY_ONE, -_XY_ONE], [0, 0], [ymin, ymin]
    edges = n
    y = ymin
    while True:
        for i in range(2):
            if y < ye[i]:
                continue
            i0 = idx[i]
            i1 = (i0 + step[i]) % n
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = (v[i1][1] + _XY_HALF) >> _XY_SHIFT
                if ty > y:
                    xs0, xe = v[i0][0], v[i1][0]
                    ye[i] = ty
                    dx[i] = _cdiv((xe - xs0) * 2 + (ty - y), 2 * (ty - y))
                    x[i] = xs0
                    idx[i] = i1
                    break
                i0, i1 = i1, (i1 + step[i]) % n
        if edges < 0:
            break
        if y >= 0:
            lo, hi = sorted(x)
            _hline(img, y, (lo + _XY_HALF) >> _XY_SHIFT,
                   (hi + _XY_HALF) >> _XY_SHIFT, col)
        x = [x[0] + dx[0], x[1] + dx[1]]
        y += 1
        if y > ymax:
            break


def fill_poly(img: np.ndarray, pts: np.ndarray, color) -> None:
    """cv2.fillPoly(img, [pts], color) for one polygon of integer vertices,
    anywhere (off the image, repeated or collinear too), bit for bit.

    Each edge (from the previous vertex) is drawn as a thin line, then
    kept, unless horizontal, as a start x at its upper row y0 and a slope
    dx in 16.16 fixed point (C division), active on rows y0 <= y < y1.
    An edge inside the image runs between its vertices; one that leaves it
    takes its x's from its clipped end points (and their rows too unless
    the clipped ones share a row), its start x extrapolated back to y0.
    On each row the active edges' x's, sorted, fill in pairs from the
    left one rounded up to the right one rounded down."""
    h, w = img.shape[:2]
    col = _colour(img, color)
    v = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []
    q0 = v[-1]
    for q1 in v:
        _thin_line(img, q0, q1, col)
        c0 = [q0[0] << _XY_SHIFT, q0[1]]
        c1 = [q1[0] << _XY_SHIFT, q1[1]]
        if not all(0 <= q[0] < w and 0 <= q[1] < h for q in (q0, q1)):
            _, t0, t1 = clip_line(w, h, q0, q1)
            c0[0], c1[0] = t0[0] << _XY_SHIFT, t1[0] << _XY_SHIFT
            if t0[1] != t1[1]:
                c0[1], c1[1] = t0[1], t1[1]
        if q0[1] != q1[1]:
            dx = _cdiv(c1[0] - c0[0], c1[1] - c0[1])
            (ya, ca), yb = ((q0[1], c0), q1[1]) if q0[1] < q1[1] else \
                ((q1[1], c1), q0[1])
            edges.append((ya, yb, ca[0] + (ya - ca[1]) * dx, dx))
        q0 = q1
    if len(edges) < 2:
        return
    y0, y1, x0, dx = (np.array(a, np.int64) for a in zip(*edges))
    x1 = x0 + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x0.max(), x1.max()) < 0
            or min(x0.min(), x1.min()) >= w << _XY_SHIFT):
        return
    ys = np.arange(max(int(y0.min()), 0), min(int(y1.max()), h))
    if len(ys) == 0:
        return
    active = (ys[:, None] >= y0[None]) & (ys[:, None] < y1[None])
    big = np.iinfo(np.int64).max
    xs = np.sort(np.where(active, x0[None] + (ys[:, None] - y0[None]) * dx,
                          big), axis=1)
    cols = np.arange(w)
    inside = np.zeros((len(ys), w), bool)
    for k in range(0, xs.shape[1] - 1, 2):
        pair = xs[:, k + 1] != big
        lo = np.where(pair, (xs[:, k] + _XY_ONE - 1) >> _XY_SHIFT, 1)
        hi = np.where(pair, xs[:, k + 1] >> _XY_SHIFT, 0)
        inside |= (cols[None] >= lo[:, None]) & (cols[None] <= hi[:, None])
    rows, cs = np.nonzero(inside)
    img[ys[rows], cs] = col


def draw_line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> None:
    """cv2.line(img, p1, p2, color, thickness) of integer end points
    anywhere, line type 8, bit for bit (thickness 1, 2, 3 tested)."""
    col = _colour(img, color)
    t = int(thickness)
    p1 = (int(p1[0]), int(p1[1]))
    p2 = (int(p2[0]), int(p2[1]))
    if t <= 1:
        _thin_line(img, p1, p2, col)
        return
    h, w = img.shape[:2]
    inside, q1, q2 = clip_line(w + 2 * t, h + 2 * t, (p1[0] + t, p1[1] + t),
                               (p2[0] + t, p2[1] + t))
    if not inside:
        return
    p1 = ((q1[0] - t) << _XY_SHIFT, (q1[1] - t) << _XY_SHIFT)
    p2 = ((q2[0] - t) << _XY_SHIFT, (q2[1] - t) << _XY_SHIFT)
    dx = (p1[0] - p2[0]) / _XY_ONE
    dy = (p2[1] - p1[1]) / _XY_ONE
    r = dx * dx + dy * dy
    half = t << (_XY_SHIFT - 1)  # the half width in fixed point
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + (t & 1) * _XY_ONE * 0.5) / np.sqrt(r)
        ex, ey = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex(img, [(p1[0] + ex, p1[1] + ey), (p1[0] - ex, p1[1] - ey),
                           (p2[0] - ex, p2[1] - ey), (p2[0] + ex, p2[1] + ey)],
                     col)
    for p in (p1, p2):
        _fill_circle(img, (p[0] + _XY_HALF) >> _XY_SHIFT,
                     (p[1] + _XY_HALF) >> _XY_SHIFT,
                     (half + _XY_HALF) >> _XY_SHIFT, col)


def fill_ellipse(img: np.ndarray, center, axes, angle: float, color) -> None:
    """cv2.ellipse(img, center, axes, angle, 0, 360, color, -1) of an
    integer centre and axes, bit for bit: the angle rounded half to even
    to whole degrees; ellipse2Poly's points every 90, 30, 18 or 5 degrees
    (the larger axis < 3, < 10, < 15 px or more) from the table of sines,
    in double on the 16.16 fixed-point centre and axes; each rounded to
    fixed point, repeats dropped, and the polygon filled by
    _fill_convex."""
    col = _colour(img, color)
    cx, cy = int(center[0]) << _XY_SHIFT, int(center[1]) << _XY_SHIFT
    aw = abs(int(axes[0])) << _XY_SHIFT
    ah = abs(int(axes[1])) << _XY_SHIFT
    deg = int(np.rint(angle))
    while deg < 0:
        deg += 360
    while deg > 360:
        deg -= 360
    big = (max(aw, ah) + _XY_HALF) >> _XY_SHIFT
    step = 90 if big < 3 else 30 if big < 10 else 18 if big < 15 else 5
    alpha, beta = _SIN_TABLE[450 - deg], _SIN_TABLE[deg]
    a = np.minimum(np.arange(0, 360 + step, step), 360)
    px = aw * _SIN_TABLE[450 - a]
    py = ah * _SIN_TABLE[a]
    fx = cx + px * alpha - py * beta
    fy = cy + px * beta + py * alpha
    v = []
    for x, y in zip(fx, fy):
        ix = int(np.rint(x / _XY_ONE)) << _XY_SHIFT
        iy = int(np.rint(y / _XY_ONE)) << _XY_SHIFT
        p = (ix + int(np.rint(x - ix)), iy + int(np.rint(y - iy)))
        if not v or p != v[-1]:
            v.append(p)
    if len(v) == 1:
        v = [(cx, cy)] * 2
    _fill_convex(img, v, col)


def fill_circle(img: np.ndarray, center, radius: int, color) -> None:
    """cv2.circle(img, center, radius, color, -1) of an integer centre and
    radius anywhere, line type 8, bit for bit: cv2's Circle with fill (the
    midpoint walk of _fill_circle), not the ellipse polygon that thicker
    or antialiased circles take."""
    _fill_circle(img, int(center[0]), int(center[1]), int(radius),
                 _colour(img, color))


def polylines(img: np.ndarray, pts: np.ndarray, color,
              thickness: int = 1) -> None:
    """cv2.polylines(img, [pts], True, color, thickness) for one closed
    polygon of integer vertices: each edge as draw_line draws it (thicker
    than 1, cv2 caps only each edge's end, which is the next edge's start:
    the same round caps)."""
    p = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    for a, b in zip(p[-1:] + p[:-1], p):
        draw_line(img, a, b, color, thickness)


def render_scene(
    rng: np.random.RandomState,
    size: int = 768,
    n_objects: int = 24,
    specs: dict = None,
    margin: int = 24,
    color_jitter: float = 14.0,
    noise: float = 12.0,
    pack: float = 0.8,
    n_distractors: int = 0,
    brightness_gradient: bool = False,
):
    """One scene -> (img (size, size, 3) uint8 BGR, objects [{'poly': (8,)
    float64, 'name', 'difficult'}]).

    specs: the classes (default SYNTH_CLASS_SPECS); pack: the
    overlap-rejection factor (lower packs denser); n_distractors:
    unlabelled ellipses, triangles and lines in the classes' colours,
    drawn first so that objects cover them; brightness_gradient: a global
    illumination ramp across the scene."""
    specs = specs or SYNTH_CLASS_SPECS
    names = list(specs)
    # background: low-frequency noise ("terrain") + fine grain
    base = rng.rand(size // 32 + 1, size // 32 + 1, 3).astype(np.float32)
    bg = resize_cubic(base, (size, size))
    img = (40 + 60 * bg + noise * rng.randn(size, size, 3)).astype(
        np.float32)
    if brightness_gradient:
        ang = rng.rand() * 2 * np.pi
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        ramp = (np.cos(ang) * xx + np.sin(ang) * yy)
        img = img * (0.75 + 0.5 * ramp)[..., None]
    img = np.clip(img, 0, 255)

    # unlabelled distractor clutter first, so that objects overdraw it
    for _ in range(n_distractors):
        col_name = names[rng.randint(len(names))]
        base_col = np.asarray(specs[col_name][0], np.float32)
        col = tuple(
            float(np.clip(c + rng.randn() * 25, 0, 255)) for c in base_col
        )
        cx = rng.rand() * size
        cy = rng.rand() * size
        kind = rng.randint(3)
        if kind == 0:  # ellipse
            ax = int(rng.rand() * 20 + 6)
            fill_ellipse(img, (int(cx), int(cy)),
                         (ax, int(ax * (0.4 + rng.rand() * 0.5))),
                         rng.rand() * 180, col)
        elif kind == 1:  # triangle
            pts = (np.stack([[cx, cy]] * 3)
                   + rng.randn(3, 2) * 14).astype(np.int32)
            fill_poly(img, pts, col)
        else:  # line segment (road-like, a bridge confuser)
            d = rng.randn(2)
            d = d / (np.hypot(*d) + 1e-6) * (rng.rand() * 60 + 20)
            draw_line(img, (int(cx - d[0]), int(cy - d[1])),
                      (int(cx + d[0]), int(cy + d[1])), col,
                      int(rng.rand() * 3 + 1))

    objects = []
    placed_polys = []
    tries = 0
    while len(objects) < n_objects and tries < n_objects * 30:
        tries += 1
        name = names[rng.randint(len(names))]
        color, (lmin, lmax), (amin, amax) = specs[name]
        long_e = rng.rand() * (lmax - lmin) + lmin
        aspect = rng.rand() * (amax - amin) + amin
        short_e = long_e / aspect
        angle = rng.rand() * np.pi
        cx = rng.rand() * (size - 2 * margin) + margin
        cy = rng.rand() * (size - 2 * margin) + margin
        poly = _rot_rect_poly(cx, cy, long_e, short_e, angle)
        if poly.min() < 2 or poly.max() > size - 2:
            continue
        # reject heavy centre overlap with an already placed object
        r = long_e / 2 + 6
        ok = True
        for q, qr in placed_polys:
            if np.hypot(*(np.mean(poly, 0) - q)) < pack * (r + qr):
                ok = False
                break
        if not ok:
            continue
        jitter = (rng.randn(3) * color_jitter).astype(np.float32)
        col = tuple(float(np.clip(c + j, 0, 255))
                    for c, j in zip(color, jitter))
        ipoly = np.round(poly).astype(np.int32)
        fill_poly(img, ipoly, col)
        # darker outline so the boundary is crisp at every angle
        polylines(img, ipoly, tuple(c * 0.5 for c in col))
        placed_polys.append((np.mean(poly, 0), r))
        objects.append(dict(poly=poly.reshape(-1).astype(np.float64),
                            name=name, difficult="0"))
    return img.astype(np.uint8), objects


def generate_synth_dota(outdir: str, n_scenes: int, size: int = 768,
                        n_objects: int = 24, seed: int = 0,
                        prefix: str = "S", hard: bool = False,
                        specs: dict | None = None, ext: str = ".npy"):
    """Write n_scenes scenes to outdir/images/<name><ext> (.npy, .png or
    .bmp) and outdir/labelTxt/<name>.txt; returns the scene names.

    hard=True renders the 15-class benchmark (HARD_RENDER_KWARGS: clutter,
    noise, dense packing, a brightness ramp) instead of the easy 6-class
    one; specs, where given, replaces the classes of either (the JAX tool's
    --hrsc scenes pass {"ship": SYNTH_CLASS_SPECS["ship"]})."""
    imgdir = osp.join(outdir, "images")
    labdir = osp.join(outdir, "labelTxt")
    os.makedirs(imgdir, exist_ok=True)
    os.makedirs(labdir, exist_ok=True)
    rng = np.random.RandomState(seed)
    kwargs = dict(HARD_RENDER_KWARGS if hard else {})
    if specs is not None:
        kwargs["specs"] = specs
    names = []
    for i in range(n_scenes):
        name = f"{prefix}{i:04d}"
        img, objs = render_scene(rng, size=size, n_objects=n_objects,
                                 **kwargs)
        image_io.imwrite(osp.join(imgdir, name + ext), img)
        util.write_dota_poly(osp.join(labdir, name + ".txt"), objs)
        names.append(name)
    return names

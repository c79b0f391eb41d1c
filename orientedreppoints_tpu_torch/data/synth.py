"""Synthetic DOTA-style scenes for the closed-loop quality benchmark
(counterpart of data/synth.py, its default "easy" renderer): oriented
coloured rectangles with per-class size, aspect and colour on a textured
background, labelled in DOTA's labelTxt format.

The JAX package draws with cv2, which the port does not use.  Its three
calls are rebuilt here in numpy, vectorised over pixels:

  * cv2.resize(..., INTER_CUBIC) of the float32 background: cv2's
    separable bicubic (A = -0.75, half-pixel centres, replicated borders),
    in float32; its weights are cv2's exactly, its sums may differ from
    cv2's in the last bit of float32;
  * cv2.fillPoly on integer vertices: cv2's scan-line fill in 16.16
    fixed point (FillEdgeCollection); cv2 also draws the outline in the
    fill colour, which the polylines drawn next cover;
  * cv2.polylines(..., thickness 1): cv2's 8-connected Bresenham line,
    drawn from the left end point.

The random stream is drawn in the reference's order, so polygons, names
and labels are the reference's exactly; a pixel differs from cv2's only
where the background's last-bit difference crosses a grey level (about
1 in 50,000 pixels, by 1).  Images are written as .npy (BGR uint8, as
cv2 stores them).
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from ..devkit import dota_utils as util

# name -> (BGR colour, (min_long, max_long), (min_aspect, max_aspect))
SYNTH_CLASS_SPECS = {
    "plane": ((60, 60, 230), (44, 64), (1.0, 1.3)),
    "bridge": ((160, 160, 160), (90, 150), (5.0, 8.0)),
    "small-vehicle": ((230, 120, 40), (16, 26), (1.8, 2.4)),
    "large-vehicle": ((40, 200, 230), (34, 52), (2.2, 3.0)),
    "ship": ((230, 220, 80), (44, 76), (2.8, 3.6)),
    "storage-tank": ((240, 240, 240), (26, 42), (1.0, 1.15)),
}

_XY_SHIFT = 16  # cv2's fixed-point fraction bits in the polygon fill
_XY_ONE = 1 << _XY_SHIFT


def _rot_rect_poly(cx, cy, w, h, angle):
    c, s = np.cos(angle), np.sin(angle)
    corners = np.array(
        [[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]]
    )
    return corners @ np.array([[c, s], [-s, c]]) + [cx, cy]


def _cubic_taps(n_in: int, n_out: int):
    """cv2's INTER_CUBIC taps along one axis: (4, n_out) source indices,
    clamped (replicated border), and (4, n_out) float32 weights."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    x = (f - s).astype(np.float32)
    a = np.float32(-0.75)
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    c3 = np.float32(1) - c0 - c1 - c2
    idx = np.clip(s.astype(np.int64)[None] + np.arange(-1, 3)[:, None], 0,
                  n_in - 1)
    return idx, np.stack([c0, c1, c2, c3])


def resize_cubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W, C) float32 -> (h, w, C) float32, as cv2.resize(img, (w, h),
    interpolation=cv2.INTER_CUBIC): along each row first, then between
    rows, each a float32 sum of four products in tap order."""
    h, w = size
    x = np.asarray(img, np.float32)
    idx, c = _cubic_taps(x.shape[1], w)
    t = x[:, idx[0]] * c[0][:, None]
    for k in range(1, 4):
        t = t + x[:, idx[k]] * c[k][:, None]
    idx, c = _cubic_taps(x.shape[0], h)
    out = t[idx[0]] * c[0][:, None, None]
    for k in range(1, 4):
        out = out + t[idx[k]] * c[k][:, None, None]
    return out


def fill_poly(img: np.ndarray, pts: np.ndarray, color) -> None:
    """cv2.fillPoly(img, [pts], color) for one polygon of integer vertices
    (the scan-line fill; its outline is what polylines draws): each edge
    is x0 + (y - y0) * dx in 16.16 fixed point with dx truncated, active
    on rows y0 <= y < y1; on each row the sorted crossings pair up and
    pixels ceil(left) .. floor(right) are set (centres inside)."""
    p = np.asarray(pts, np.int64).reshape(-1, 2)
    p0, p1 = np.roll(p, 1, axis=0), p
    keep = p0[:, 1] != p1[:, 1]
    p0, p1 = p0[keep], p1[keep]
    if len(p0) < 2:
        return
    down = p0[:, 1] < p1[:, 1]
    top = np.where(down[:, None], p0, p1)
    y1 = np.where(down, p1[:, 1], p0[:, 1])
    num = (p1[:, 0] - p0[:, 0]) << _XY_SHIFT
    den = p1[:, 1] - p0[:, 1]
    dx = np.abs(num) // np.abs(den) * np.sign(num) * np.sign(den)  # C '/'
    ys = np.arange(max(int(top[:, 1].min()), 0),
                   min(int(y1.max()), img.shape[0]))
    if len(ys) == 0:
        return
    active = (ys[:, None] >= top[None, :, 1]) & (ys[:, None] < y1[None])
    xs = (top[None, :, 0] << _XY_SHIFT) + (ys[:, None] - top[None, :, 1]) * dx
    xs = np.sort(np.where(active, xs, np.iinfo(np.int64).max), axis=1)
    cols = np.arange(img.shape[1])
    inside = np.zeros((len(ys), img.shape[1]), bool)
    for k in range(0, xs.shape[1] - 1, 2):
        pair = xs[:, k + 1] != np.iinfo(np.int64).max
        lo = np.where(pair, (xs[:, k] + _XY_ONE - 1) >> _XY_SHIFT, 1)
        hi = np.where(pair, xs[:, k + 1] >> _XY_SHIFT, 0)
        inside |= (cols[None] >= lo[:, None]) & (cols[None] <= hi[:, None])
    rows, cs = np.nonzero(inside)
    img[ys[rows], cs] = np.asarray(color, np.float32)


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


def polylines(img: np.ndarray, pts: np.ndarray, color) -> None:
    """cv2.polylines(img, [pts], True, color, 1) for one closed polygon of
    integer vertices inside the image."""
    p = np.asarray(pts, np.int64).reshape(-1, 2)
    col = np.asarray(color, np.float32)
    for a, b in zip(np.roll(p, 1, axis=0), p):
        ys, xs = line_pixels(a, b)
        img[ys, xs] = col


def render_scene(rng: np.random.RandomState, size: int = 768,
                 n_objects: int = 24, margin: int = 24,
                 color_jitter: float = 14.0, noise: float = 12.0,
                 pack: float = 0.8):
    """One scene -> (img (size, size, 3) uint8 BGR, objects [{'poly': (8,)
    float64, 'name', 'difficult'}]).  pack: the overlap-rejection factor
    (lower packs denser)."""
    specs = SYNTH_CLASS_SPECS
    names = list(specs)
    # background: low-frequency noise ("terrain") + fine grain
    base = rng.rand(size // 32 + 1, size // 32 + 1, 3).astype(np.float32)
    bg = resize_cubic(base, (size, size))
    img = (40 + 60 * bg + noise * rng.randn(size, size, 3)).astype(
        np.float32)
    img = np.clip(img, 0, 255)

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
                        prefix: str = "S", hard: bool = False):
    """Write n_scenes scenes to outdir/images/<name>.npy and
    outdir/labelTxt/<name>.txt; returns the scene names.  hard=True (the
    15-class benchmark with clutter and a brightness ramp) is not ported."""
    if hard:
        raise NotImplementedError(
            "the hard synthetic benchmark (distractor clutter, brightness "
            "ramp) is not ported; only the default 6-class scenes are")
    imgdir = osp.join(outdir, "images")
    labdir = osp.join(outdir, "labelTxt")
    os.makedirs(imgdir, exist_ok=True)
    os.makedirs(labdir, exist_ok=True)
    rng = np.random.RandomState(seed)
    names = []
    for i in range(n_scenes):
        name = f"{prefix}{i:04d}"
        img, objs = render_scene(rng, size=size, n_objects=n_objects)
        np.save(osp.join(imgdir, name + ".npy"), img)
        util.write_dota_poly(osp.join(labdir, name + ".txt"), objs)
        names.append(name)
    return names

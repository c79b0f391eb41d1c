"""OpenCV 5.0's calls that the image corruptions make, rebuilt on numpy
and CPU tensors (cv2 is not a dependency of the port):

  * get_structuring_element_ellipse: cv2.getStructuringElement(
    MORPH_ELLIPSE, ksize), at even sizes too;
  * filter2d: cv2.filter2D(img, -1, kernel) of a uint8 image with a
    float32 kernel, the anchor at (kw // 2, kh // 2), BORDER_REFLECT_101;
  * resize_area: cv2.resize(img, dsize, interpolation=INTER_AREA) when it
    shrinks; resize_nearest: cv2.resize(..., INTER_NEAREST).

cv2's arithmetic, found against cv2 5.0 on seeded images
(tests/test_torch_corruptions.py):

  * filter2D keeps the kernel's nonzero taps in row-major order and sums
    them per value as a chain of float32 fused multiply-adds from 0
    (FilterVec_8u's v_muladd; its scalar tail contracts to the same fma),
    then rounds half to even and saturates.  The chain is bit for bit
    cv2's below 130 taps (every defocus_blur kernel, motion_blur at sizes
    5, 7 and 9).  A kernel of kw * kh >= 130 taps (motion_blur at 13 and
    17) takes cv2's DFT path instead (crossCorr in float32), whose
    rounding this chain does not copy: on a 512^2 BGR image ~1e-5 of the
    values come out one grey level apart (the tests bound it).
  * INTER_AREA at a non-integer scale is the generic area table: per
    output column its source columns with float32 weights
    ((sx1 - fsx1) / cellWidth, 1 / cellWidth, ...; computed in double,
    cell widths from scale = 1 / (dw / sw)), each row summed in float32 in
    table order without fma, then the rows weighted and summed the same
    way, rint and saturate.  An exact 2x shrink takes the fast path,
    (a + b + c + d + 2) >> 2; other integer scales the scalar loop,
    rint(float(sum) * (1 / area)).
  * INTER_NEAREST takes source index min(floor(x * (1 / (dw / sw))),
    sw - 1) along each axis.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .warp import fma32


def _ksize(ksize) -> tuple[int, int]:
    """(width, height) of an int or a pair."""
    if np.isscalar(ksize):
        return int(ksize), int(ksize)
    w, h = ksize
    return int(w), int(h)


def get_structuring_element_ellipse(ksize) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, ksize): (h, w) uint8 of 0 /
    1; ksize is an int or (width, height)."""
    w, h = _ksize(ksize)
    if (w, h) == (1, 1):
        return np.ones((1, 1), np.uint8)
    r, c = h // 2, w // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    out = np.zeros((h, w), np.uint8)
    for i in range(h):
        dy = i - r
        if abs(dy) <= r:
            # saturate_cast<int>(double): round half to even
            dx = int(np.rint(c * math.sqrt((r * r - dy * dy) * inv_r2)))
            out[i, max(c - dx, 0):min(c + dx + 1, w)] = 1
    return out


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """cv2.filter2D(img, -1, kernel) of an (h, w[, c]) uint8 image with a
    float32 kernel (ddepth -1, anchor at the kernel's centre
    (kw // 2, kh // 2), delta 0, BORDER_REFLECT_101)."""
    if img.dtype != np.uint8:
        raise TypeError(f"a uint8 image, not {img.dtype}")
    k = np.asarray(kernel, np.float32)
    if k.ndim != 2:
        raise ValueError(f"a 2-D kernel, not {k.shape}")
    kh, kw = k.shape
    ay, ax = kh // 2, kw // 2
    h, w = img.shape[:2]
    pad = [(ay, kh - 1 - ay), (ax, kw - 1 - ax)] + [(0, 0)] * (img.ndim - 2)
    if min(h, w) < 2 and (kh > 1 or kw > 1):
        raise ValueError("BORDER_REFLECT_101 needs 2 pixels a side")
    src = torch.from_numpy(np.pad(img, pad, mode="reflect")).double()
    acc = torch.zeros(img.shape, dtype=torch.float32)
    for i, j in zip(*np.nonzero(k)):  # row-major
        acc = fma32(src[i:i + h, j:j + w], torch.tensor(k[i, j]), acc)
    return torch.round(acc).clamp_(0, 255).to(torch.uint8).numpy()


def _area_table(ssize: int, dsize: int, scale: float):
    """cv2's computeResizeAreaTab: (dst index, src index, float32 weight)
    entries, grouped by dst index in order."""
    tab = []
    for d in range(dsize):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, ssize - fs1)
        s2 = min(math.floor(fs2), ssize - 1)
        s1 = min(math.ceil(fs1), s2)
        if s1 - fs1 > 1e-3:
            tab.append((d, s1 - 1, np.float32((s1 - fs1) / cell)))
        for s in range(s1, s2):
            tab.append((d, s, np.float32(1.0 / cell)))
        if fs2 - s2 > 1e-3:
            tab.append((d, s2, np.float32(min(min(fs2 - s2, 1.0), cell)
                                          / cell)))
    return tab


def _weighted_sums(src: np.ndarray, tab, dsize: int, axis: int):
    """Per dst index the float32 sum of its entries' src[index] * weight
    along axis, added in table order (a product, then each sum rounded)."""
    by_dst: list[list] = [[] for _ in range(dsize)]
    for d, s, a in tab:
        by_dst[d].append((s, a))
    n = max(len(e) for e in by_dst)
    shape = list(src.shape)
    shape[axis] = dsize
    out = np.zeros(shape, np.float32)
    for k in range(n):
        dst = [d for d in range(dsize) if len(by_dst[d]) > k]
        idx = [by_dst[d][k][0] for d in dst]
        wts = np.array([by_dst[d][k][1] for d in dst], np.float32)
        wshape = [1] * src.ndim
        wshape[axis] = len(dst)
        term = np.take(src, idx, axis=axis) * wts.reshape(wshape)
        sel = [slice(None)] * src.ndim
        sel[axis] = dst
        out[tuple(sel)] += term
    return out


def resize_area(img: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(img, dsize, interpolation=cv2.INTER_AREA) of an (h, w[,
    c]) uint8 image to dsize = (width, height), no larger than img."""
    if img.dtype != np.uint8:
        raise TypeError(f"a uint8 image, not {img.dtype}")
    sh, sw = img.shape[:2]
    dw, dh = (int(v) for v in dsize)
    if dw > sw or dh > sh or dw < 1 or dh < 1:
        raise ValueError(f"INTER_AREA shrinks here: {(sw, sh)} -> {dsize}")
    if (dw, dh) == (sw, sh):
        return img.copy()
    scale_x, scale_y = 1.0 / (dw / sw), 1.0 / (dh / sh)
    ix, iy = round(scale_x), round(scale_y)
    eps = np.finfo(np.float64).eps
    if abs(scale_x - ix) < eps and abs(scale_y - iy) < eps:
        cn = img.shape[2:]
        blocks = img.reshape(dh, iy, dw, ix, *cn).astype(np.int64).sum((1, 3))
        if (ix, iy) == (2, 2) and (not cn or cn[0] in (1, 3, 4)):
            return ((blocks + 2) >> 2).astype(np.uint8)
        scaled = blocks.astype(np.float32) * np.float32(1.0 / (ix * iy))
        return np.clip(np.rint(scaled), 0, 255).astype(np.uint8)
    rows = _weighted_sums(img.astype(np.float32),
                          _area_table(sw, dw, scale_x), dw, 1)
    out = _weighted_sums(rows, _area_table(sh, dh, scale_y), dh, 0)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_nearest(img: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(img, dsize, interpolation=cv2.INTER_NEAREST) to dsize =
    (width, height)."""
    sh, sw = img.shape[:2]
    dw, dh = (int(v) for v in dsize)
    xs = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / sw))), sw - 1)
    ys = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / sh))), sh - 1)
    return img[ys.astype(np.int64)][:, xs.astype(np.int64)]

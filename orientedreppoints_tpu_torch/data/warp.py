"""OpenCV 5.0's geometric warps of a uint8 BGR image, rebuilt on CPU
tensors for the hard-aug transforms (cv2 is not a dependency of the port).

  * get_rotation_matrix_2d: cv2.getRotationMatrix2D in double with libm's
    cos / sin (math.cos, not np.cos: one ulp in the matrix can move a
    float32 coordinate across a pixel);
  * invert_affine: cv2.invertAffineTransform, which warp_affine applies to
    its matrix as cv2.warpAffine does; invert_perspective: cv2.invert's
    3 x 3 cofactor form, for warp_perspective;
  * warp_affine / warp_perspective: INTER_LINEAR with BORDER_CONSTANT on
    an (h, w, 3) uint8 image, as cv2 5.0 computes them (the float32 path
    of OpenCV 4.11+, not the old INTER_BITS fixed-point tables);
    warp_affine also of an (h, w) float32 image (motion_blur's kernel).

cv2's arithmetic, found against cv2 5.0 on seeded images and matrices
(tests/test_torch_aug.py, bit for bit): the inverse matrix is rounded to
float32 once.  Output columns come in blocks of 16 (the vector loop) and
a scalar tail of w % 16 columns, which form the source coordinate
differently:

  vector:  sx = fma(M0, x, y * M1 + M2)       (y * M1 + M2 unfused)
  tail:    sx = fma(x, M0, y * M1) + M2

(the perspective warp forms X, Y and W so, then sx = X / W, sy = Y / W).
Then fx = floor(sx), a = sx - fx, and each tap outside the image takes
the border value; the two lerps along x and one along y are fused,
v = fma(a, p01 - p00, p00), and the result is rint'ed and saturated (a
float32 image keeps v as it is).

A fused multiply-add is emulated in float64 (the product of two float32
values is exact there) and rounded to float32; where the float64 sum sits
exactly on a float32 rounding midpoint, the sum's own rounding error
decides the direction, so every fma is rounded once, as the hardware's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_F32 = torch.float32
# low 29 bits of a float64 that lies halfway between two float32 values
_MID_MASK = (1 << 29) - 1
_MID = 1 << 28
_BLOCK = 16  # cv2's vector loop: columns a step


def get_rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """(2, 3) float64: rotation by angle degrees (counter-clockwise) about
    center, scaled, as cv2.getRotationMatrix2D (its center is a Point2f)."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * (math.pi / 180)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(M) -> np.ndarray:
    """cv2.invertAffineTransform of a (2, 3) matrix, in double."""
    m = np.asarray(M, np.float64).reshape(6)
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[4] * d, m[0] * d, -m[1] * d, -m[3] * d
    return np.array([[a11, a12, -a11 * m[2] - a12 * m[5]],
                     [a21, a22, -a21 * m[2] - a22 * m[5]]])


def invert_perspective(M) -> np.ndarray:
    """cv2.invert of a (3, 3) matrix (DECOMP_LU's 3 x 3 cofactor form),
    in double; a singular matrix gives zeros."""
    s = np.asarray(M, np.float64).reshape(3, 3)
    det = (s[0, 0] * (s[1, 1] * s[2, 2] - s[1, 2] * s[2, 1])
           - s[0, 1] * (s[1, 0] * s[2, 2] - s[1, 2] * s[2, 0])
           + s[0, 2] * (s[1, 0] * s[2, 1] - s[1, 1] * s[2, 0]))
    if det == 0:
        return np.zeros((3, 3))
    d = 1.0 / det

    def cof(i, j, k, l, m, n, o, p):
        return (s[i, j] * s[k, l] - s[m, n] * s[o, p]) * d

    return np.array([
        [cof(1, 1, 2, 2, 1, 2, 2, 1), cof(0, 2, 2, 1, 0, 1, 2, 2),
         cof(0, 1, 1, 2, 0, 2, 1, 1)],
        [cof(1, 2, 2, 0, 1, 0, 2, 2), cof(0, 0, 2, 2, 0, 2, 2, 0),
         cof(0, 2, 1, 0, 0, 0, 1, 2)],
        [cof(1, 0, 2, 1, 1, 1, 2, 0), cof(0, 1, 2, 0, 0, 0, 2, 1),
         cof(0, 0, 1, 1, 0, 1, 1, 0)]])


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once (a, b, c float32, broadcast)."""
    p = a.double() * b.double()
    r = p + c.double()
    out = r.float()
    mid = torch.nonzero((r.view(torch.int64) & _MID_MASK) == _MID,
                        as_tuple=True)
    if mid[0].numel():
        # r is a float32 midpoint: round toward the exact sum, which
        # r's rounding error (TwoSum) places above or below it
        pm = p.expand_as(r)[mid]
        cm = c.double().expand_as(r)[mid]
        rm = r[mid]
        bb = rm - pm
        err = (pm - (rm - bb)) + (cm - bb)
        o = out[mid]
        od = o.double()
        o = torch.where((err > 0) & (od < rm),
                        torch.nextafter(o, torch.tensor(math.inf)), o)
        o = torch.where((err < 0) & (od > rm),
                        torch.nextafter(o, torch.tensor(-math.inf)), o)
        out[mid] = o
    return out


def _scalar(v) -> torch.Tensor:
    return torch.tensor(float(v), dtype=_F32)


def _coords(m: np.ndarray, w_out: int, h_out: int):
    """Source coordinates (sx, sy) of every output pixel, float32 (h, w),
    for the float32 inverse m (2 or 3 rows)."""
    m = [_scalar(v) for v in m.reshape(-1)]
    y = torch.arange(h_out, dtype=_F32)[:, None]
    x = torch.arange(w_out, dtype=_F32)[None, :]
    nv = w_out - w_out % _BLOCK
    rows = []
    for r in range(len(m) // 3):
        m0, m1, m2 = m[3 * r:3 * r + 3]
        out = torch.empty((h_out, w_out), dtype=_F32)
        out[:, :nv] = fma32(m0, x[:, :nv], y * m1 + m2)
        out[:, nv:] = fma32(x[:, nv:], m0, y * m1) + m2
        rows.append(out)
    if len(rows) == 3:
        return rows[0] / rows[2], rows[1] / rows[2]
    return rows[0], rows[1]


def _lerp_fits_float64(sx: torch.Tensor) -> bool:
    """Whether float64 holds every lerp a * (p01 - p00) + p00 exactly, so
    that one rounding to float32 is the fused multiply-add's: a is a
    multiple of ulp(sx), and unless some 0 < sx < 2^-20 the sum needs at
    most 52 bits.  Else the lerp takes the slower fma32
    (tools/time_torch_warp.py times the two)."""
    return not bool(((sx > 0) & (sx < 2.0 ** -20)).any())


def _remap(img: np.ndarray, sx: torch.Tensor, sy: torch.Tensor,
           border_value) -> np.ndarray:
    """Bilinear samples of img at (sx, sy), taps outside the image set to
    the border value; uint8 (h_out, w_out, 3)."""
    h, w = img.shape[:2]
    h_out, w_out = sx.shape
    bad = ~(torch.isfinite(sx) & torch.isfinite(sy))
    if bad.any():  # cv2's int conversion of these lands off the image
        sx = sx.masked_fill(bad, -2.0)
        sy = sy.masked_fill(bad, -2.0)
    fx, fy = torch.floor(sx), torch.floor(sy)
    a = sx - fx
    b = sy - fy
    # taps index a copy of the image framed by one border pixel, viewed
    # as one int32 a pixel (B, G, R, pad)
    x0 = fx.clamp(-1, w).long() + 1
    x1 = (fx + 1).clamp(-1, w).long() + 1
    y0 = (fy.clamp(-1, h).long() + 1) * (w + 2)
    y1 = ((fy + 1).clamp(-1, h).long() + 1) * (w + 2)
    # a scalar or a (B, G, R[, A]) tuple, saturated to uint8 as cv2's
    border = np.zeros(4, np.uint8)
    border[:3] = np.clip(np.rint(np.resize(
        np.asarray(border_value, np.float64), 3)), 0, 255)
    framed = torch.from_numpy(border).repeat((h + 2) * (w + 2)).view(
        h + 2, w + 2, 4)
    framed[1:-1, 1:-1, :3] = torch.from_numpy(img)
    flat = framed.view(-1).view(torch.int32)

    def tap(yy, xx):  # (3, h_out, w_out) uint8
        return (flat.take(yy + xx).view(torch.uint8)
                .reshape(h_out, w_out, 4).permute(2, 0, 1)[:3])

    exact = _lerp_fits_float64(sx)
    a64 = a.double()

    def lerp_x(q0, q1):
        d = q1.float() - q0.float()
        if exact:
            return (a64 * d + q0).float()
        return fma32(a, d, q0.float())

    v0 = lerp_x(tap(y0, x0), tap(y0, x1))
    v1 = lerp_x(tap(y1, x0), tap(y1, x1))
    v = fma32(b, v1 - v0, v0)
    return (torch.round(v).clamp_(0, 255).to(torch.uint8)
            .permute(1, 2, 0).contiguous().numpy())


def _check(img: np.ndarray):
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise TypeError(f"a (h, w, 3) uint8 image, not {img.dtype} "
                        f"{img.shape}")


def _remap_float(img: np.ndarray, sx: torch.Tensor, sy: torch.Tensor,
                 border_value) -> np.ndarray:
    """Bilinear samples of an (h, w) float32 image at (sx, sy), taps
    outside the image set to the border value, unrounded."""
    h, w = img.shape
    fx, fy = torch.floor(sx), torch.floor(sy)
    a, b = sx - fx, sy - fy
    framed = torch.full((h + 2, w + 2), float(border_value), dtype=_F32)
    framed[1:-1, 1:-1] = torch.from_numpy(img)
    flat = framed.view(-1)

    def tap(yy, xx):
        return flat.take((yy.clamp(-1, h).long() + 1) * (w + 2)
                         + xx.clamp(-1, w).long() + 1)

    v0 = fma32(a, tap(fy, fx + 1) - tap(fy, fx), tap(fy, fx))
    v1 = fma32(a, tap(fy + 1, fx + 1) - tap(fy + 1, fx), tap(fy + 1, fx))
    return fma32(b, v1 - v0, v0).numpy()


def warp_affine(img: np.ndarray, M, dsize, border_value=0) -> np.ndarray:
    """cv2.warpAffine(img, M, dsize, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=border_value) of an (h, w, 3)
    uint8 image or an (h, w) float32 one; dsize is (width, height)."""
    flt = img.dtype == np.float32 and img.ndim == 2
    if not flt:
        _check(img)
    w_out, h_out = (int(v) for v in dsize)
    m = invert_affine(M).astype(np.float32)
    if (np.array_equal(m, np.eye(2, 3, dtype=np.float32))
            and (h_out, w_out) == img.shape[:2]):
        return img.copy()  # every pixel samples itself with weight 0 aside
    sx, sy = _coords(m, w_out, h_out)
    if flt:
        return _remap_float(img, sx, sy, border_value)
    return _remap(img, sx, sy, border_value)


def warp_perspective(img: np.ndarray, M, dsize,
                     border_value=0) -> np.ndarray:
    """cv2.warpPerspective(img, M, dsize, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=border_value) of an (h, w, 3)
    uint8 image; dsize is (width, height)."""
    _check(img)
    w_out, h_out = (int(v) for v in dsize)
    sx, sy = _coords(invert_perspective(M).astype(np.float32), w_out, h_out)
    return _remap(img, sx, sy, border_value)

"""The image corruptions of the robustness benchmark (counterpart of
data/corruptions.py, after the `imagecorruptions` package): nine
corruptions, each at severity 1..5, of a uint8 BGR image.

Each makes the same np.random calls in the same order as its JAX
counterpart (rng, or the global np.random when rng is None), and keeps
its dtype steps (float32 or float64 sums, the clip, then astype(uint8)'s
truncation).  The cv2 calls are rebuilt in data/filter.py
(getStructuringElement, filter2D, INTER_AREA and INTER_NEAREST resizes),
data/warp.py (warpAffine of motion_blur's float32 kernel) and
data/jpeg.py (libjpeg-turbo's round trip), bit for bit except
filter2D's DFT path: motion_blur at severity 4 and 5 (kernels of 13^2
and 17^2 taps), where ~1e-5 of the values land one grey level off cv2's
(tests/test_torch_corruptions.py bounds them).
"""

from __future__ import annotations

import numpy as np

from . import filter as cvf
from . import jpeg, warp


def _sev(severity, values):
    return values[int(np.clip(severity, 1, 5)) - 1]


def gaussian_noise(img, severity=1, rng=None):
    rng = rng or np.random
    c = _sev(severity, [0.04, 0.06, 0.08, 0.09, 0.10]) * 255
    out = img.astype(np.float32) + rng.normal(0, c, img.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def shot_noise(img, severity=1, rng=None):
    rng = rng or np.random
    c = _sev(severity, [500, 250, 100, 75, 50])
    out = rng.poisson(img.astype(np.float64) / 255.0 * c) / c * 255
    return np.clip(out, 0, 255).astype(np.uint8)


def impulse_noise(img, severity=1, rng=None):
    rng = rng or np.random
    c = _sev(severity, [0.01, 0.02, 0.03, 0.05, 0.07])
    out = img.copy()
    mask = rng.rand(*img.shape[:2]) < c
    salt = rng.rand(*img.shape[:2]) < 0.5
    out[mask & salt] = 255
    out[mask & ~salt] = 0
    return out


def defocus_blur(img, severity=1, rng=None):
    c = _sev(severity, [3, 4, 6, 8, 10])
    k = cvf.get_structuring_element_ellipse(c).astype(np.float32)
    k /= k.sum()
    return cvf.filter2d(img, k)


def motion_blur(img, severity=1, rng=None):
    c = _sev(severity, [5, 7, 9, 13, 17])
    k = np.zeros((c, c), np.float32)
    k[c // 2] = 1.0 / c
    ang = (rng or np.random).uniform(-45, 45)
    m = warp.get_rotation_matrix_2d((c / 2 - 0.5, c / 2 - 0.5), ang, 1)
    k = warp.warp_affine(k, m, (c, c))
    k /= max(k.sum(), 1e-6)
    return cvf.filter2d(img, k)


def brightness(img, severity=1, rng=None):
    c = _sev(severity, [0.1, 0.2, 0.3, 0.4, 0.5]) * 255
    return np.clip(img.astype(np.float32) + c, 0, 255).astype(np.uint8)


def contrast(img, severity=1, rng=None):
    c = _sev(severity, [0.75, 0.5, 0.4, 0.3, 0.15])
    mean = img.mean(axis=(0, 1), keepdims=True)
    return np.clip((img - mean) * c + mean, 0, 255).astype(np.uint8)


def jpeg_compression(img, severity=1, rng=None):
    c = _sev(severity, [80, 65, 58, 50, 40])
    return jpeg.round_trip(img, int(c))


def pixelate(img, severity=1, rng=None):
    c = _sev(severity, [0.9, 0.8, 0.7, 0.6, 0.5])
    h, w = img.shape[:2]
    small = cvf.resize_area(img, (max(int(w * c), 1), max(int(h * c), 1)))
    return cvf.resize_nearest(small, (w, h))


CORRUPTIONS = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "defocus_blur": defocus_blur,
    "motion_blur": motion_blur,
    "brightness": brightness,
    "contrast": contrast,
    "jpeg_compression": jpeg_compression,
    "pixelate": pixelate,
}


def corrupt(img, corruption: str, severity: int = 1, rng=None):
    """img (uint8 BGR) under corruption at severity (1..5; clipped)."""
    return CORRUPTIONS[corruption](img, severity, rng)

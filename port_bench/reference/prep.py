"""The serving input path: a uint8 BGR image rescaled to fit the test
scale (cv2.resize INTER_LINEAR in its uint8 fixed-point form), normalized
((x - mean) / std after BGR -> RGB) and pasted at the top left of a zero
canvas."""

from __future__ import annotations

import numpy as np
import torch


def rescale_size(h: int, w: int, scale) -> tuple[int, int, float]:
    long_edge, short_edge = max(scale), min(scale)
    factor = min(long_edge / max(h, w), short_edge / min(h, w))
    return int(h * factor + 0.5), int(w * factor + 0.5), factor


def _taps(n_in: int, n_out: int, clamp: bool):
    """Source indices and 11-bit weights of each output index: half-pixel
    centres, the position rounded to float32; clamp: an output beyond the
    first or last source pixel takes that pixel alone."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp:
        f[(s < 0) | (s >= n_in - 1)] = 0.0
    c0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    c1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return (np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), c0, c1)


def resize_uint8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8: rows by 11-bit weights, then
    columns by cv2's rounding (((a >> 4) b0 >> 16) + ((c >> 4) b1 >> 16)
    + 2) >> 2."""
    x = img.astype(np.int64)
    s0, s1, c0, c1 = _taps(x.shape[1], w, True)
    x = x[:, s0] * c0[:, None] + x[:, s1] * c1[:, None]
    r0, r1, b0, b1 = _taps(x.shape[0], h, False)
    y = (((x[r0] >> 4) * b0[:, None, None]) >> 16) + \
        (((x[r1] >> 4) * b1[:, None, None]) >> 16)
    return np.clip((y + 2) >> 2, 0, 255).astype(np.uint8)


def canvas(img_bgr: np.ndarray, scale, mean, std, size) -> tuple:
    """One image -> (canvas (H, W, 3) float32 tensor, scale factor)."""
    h, w = img_bgr.shape[:2]
    nh, nw, factor = rescale_size(h, w, scale)
    img = img_bgr if (nh, nw) == (h, w) else resize_uint8(img_bgr, nh, nw)
    x = torch.from_numpy(img[..., ::-1].astype(np.float32))
    x = (x - torch.tensor(mean, dtype=torch.float32)) / torch.tensor(
        std, dtype=torch.float32)
    out = torch.zeros(tuple(size) + (3,), dtype=torch.float32)
    out[:nh, :nw] = x
    return out, float(factor)

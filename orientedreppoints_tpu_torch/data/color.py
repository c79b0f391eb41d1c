"""OpenCV 5.0's uint8 BGR <-> HSV conversions (hue in [0, 180)), rebuilt on
CPU tensors for HSVAugment (cv2 is not a dependency of the port).

  * bgr_to_hsv: cv2.cvtColor(img, COLOR_BGR2HSV), OpenCV's integer path:
    hsv_shift 12, s = (diff * sdiv[v] + 2^11) >> 12 with
    sdiv[i] = round((255 << 12) / i), h from the sector of the largest
    channel times hdiv[diff] = round((180 << 12) / (6 diff)), then
    h += 180 where h < 0;
  * hsv_to_bgr: cv2.cvtColor(img, COLOR_HSV2BGR) in float32.  h * (6 /
    180), s / 255 and v / 255 as products with the float32 constants; the
    table v, v (1 - s), v (1 - s f), v (1 - s (1 - f)) with 1 - s f
    fused (one rounding); then * 255.  Each row's columns come in blocks
    of 32 (the vector loop: sector = trunc(h) mod 6, the result
    truncated) and a scalar tail of w % 32 columns (sector = floor(fmod(h,
    6)), the result rounded to nearest);
  * apply_lut: cv2.LUT, one 256-entry table a channel.

Both conversions equal cv2 5.0 on every input (tests/test_torch_aug.py:
all 2^24 BGR triples, all 2^24 HSV triples).
"""

from __future__ import annotations

import numpy as np
import torch

_SHIFT = 12
_i = np.arange(1, 256, dtype=np.float64)
_SDIV = np.zeros(256, np.int32)
_SDIV[1:] = np.rint((255 << _SHIFT) / _i)
_HDIV = np.zeros(256, np.int32)
_HDIV[1:] = np.rint((180 << _SHIFT) / (6.0 * _i))
# the table entries (v, v(1-s), v(1-sf), v(1-s(1-f))) that give B, G, R
# in each hue sector
_SECTORS = torch.tensor([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                         [0, 1, 3], [2, 1, 0]])
_BLOCK = 32  # cv2's vector loop: pixels a step


def _check(img: np.ndarray):
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise TypeError(f"a (h, w, 3) uint8 image, not {img.dtype} "
                        f"{img.shape}")


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """(h, w, 3) uint8 BGR -> uint8 HSV, hue in [0, 180)."""
    _check(img)
    x = torch.from_numpy(img).permute(2, 0, 1).int()
    b, g, r = x
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    half = 1 << (_SHIFT - 1)
    s = (diff * torch.from_numpy(_SDIV)[v] + half) >> _SHIFT
    h = torch.where(v == r, g - b,
                    torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * torch.from_numpy(_HDIV)[diff] + half) >> _SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], -1).to(torch.uint8).numpy()


def _one_minus_fused(s: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """float32 1 - s * f rounded once.  s is k / 255 (k < 256) and f a
    fraction of h * (6 / 180) (h < 256): on this domain the float64 value
    is exact or misses no float32 midpoint (every input is tested)."""
    return (1.0 - s.double() * f.double()).float()


def hsv_to_bgr(img: np.ndarray) -> np.ndarray:
    """(h, w, 3) uint8 HSV (hue in [0, 180); larger hues wrap as cv2's)
    -> uint8 BGR."""
    _check(img)
    x = torch.from_numpy(img).permute(2, 0, 1).float()
    h = x[0] * (torch.tensor(6.0) / torch.tensor(180.0))
    s = x[1] * torch.tensor(1 / 255, dtype=torch.float32)
    v = x[2] * torch.tensor(1 / 255, dtype=torch.float32)
    one = torch.tensor(1.0)
    nv = img.shape[1] - img.shape[1] % _BLOCK
    out = torch.empty(img.shape, dtype=torch.uint8)
    for cols, vector in ((slice(0, nv), True), (slice(nv, None), False)):
        hh, ss, vv = h[:, cols], s[:, cols], v[:, cols]
        if hh.numel() == 0:
            continue
        if vector:
            pre = torch.trunc(hh)
            frac = hh - pre
            sector = pre - torch.trunc(pre * torch.tensor(1 / 6)) * 6
        else:
            hh = torch.fmod(hh, 6)
            sector = torch.floor(hh)
            frac = hh - sector
        tab = torch.stack([vv, vv * (one - ss), vv * _one_minus_fused(ss, frac),
                           vv * _one_minus_fused(ss, one - frac)], -1)
        bgr = torch.gather(tab, -1, _SECTORS[sector.long()]) * 255
        bgr = torch.trunc(bgr) if vector else torch.round(bgr)
        out[:, cols] = bgr.to(torch.uint8)
    return out.numpy()


def apply_lut(img: np.ndarray, luts) -> np.ndarray:
    """cv2.LUT per channel: channel k of the output is luts[k][img[..., k]]
    (each lut 256 uint8 entries)."""
    out = np.empty_like(img)
    for k, lut in enumerate(luts):
        out[..., k] = np.asarray(lut)[img[..., k]]
    return out

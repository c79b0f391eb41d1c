"""Host-side helpers of the serving path, free of JAX and cv2.

Counterparts of:
  * ``utils/config.py::Config.fromfile`` — python-file configs;
  * ``data/pipelines.py::imrescale`` / ``RotateResize(keep_ratio=True)`` —
    the same size and factor arithmetic, and cv2.resize's INTER_LINEAR on a
    uint8 image in its own fixed-point arithmetic, on the tensor's device;
  * ``data/pipelines.py::Normalize`` — BGR->RGB, then (x - mean) / std;
  * the TTA scale canvases of ``apis.py::run_inference_tta`` — ``ceil32``
    and ``cv2.resize(canvas, (w, h), interpolation=cv2.INTER_LINEAR)`` on a
    float canvas, as ``resize_linear`` on the device;
  * ``core/rbox.py::rbbox2result`` — split dets into per-class arrays.
"""

from __future__ import annotations

import importlib.util

import numpy as np
import torch


def load_config(path: str) -> dict:
    """Execute a python config file and return its top-level names."""
    spec = importlib.util.spec_from_file_location("_orp_torch_config", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {
        k: v for k, v in vars(mod).items()
        if not k.startswith("__") and not callable(v)
        and not isinstance(v, type(importlib))
    }


def rescale_size(h: int, w: int, scale) -> tuple[int, int, float]:
    """imrescale's arithmetic: fit (h, w) inside (long, short) edges."""
    if isinstance(scale, (int, float)):
        factor = scale
    else:
        max_long, max_short = max(scale), min(scale)
        factor = min(max_long / max(h, w), max_short / min(h, w))
    return int(h * factor + 0.5), int(w * factor + 0.5), factor


def imrescale(img: torch.Tensor, scale) -> tuple[torch.Tensor, float]:
    """(H, W, C) image tensor -> (rescaled image, factor), as
    ``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` computes it:
    a uint8 image through cv2's fixed-point taps (``resize_uint8``, uint8
    out), any other dtype through its float path (``resize_linear``,
    float32 out)."""
    h, w = img.shape[:2]
    nh, nw, factor = rescale_size(h, w, scale)
    if (nh, nw) == (h, w):
        return img, factor
    if img.dtype == torch.uint8:
        return resize_uint8(img, (nh, nw)), factor
    return resize_linear(img[None], (nh, nw))[0], factor


def ceil32(x: float) -> int:
    """x rounded up to a multiple of 32."""
    return int(np.ceil(x / 32.0)) * 32


def _linear_taps(n_in: int, n_out: int, clamp: bool = True):
    """cv2's INTER_LINEAR taps along one axis: the two source indices and
    the weight f of the second, for each output index, with half-pixel
    centres.  The position is computed in double and rounded to float, as
    cv2 computes it; f stays float32.  clamp: where a position lies left of
    the first or right of the last source pixel, that pixel alone (f = 0),
    as cv2's float path and its uint8 path along a row do; its uint8 path
    between rows keeps f there and only clamps the two source rows."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp:
        f[(s < 0) | (s >= n_in - 1)] = 0.0
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), f


def resize_linear(imgs: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) float32 -> (B, h, w, C): bilinear with half-pixel
    centres and no antialiasing, along each row first and then between
    rows, as cv2.resize(..., INTER_LINEAR) computes a float image."""
    x = imgs.to(torch.float32)
    (h, w), (hi, wi) = size, x.shape[1:3]
    if (h, w) == (hi, wi):
        return x
    sx, nx, fx = (torch.from_numpy(a).to(x.device)
                  for a in _linear_taps(wi, w))
    x = x[:, :, sx] * (1 - fx)[:, None] + x[:, :, nx] * fx[:, None]
    sy, ny, fy = (torch.from_numpy(a).to(x.device)
                  for a in _linear_taps(hi, h))
    return (x[:, sy] * (1 - fy)[:, None, None]
            + x[:, ny] * fy[:, None, None])


def _fixed_taps(n_in: int, n_out: int, clamp: bool, device):
    """The taps of a uint8 resize: the two source indices and cv2's 11-bit
    coefficients round((1 - f) * 2048) and round(f * 2048), half to even
    as cvRound."""
    s0, s1, f = _linear_taps(n_in, n_out, clamp)
    c0 = np.rint((np.float32(1.0) - f) * np.float32(2048.0)).astype(np.int32)
    c1 = np.rint(f * np.float32(2048.0)).astype(np.int32)
    return [torch.from_numpy(a).to(device) for a in (s0, s1, c0, c1)]


def resize_uint8(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(H, W, C) uint8 -> (h, w, C) uint8, cv2.resize(..., INTER_LINEAR)
    bit for bit: int32 arithmetic on the tensor's device.  Along each row,
    S = x[s0] c0 + x[s1] c1; between rows, cv2's vector path
    (((S0 >> 4) b0) >> 16) + (((S1 >> 4) b1) >> 16) + 2) >> 2, clipped to
    0..255.  (At an exact 2x downscale cv2 takes INTER_AREA, whose 2 x 2
    mean with rounding this gives too: every coefficient is 1024.)"""
    h, w = size
    x = img.to(torch.int32)
    s0, s1, c0, c1 = _fixed_taps(x.shape[1], w, True, x.device)
    x = x[:, s0] * c0[:, None] + x[:, s1] * c1[:, None]
    r0, r1, b0, b1 = _fixed_taps(x.shape[0], h, False, x.device)
    y = (((x[r0] >> 4) * b0[:, None, None]) >> 16) + \
        (((x[r1] >> 4) * b1[:, None, None]) >> 16)
    return ((y + 2) >> 2).clamp(0, 255).to(torch.uint8)


class Normalize:
    """(H, W, 3) BGR tensor -> (H, W, 3) normalized float32 (RGB if to_rgb)."""

    def __init__(self, mean, std, to_rgb: bool = True):
        self.mean = torch.tensor(mean, dtype=torch.float32)
        self.std = torch.tensor(std, dtype=torch.float32)
        self.to_rgb = to_rgb

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        x = img.to(torch.float32)
        if self.to_rgb:
            x = x.flip(-1)
        return (x - self.mean.to(x.device)) / self.std.to(x.device)


def rbbox2result(polys_scores: np.ndarray, labels: np.ndarray,
                 num_classes: int) -> list[np.ndarray]:
    """Split (n, 9[+18]) detections into num_classes-1 per-class arrays
    (num_classes includes background)."""
    polys_scores = np.asarray(polys_scores)
    labels = np.asarray(labels)
    width = polys_scores.shape[1] if polys_scores.ndim == 2 else 9
    if polys_scores.shape[0] == 0:
        return [np.zeros((0, width), dtype=np.float32)
                for _ in range(num_classes - 1)]
    return [polys_scores[labels == i].astype(np.float32)
            for i in range(num_classes - 1)]

"""Host-side helpers of the serving path, free of JAX and cv2.

Counterparts of:
  * ``utils/config.py::Config.fromfile`` — python-file configs;
  * ``data/pipelines.py::imrescale`` / ``RotateResize(keep_ratio=True)`` —
    the same size and factor arithmetic, with a bilinear resize on tensors;
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
import torch.nn.functional as F


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
    """(H, W, C) image tensor -> (rescaled float32 image, factor).

    Bilinear with half-pixel centres and no antialiasing, which is what
    cv2.INTER_LINEAR computes (cv2 rounds uint8 outputs; this keeps f32).
    """
    h, w = img.shape[:2]
    nh, nw, factor = rescale_size(h, w, scale)
    x = img.to(torch.float32)
    if (nh, nw) != (h, w):
        x = F.interpolate(x.permute(2, 0, 1)[None], size=(nh, nw),
                          mode="bilinear", align_corners=False)[0]
        x = x.permute(1, 2, 0)
    return x, factor


def ceil32(x: float) -> int:
    """x rounded up to a multiple of 32."""
    return int(np.ceil(x / 32.0)) * 32


def _linear_taps(n_in: int, n_out: int, device):
    """cv2's INTER_LINEAR taps along one axis: source index and weight of
    each output index, with half-pixel centres and the edge clamp.  The
    source position is computed in double and rounded to float, as cv2
    computes it; the weights stay float32."""
    scale = 1.0 / (n_out / n_in)
    fx = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx)
    fx = fx - sx
    sx = sx.astype(np.int64)
    low, high = sx < 0, sx >= n_in - 1
    fx[low | high] = 0.0
    sx = np.clip(sx, 0, n_in - 1)
    nxt = np.minimum(sx + 1, n_in - 1)
    return (torch.from_numpy(sx).to(device), torch.from_numpy(nxt).to(device),
            torch.from_numpy(fx).to(device))


def resize_linear(imgs: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) float32 -> (B, h, w, C): bilinear with half-pixel
    centres and no antialiasing, along each row first and then between
    rows, as cv2.resize(..., INTER_LINEAR) computes a float image."""
    x = imgs.to(torch.float32)
    (h, w), (hi, wi) = size, x.shape[1:3]
    if (h, w) == (hi, wi):
        return x
    sx, nx, fx = _linear_taps(wi, w, x.device)
    x = x[:, :, sx] * (1 - fx)[:, None] + x[:, :, nx] * fx[:, None]
    sy, ny, fy = _linear_taps(hi, h, x.device)
    return (x[:, sy] * (1 - fy)[:, None, None]
            + x[:, ny] * fy[:, None, None])


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

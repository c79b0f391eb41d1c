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
  * cv2.resize's INTER_CUBIC on a float32 image (the synthetic scenes'
    background and the Swin bias-table resize) — ``resize_cubic``, numpy;
  * ``devkit/img_split.py``'s ``cv2.resize(img, None, fx=rate, fy=rate,
    interpolation=cv2.INTER_CUBIC)`` on a uint8 scene —
    ``resize_cubic_uint8``, cv2's fixed-point arithmetic on CPU tensors;
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



def _cubic_taps(src: int, dst: int, scale: float | None = None):
    """cv2.resize INTER_CUBIC's taps along one axis, src -> dst samples:
    half-pixel source coordinates (dst + 0.5) * scale - 0.5 in double, cast
    to float32 (scale src / dst unless given), A = -0.75, the last weight
    as 1 minus the other three, and taps off the edge clamped to the
    border sample.  Returns (indices (dst, 4), weights (dst, 4) f32)."""
    scale = src / dst if scale is None else scale
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    x = f - s.astype(np.float32)
    a = np.float32(-0.75)
    x1, y = x + np.float32(1), np.float32(1) - x
    c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * y - (a + 3)) * y * y + 1
    c3 = np.float32(1) - c0 - c1 - c2
    idx = np.clip(s[:, None] + np.arange(-1, 3), 0, src - 1)
    return idx, np.stack([c0, c1, c2, c3], -1).astype(np.float32)


def resize_cubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W, C) float32 -> (h, w, C) float32, as cv2.resize(img, (w, h),
    interpolation=INTER_CUBIC) computes it in OpenCV's own loops, bit for
    bit: the horizontal pass sums the four taps in order; the vertical
    pass runs 4-lane vectors over the first 4 * floor(w * C / 4) values of
    each row, summing the taps from the last to the first, and a scalar
    loop over the rest, summing them in order.  (cv2 hands 1-, 3- and
    4-channel float resizes to IPP where it has it, which rounds its
    weights otherwise: ~1e-6 of a value.)"""
    h, w = size
    img = np.asarray(img, np.float32)
    ix, wx = _cubic_taps(img.shape[1], w)
    iy, wy = _cubic_taps(img.shape[0], h)
    rows = img[:, ix[:, 0]] * wx[None, :, 0, None]
    for j in range(1, 4):
        rows = rows + img[:, ix[:, j]] * wx[None, :, j, None]
    taps = [rows[iy[:, j]] * wy[:, j, None, None] for j in range(4)]
    fwd = ((taps[0] + taps[1]) + taps[2]) + taps[3]
    rev = ((taps[3] + taps[2]) + taps[1]) + taps[0]
    flat = fwd.reshape(h, -1)
    n_vec = flat.shape[1] // 4 * 4
    flat[:, :n_vec] = rev.reshape(h, -1)[:, :n_vec]
    return flat.reshape(fwd.shape)


CUBIC_BLOCK_ROWS = 256  # output rows resize_cubic_uint8 computes at once


def resize_cubic_uint8(img: np.ndarray, rate: float) -> np.ndarray:
    """(H, W[, C]) uint8 -> (round(H rate), round(W rate)[, C]) uint8, as
    cv2.resize(img, None, fx=rate, fy=rate, interpolation=INTER_CUBIC)
    computes it in OpenCV's own loops (cv2.ipp.setUseIPP(False)), bit for
    bit.  The sizes round half to even (saturate_cast<int>); the taps sit
    at (d + 0.5) / rate - 0.5 with 1 / rate in double (the rate itself, not
    the output over the input size), their weights rounded to 2048ths.  The
    horizontal pass sums integer taps.  The vertical pass takes cv2's
    vector body over the first 8 floor(w C / 8) values of each row: each
    sum and weight / 2^22 cast to float32, then from the last tap to the
    first a float32 multiply and a float32 add, rounded half to even; the
    rest of the row is its scalar tail, (sum of taps + 2^21) >> 22.  Both
    clip to 0..255; an output of the input's size is a copy, as in cv2.
    (cv2 with IPP differs by one grey level in up to ~8% of values at
    rates other than 0.5 and 2.)  CPU tensors, CUBIC_BLOCK_ROWS output
    rows at a time."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_cubic_uint8 takes uint8, not {img.dtype}")
    x = torch.from_numpy(np.ascontiguousarray(
        img.reshape(img.shape[0], img.shape[1], -1)))
    src_h, src_w, ch = x.shape
    h, w = int(np.rint(src_h * rate)), int(np.rint(src_w * rate))
    if (h, w) == (src_h, src_w):
        return img.copy()
    ix, wx = _cubic_taps(src_w, w, 1.0 / rate)
    iy, wy = _cubic_taps(src_h, h, 1.0 / rate)
    ix = torch.from_numpy(ix)
    cx = torch.from_numpy(np.rint(wx * np.float32(2048)).astype(np.int32))
    cy = torch.from_numpy(np.rint(wy * np.float32(2048)).astype(np.int64))
    n_vec = w * ch // 8 * 8
    out = torch.empty((h, w * ch), dtype=torch.uint8)
    for d0 in range(0, h, CUBIC_BLOCK_ROWS):
        d1 = min(d0 + CUBIC_BLOCK_ROWS, h)
        lo, hi = int(iy[d0:d1].min()), int(iy[d0:d1].max()) + 1
        src = x[lo:hi].to(torch.int32)
        rows = src[:, ix[:, 0]] * cx[:, 0, None]
        for j in range(1, 4):
            rows = rows + src[:, ix[:, j]] * cx[:, j, None]
        rows = rows.reshape(hi - lo, w * ch)
        taps = [rows[torch.from_numpy(iy[d0:d1, j] - lo)] for j in range(4)]
        beta = [cy[d0:d1, j, None] for j in range(4)]
        acc = taps[0].to(torch.int64) * beta[0]
        for j in range(1, 4):
            acc = acc + taps[j].to(torch.int64) * beta[j]
        res = (acc + (1 << 21)) >> 22
        bf = [(b.to(torch.float32) * 2.0 ** -22) for b in beta]  # exact
        v = taps[3][:, :n_vec].to(torch.float32) * bf[3]
        for j in (2, 1, 0):
            v = taps[j][:, :n_vec].to(torch.float32) * bf[j] + v
        res[:, :n_vec] = torch.round(v).to(torch.int64)
        out[d0:d1] = res.clamp(0, 255).to(torch.uint8)
    return out.reshape((h, w) + img.shape[2:]).numpy()


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

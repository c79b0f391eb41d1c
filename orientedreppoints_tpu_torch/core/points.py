"""FPN point grids and offset decoding (counterpart of core/points.py).

Head offsets are (dy, dx) pairs per point, y first; decoded point sets are
(x, y) pairs in image coordinates.
"""

from __future__ import annotations

import math

import torch


def level_shapes(img_size, strides) -> list[tuple[int, int]]:
    """Feature-map (h, w) per FPN level for an input padded to img_size."""
    h, w = img_size
    return [(math.ceil(h / s), math.ceil(w / s)) for s in strides]


def grid_points(feat_h: int, feat_w: int, stride: int,
                device: torch.device | str) -> torch.Tensor:
    """(feat_h*feat_w, 3) rows of (x, y, stride), x varying fastest."""
    xs = torch.arange(feat_w, dtype=torch.float32, device=device) * stride
    ys = torch.arange(feat_h, dtype=torch.float32, device=device) * stride
    xx = xs.repeat(feat_h)
    yy = ys.repeat_interleave(feat_w)
    return torch.stack([xx, yy, torch.full_like(xx, float(stride))], dim=-1)


def valid_flags(feat_h: int, feat_w: int, valid_h: torch.Tensor,
                valid_w: torch.Tensor) -> torch.Tensor:
    """(..., feat_h*feat_w) bool, True inside the un-padded region; valid_h
    and valid_w are (...) int tensors (per-image sizes on this level)."""
    dev = valid_h.device
    row = torch.arange(feat_h, device=dev)[:, None]
    col = torch.arange(feat_w, device=dev)[None, :]
    ok = (row < valid_h[..., None, None]) & (col < valid_w[..., None, None])
    return ok.reshape(ok.shape[:-2] + (-1,))


def multi_level_grid_points(img_size, strides, device="cpu"):
    """Per-level (n_l, 3) point grids for a padded image size."""
    return [grid_points(h, w, s, device)
            for (h, w), s in zip(level_shapes(img_size, strides), strides)]


def multi_level_valid_flags(img_size, strides, img_hw: torch.Tensor):
    """Per-level valid flags (B, n_l) from true image sizes img_hw (B, 2)."""
    out = []
    hw = img_hw.to(torch.float32)
    for (fh, fw), s in zip(level_shapes(img_size, strides), strides):
        vh = torch.clamp(torch.ceil(hw[:, 0] / s).to(torch.int32), max=fh)
        vw = torch.clamp(torch.ceil(hw[:, 1] / s).to(torch.int32), max=fw)
        out.append(valid_flags(fh, fw, vh, vw))
    return out


def offset_to_pts(pts_offsets: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, H, W, 2P) NHWC (dy, dx) offsets -> (B, H*W, 2P) (x, y) points."""
    b, h, w, c = pts_offsets.shape
    off_xy = pts_offsets.reshape(b, h * w, c // 2, 2).flip(-1)
    centers = grid_points(h, w, stride, pts_offsets.device)[:, :2]
    pts = off_xy * float(stride) + centers[None, :, None, :]
    return pts.reshape(b, h * w, c)

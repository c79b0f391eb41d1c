"""Min-area rect and convex hull of 9-point sets (counterpart of
ops/pallas_minarearect.py: ``min_area_rect_pallas`` and
``convex_hull_pallas``, two outputs of one kernel).

``min_area_rect`` and ``convex_hull_entry`` run the CUDA kernel
(csrc/minarearect.cu) for CUDA tensors and a plain PyTorch version for CPU
tensors: geometry.min_area_rect for the rects, convex_hull_plain for the
hulls.  The hull feeds the assigner's IoU, which is compared for exact
equality, so convex_hull_plain rounds as the kernel does: the centroid is
summed point by point, and every hull vertex is written as (p - c) + c.
"""

from __future__ import annotations

import torch

from . import _ext
from .geometry import min_area_rect as min_area_rect_plain

K = 9


def min_area_rect(points: torch.Tensor) -> torch.Tensor:
    """(n, 18) float32 point sets -> (n, 8) rect corners."""
    if points.device.type == "cpu":
        return min_area_rect_plain(points)
    return min_area_rect_kernel(points)[0]


def min_area_rect_kernel(points: torch.Tensor):
    """CUDA kernel: (n, 18) -> (rect (n, 8), hull (n, 9, 2), count (n,))."""
    n = points.shape[0]
    _ext.check_cuda(points, "points", torch.float32, (n, 2 * K))
    rect = torch.empty((n, 8), dtype=torch.float32, device=points.device)
    hull = torch.empty((n, K, 2), dtype=torch.float32, device=points.device)
    count = torch.empty((n,), dtype=torch.int32, device=points.device)
    _ext.launch("orp_min_area_rect", points.data_ptr(), rect.data_ptr(),
                hull.data_ptr(), count.data_ptr(), n, on=points)
    min_area_rect_kernel.launches += 1
    return rect, hull, count


min_area_rect_kernel.launches = 0


def convex_hull_entry(points: torch.Tensor):
    """(n, 18) float32 point sets -> (hull (n, 9, 2), count (n,) int32),
    the hull in gift-wrapping order from the min-x point, padded by
    repeating vertex 0."""
    if points.device.type == "cpu":
        return convex_hull_plain(points)
    return min_area_rect_kernel(points)[1:]


def convex_hull_plain(points: torch.Tensor):
    """Plain version of the kernel's hull stage, op for op (the kernel's
    value-tracked first-best choices are argmins that return the first
    index)."""
    p = points.reshape(points.shape[0], K, 2).to(torch.float32)
    n = p.shape[0]
    rows = torch.arange(n, device=p.device)
    c = p[:, 0]
    for k in range(1, K):
        c = c + p[:, k]
    # a tensor divisor: PyTorch's CUDA division by a scalar multiplies by
    # its reciprocal, which rounds differently from the kernel's division
    c = c / torch.full_like(c, K)
    cp = p - c[:, None]
    px, py = cp[..., 0], cp[..., 1]
    scale2 = torch.zeros_like(px[:, 0])
    for k in range(K):
        scale2 = torch.maximum(scale2, px[:, k] * px[:, k]
                               + py[:, k] * py[:, k])
    left_eps = (1e-6 * scale2)[:, None, None]
    dup_eps = 1e-12 * scale2 + 1e-30
    start = torch.argmin(px, dim=1)
    sx, sy = px[rows, start], py[rows, start]
    hx, hy, valid = [sx], [sy], [torch.ones_like(start, dtype=torch.bool)]
    curx, cury = sx, sy
    done = torch.zeros_like(valid[0])
    for _ in range(1, K):
        dx = px - curx[:, None]
        dy = py - cury[:, None]
        d2 = dx * dx + dy * dy
        crs = dx[:, :, None] * (py[:, None, :] - cury[:, None, None]) - \
            dy[:, :, None] * (px[:, None, :] - curx[:, None, None])
        score = (crs > left_eps).to(torch.float32).sum(2)
        rank = torch.where(d2 > dup_eps[:, None], score * 1e9 - d2,
                           torch.full_like(d2, float("inf")))
        best = torch.argmin(rank, dim=1)
        best_rank = rank[rows, best]
        bx, by = px[rows, best], py[rows, best]
        # no finite rank: the kernel keeps (bx, by) at the current vertex
        bx = torch.where(torch.isfinite(best_rank), bx, curx)
        by = torch.where(torch.isfinite(best_rank), by, cury)
        back = (bx - sx) * (bx - sx) + (by - sy) * (by - sy) <= dup_eps
        done = done | ~torch.isfinite(best_rank) | back
        emit = ~done
        hx.append(torch.where(emit, bx, sx))
        hy.append(torch.where(emit, by, sy))
        valid.append(emit)
        curx = torch.where(emit, bx, curx)
        cury = torch.where(emit, by, cury)
    valid = torch.stack(valid, 1)
    hx = torch.where(valid, torch.stack(hx, 1), sx[:, None]) + c[:, :1]
    hy = torch.where(valid, torch.stack(hy, 1), sy[:, None]) + c[:, 1:]
    return torch.stack([hx, hy], -1), valid.sum(1).to(torch.int32)

"""IoU of point-set hulls with gt quads (counterpart of
ops/pallas_quad_iou.py, ``hull_quad_iou_matrix_pallas`` and its kernel
``_hull_kernel``), with the refine assigner's validity masks.

For hulls (B, N, 9, 2) with vertex counts (B, N) (padding repeats vertex 0)
and quads (B, G, 8), the result is the (B, N, G) f32 IoU matrix.  Per pair,
in the Pallas tile's order of operations: recentre hull and quad on the
quad's vertex 0, the hull's signed area by the masked shoelace over its
slots, orient the quad counter-clockwise (a clockwise quad is read as
vertices 0, 3, 2, 1), Sutherland-Hodgman clip by its four half-planes with
stage caps 10, 11, 12, 13, then inter / max(area_a + area_b - inter, 1e-8).
Optional masks gt_valid (B, G) and rows_valid (B, N) (None: all valid) make
every pair whose gt or point set is not valid -1.0, as the assigner has it.

The refine assigner compares IoUs for exact equality, so the CUDA kernel
(csrc/hull_iou.cu) and the plain version below must give the same bits:
both follow that order, the plain version op for op on whole tensors
(its clip stages are geometry._clip_half_plane's), and the kernel is built
with -fmad=false.  The JAX package's XLA fallback
(``geometry.convex_intersection_area``) rounds differently.

``hull_quad_iou_matrix`` runs the kernel for CUDA tensors and the plain
version for CPU tensors.  The kernel writes (B, G, N), the layout the
assigner reads, and the entry returns it as a transposed (B, N, G) view.
"""

from __future__ import annotations

import torch

from . import _ext
from .geometry import _EPS, _clip_half_plane

_CHUNK_PAIRS = 1 << 18  # pairs the plain version holds at once
V = 9  # hull slots


def _shoelace_slots(vx, vy, cnt):
    """Signed 2x area over the first cnt of the (..., cap) slots, the ring
    wrapping at cnt; summed slot by slot from 0."""
    cap = vx.shape[-1]
    slots = torch.arange(cap, device=vx.device)
    wrap = cnt[..., None] == slots + 1
    nx = torch.where(wrap, vx[..., :1], vx.roll(-1, -1))
    ny = torch.where(wrap, vy[..., :1], vy.roll(-1, -1))
    terms = torch.where(cnt[..., None] > slots, vx * ny - nx * vy, 0.0)
    s = torch.zeros_like(terms[..., 0])
    for j in range(cap):
        s = s + terms[..., j]
    return s


def _hull_quad_iou_pairs(hx, hy, cnt, q):
    """IoU of broadcast pairs: subject slots hx, hy (..., V), counts (...),
    quads (..., 8).  The clip stages keep V + 1 .. V + 4 slots: 10-13 for
    a hull's 9 slots, 5-8 for a quad's 4 (the quad tile's caps)."""
    ox, oy = q[..., 0], q[..., 1]
    hx = hx - ox[..., None]
    hy = hy - oy[..., None]
    area2 = _shoelace_slots(hx, hy, cnt)
    bx = [q[..., 2 * k] - ox for k in range(4)]
    by = [q[..., 2 * k + 1] - oy for k in range(4)]
    area2_b = torch.zeros_like(ox)
    for k in range(4):
        kn = (k + 1) % 4
        area2_b = area2_b + (bx[k] * by[kn] - bx[kn] * by[k])
    # a clockwise quad is read as vertices 0, 3, 2, 1
    quad = torch.stack([torch.stack(bx, -1), torch.stack(by, -1)], -1)
    quad = torch.where((area2_b < 0)[..., None, None],
                       quad[..., [0, 3, 2, 1], :], quad)
    verts = torch.stack([hx, hy], -1)
    for e in range(4):
        cap = hx.shape[-1] + 1 + e
        verts, cnt = _clip_half_plane(verts, cnt, quad[..., e, :],
                                      quad[..., (e + 1) % 4, :], cap)
    inter = 0.5 * _shoelace_slots(verts[..., 0], verts[..., 1], cnt).abs()
    area_a = 0.5 * area2.abs()
    area_b = 0.5 * area2_b.abs()
    union = torch.clamp(area_a + area_b - inter, min=_EPS)
    return inter / union


def hull_quad_iou_matrix_plain(hulls, counts, quads, gt_valid=None,
                               rows_valid=None):
    """Plain version: the Pallas tile's arithmetic over broadcast pairs,
    in row chunks of about _CHUNK_PAIRS pairs; then -1.0 where masked."""
    b, n = counts.shape
    g = quads.shape[1]
    out = torch.empty((b, n, g), dtype=torch.float32, device=quads.device)
    hx, hy = hulls[..., 0].float(), hulls[..., 1].float()
    cnt = counts.to(torch.int32)
    q = quads.float()[:, None, :, :]
    rows = max(1, _CHUNK_PAIRS // max(1, b * g))
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        shape = (b, r1 - r0, g)
        out[:, r0:r1] = _hull_quad_iou_pairs(
            hx[:, r0:r1, None, :].expand(shape + (V,)),
            hy[:, r0:r1, None, :].expand(shape + (V,)),
            cnt[:, r0:r1, None].expand(shape),
            q.expand(shape + (8,)))
    if gt_valid is not None:
        out = torch.where(gt_valid[:, None, :], out, -1.0)
    if rows_valid is not None:
        out = torch.where(rows_valid[:, :, None], out, -1.0)
    return out


def hull_quad_iou_matrix(hulls: torch.Tensor, counts: torch.Tensor,
                         quads: torch.Tensor, gt_valid=None,
                         rows_valid=None) -> torch.Tensor:
    """(B, N, 9, 2) f32 hulls, (B, N) int32 counts, (B, G, 8) f32 quads,
    optional (B, G) and (B, N) bool masks -> (B, N, G) f32 IoU, -1.0 where
    the gt or the row is not valid."""
    if quads.device.type == "cpu":
        return hull_quad_iou_matrix_plain(hulls, counts, quads, gt_valid,
                                          rows_valid)
    return hull_quad_iou_kernel(hulls, counts, quads, gt_valid,
                                rows_valid).transpose(1, 2)


def hull_quad_iou_kernel(hulls, counts, quads, gt_valid=None,
                         rows_valid=None):
    """The CUDA kernel; returns the (B, G, N) layout."""
    b, n = counts.shape
    g = quads.shape[1]
    masks = ((gt_valid, "gt_valid", (b, g)),
             (rows_valid, "rows_valid", (b, n)))
    for m, name, shape in masks:  # before the device check: raise on CPU too
        if m is not None:
            _ext.check_dtype_shape(m, name, torch.bool, shape)
    _ext.check_cuda(hulls, "hulls", torch.float32, (b, n, V, 2))
    _ext.check_cuda(counts, "counts", torch.int32, (b, n), hulls.device)
    _ext.check_cuda(quads, "quads", torch.float32, (b, g, 8), hulls.device)
    for m, name, shape in masks:
        if m is not None:
            _ext.check_cuda(m, name, torch.bool, shape, hulls.device)
    out = torch.empty((b, g, n), dtype=torch.float32, device=quads.device)
    _ext.launch("orp_hull_quad_iou", hulls.data_ptr(), counts.data_ptr(),
                quads.data_ptr(), _ptr(gt_valid), _ptr(rows_valid),
                out.data_ptr(), b, n, g, on=quads)
    hull_quad_iou_kernel.launches += 1
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


hull_quad_iou_kernel.launches = 0

"""Batched convex geometry in plain PyTorch (counterpart of ops/geometry.py).

These are the plain versions the kernels are held against, ported from the
JAX package's XLA formulations and vectorised over a leading batch:

  * convex_hull / min_area_rect — ``convex_hull`` + ``min_area_rect_single``
    (gift wrapping with scale-relative eps, rotating calipers).  One
    deliberate difference: box areas within a relative TIE_RTOL of the
    least count as equal and the first hull edge among them wins.  Exact
    ties are common (three hull points supporting the box give two edges
    the same area), and in the JAX package rounding decides them; the rule
    makes this version and the CUDA kernel pick the same box;
  * rbox_to_quad and box_iou_rotated (the (n, 5) xywh-angle IoU matrix,
    through quad_iou.quad_iou_matrix and its CUDA kernel);
  * the training geometry: points_in_polygon, polygon_area,
    clip_convex_by_quad, convex_giou (with the enclosing hull of the 13
    points), convex_iou (kernel 1's hull + the masked hull-IoU kernel) and
    chamfer_distance_2d.  Where the JAX package differentiates (convex_giou
    in the GIoU loss), autograd does here: the hull is a gather at indices
    chosen without gradient, and the clip is differentiable arithmetic.
"""

from __future__ import annotations

import torch

_BIG = 1e20
_EPS = 1e-8
TIE_RTOL = 1e-5  # keep equal to csrc/minarearect.cu


def convex_hull(pts: torch.Tensor):
    """(n, P, 2) point sets -> (hull (n, P, 2), mask (n, P), count (n,)).

    Hull vertices in scan order from the min-x point, padded by repeating
    the first vertex; same selection rules and ties as the JAX scan.
    """
    pts = pts.to(torch.float32)
    n, p, _ = pts.shape
    rows = torch.arange(n, device=pts.device)
    sel = pts.detach()  # the choice of vertices carries no gradient
    cpts = sel - sel.sum(1, keepdim=True) / p
    scale2 = (cpts * cpts).sum(-1).amax(1).clamp_min(1e-12)
    left_eps = (1e-6 * scale2)[:, None, None]
    dup_eps = (1e-12 * scale2)[:, None]

    start = torch.argmin(cpts[..., 0], dim=1)
    cur = start
    done = torch.zeros(n, dtype=torch.bool, device=pts.device)
    seq, done_seq = [], []
    for _ in range(p - 1):
        d = cpts - cpts[rows, cur][:, None, :]
        dist2 = (d * d).sum(-1)
        cand_ok = dist2 > dup_eps
        crs = d[:, :, None, 0] * d[:, None, :, 1] - \
            d[:, :, None, 1] * d[:, None, :, 0]
        score = (crs > left_eps).sum(2).to(torch.float32)
        rank = torch.where(cand_ok, score * 1e9 - dist2,
                           torch.full_like(dist2, float("inf")))
        nxt = torch.argmin(rank, dim=1)
        any_cand = cand_ok.any(1)
        nxt = torch.where(done | ~any_cand, start, nxt)
        done = done | ~any_cand | (nxt == start)
        seq.append(nxt)
        done_seq.append(done)
        cur = nxt
    hull_idx = torch.stack([start] + seq, 1)
    emitted = torch.cat([torch.ones_like(done)[:, None],
                         ~torch.stack(done_seq, 1)], 1)
    hull_idx = torch.where(emitted, hull_idx, start[:, None])
    hull = pts[rows[:, None], hull_idx]
    return hull, emitted, emitted.sum(1)


def min_area_rect(points: torch.Tensor) -> torch.Tensor:
    """(n, 2P) point sets -> (n, 8) min-area-rect corners.

    Rotating calipers over the hull edges; a degenerate set (no edge)
    emits its point 4x.
    """
    pts = points.reshape(points.shape[0], -1, 2).to(torch.float32)
    n, p, _ = pts.shape
    rows = torch.arange(n, device=pts.device)
    shift = pts.mean(1, keepdim=True)
    hull, hmask, hcount = convex_hull(pts - shift)
    idx = torch.arange(p, device=pts.device)[None, :]
    nxt = torch.where(idx >= hcount[:, None] - 1, 0, idx + 1)
    edges = torch.gather(hull, 1, nxt[..., None].expand(-1, -1, 2)) - hull
    elen = torch.linalg.norm(edges, dim=-1)
    edge_ok = (idx < hcount[:, None]) & (elen > 1e-9)
    theta = torch.atan2(edges[..., 1], edges[..., 0])
    cos_t = torch.cos(-theta)[..., None]
    sin_t = torch.sin(-theta)[..., None]
    hx, hy = hull[:, None, :, 0], hull[:, None, :, 1]
    rx = cos_t * hx - sin_t * hy  # (n, edge, point)
    ry = sin_t * hx + cos_t * hy
    big = torch.where(hmask, 0.0, _BIG)[:, None, :]
    xmin = (rx + big).amin(2)
    ymin = (ry + big).amin(2)
    xmax = (rx - big).amax(2)
    ymax = (ry - big).amax(2)
    areas = torch.where(edge_ok, (xmax - xmin) * (ymax - ymin),
                        torch.full_like(xmin, float("inf")))
    # first edge within TIE_RTOL of the least area (see the module doc)
    cut = areas.amin(1, keepdim=True) * (1 + TIE_RTOL)
    best = torch.argmax((areas <= cut).to(torch.uint8), dim=1)
    bx0, bx1 = xmin[rows, best], xmax[rows, best]
    by0, by1 = ymin[rows, best], ymax[rows, best]
    rect = torch.stack([torch.stack([bx0, by0], -1),
                        torch.stack([bx1, by0], -1),
                        torch.stack([bx1, by1], -1),
                        torch.stack([bx0, by1], -1)], 1)  # (n, 4, 2)
    th = theta[rows, best][:, None]
    ct, st = torch.cos(th), torch.sin(th)
    rot_back = torch.stack([ct * rect[..., 0] - st * rect[..., 1],
                            st * rect[..., 0] + ct * rect[..., 1]], -1)
    degenerate = ~edge_ok.any(1)
    fallback = hull[:, :1, :].expand(-1, 4, -1)
    out = torch.where(degenerate[:, None, None], fallback, rot_back) + shift
    return out.reshape(n, 8)


def _shoelace(poly: torch.Tensor, count: torch.Tensor | int) -> torch.Tensor:
    """Signed area of the first `count` vertices of (..., V, 2) polygons,
    taken relative to vertex 0."""
    v = poly.shape[-2]
    idx = torch.arange(v, device=poly.device)
    p = poly - poly[..., :1, :]
    rolled = torch.roll(p, -1, dims=-2)
    count = torch.as_tensor(count, device=poly.device)[..., None]
    q = torch.where((idx == count - 1)[..., None], p[..., :1, :], rolled)
    terms = p[..., 0] * q[..., 1] - q[..., 0] * p[..., 1]
    return 0.5 * torch.where(idx < count, terms, 0.0).sum(-1)


def _orient_ccw(quad: torch.Tensor) -> torch.Tensor:
    return torch.where((_shoelace(quad, 4) >= 0)[..., None, None], quad,
                       quad.flip(-2))


def _clip_half_plane(verts, count, a, b, out_cap: int):
    """Keep the part of (..., V, 2) polygons left of the edges a -> b."""
    v = verts.shape[-2]
    idx = torch.arange(v, device=verts.device)
    valid = idx < count[..., None]
    wrap = (idx == count[..., None] - 1)[..., None]
    nxtv = torch.where(wrap, verts[..., :1, :], torch.roll(verts, -1, -2))
    e = (b - a)[..., None, :]
    a = a[..., None, :]
    side_cur = e[..., 0] * (verts[..., 1] - a[..., 1]) - \
        e[..., 1] * (verts[..., 0] - a[..., 0])
    side_nxt = e[..., 0] * (nxtv[..., 1] - a[..., 1]) - \
        e[..., 1] * (nxtv[..., 0] - a[..., 0])
    in_cur = side_cur >= 0
    in_nxt = side_nxt >= 0
    denom = side_cur - side_nxt
    t = side_cur / torch.where(denom.abs() < 1e-12, 1.0, denom)
    inter = verts + t[..., None] * (nxtv - verts)
    # per edge: slot 0 the crossing point, slot 1 the next vertex if inside
    cand = torch.stack([inter, nxtv], -2).flatten(-3, -2)  # (..., 2V, 2)
    emit = torch.stack([valid & (in_cur != in_nxt), valid & in_nxt],
                       -1).flatten(-2)
    pos = torch.cumsum(emit.to(torch.int32), -1) - 1
    dest = torch.where(emit & (pos < out_cap), pos, out_cap).to(torch.int64)
    out = torch.zeros(cand.shape[:-2] + (out_cap + 1, 2), dtype=cand.dtype,
                      device=cand.device)
    out.scatter_(-2, dest[..., None].expand_as(cand), cand)
    return out[..., :out_cap, :], emit.sum(-1)


def rbox_to_quad(rboxes: torch.Tensor) -> torch.Tensor:
    """(n, 5) [cx, cy, w, h, angle] -> (n, 8) corners tl, tr, br, bl
    rotated by angle."""
    r = rboxes.to(torch.float32)
    cx, cy, w, h, ang = r.unbind(1)
    dx, dy = w / 2, h / 2
    lx = torch.stack([-dx, dx, dx, -dx], 1)
    ly = torch.stack([-dy, -dy, dy, dy], 1)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    gx = cos * lx - sin * ly + cx[:, None]
    gy = sin * lx + cos * ly + cy[:, None]
    return torch.stack([gx, gy], 2).reshape(-1, 8)


def box_iou_rotated(rboxes1: torch.Tensor, rboxes2: torch.Tensor):
    """(n, 5) x (m, 5) xywh-angle boxes -> (n, m) exact IoU matrix."""
    from .quad_iou import quad_iou_matrix

    return quad_iou_matrix(rbox_to_quad(rboxes1).contiguous(),
                           rbox_to_quad(rboxes2).contiguous())


def polygon_area(poly: torch.Tensor, count=None) -> torch.Tensor:
    """Absolute area of the first `count` vertices of (..., V, 2)."""
    return _shoelace(poly, poly.shape[-2] if count is None else count).abs()


def points_in_polygon(points: torch.Tensor, poly: torch.Tensor):
    """Ray-cast inside test: (..., P, 2) points, (..., V, 2) polygons ->
    (..., P) bool (boundary by crossing parity)."""
    px, py = points[..., :, None, 0], points[..., :, None, 1]
    vn = torch.roll(poly, -1, dims=-2)
    x1, y1 = poly[..., None, :, 0], poly[..., None, :, 1]
    x2, y2 = vn[..., None, :, 0], vn[..., None, :, 1]
    straddle = (y1 > py) != (y2 > py)
    xint = (x2 - x1) * (py - y1) / torch.where(y2 == y1, 1.0, y2 - y1) + x1
    crossing = straddle & (px < xint)
    return crossing.sum(-1) % 2 == 1


def clip_convex_by_quad(verts, count, quad, out_cap: int | None = None):
    """Clip (..., V, 2) convex polygons with `count` vertices by convex
    quads (..., 4, 2) of any winding -> (poly (..., out_cap, 2), count);
    out_cap defaults to V + 4."""
    q = _orient_ccw(quad)
    cap = out_cap or verts.shape[-2] + 4
    for i in range(4):
        verts, count = _clip_half_plane(verts, count, q[..., i, :],
                                        q[..., (i + 1) % 4, :], cap)
    return verts, count


def _aligned_overlap(points: torch.Tensor, gt_quads: torch.Tensor):
    """(points, quads) shifted by each quad's mean, the intersection of
    each point set's hull with its quad, and their union."""
    pts = points.reshape(points.shape[0], -1, 2).to(torch.float32)
    quad = gt_quads.reshape(-1, 4, 2).to(torch.float32)
    shift = quad.mean(1, keepdim=True)
    pts = pts - shift
    quad = quad - shift
    hull, _, hcount = convex_hull(pts)
    area_p = polygon_area(hull, hcount)
    area_q = polygon_area(quad)
    clipped, ccount = clip_convex_by_quad(hull, hcount, quad)
    inter = polygon_area(clipped, ccount)
    return pts, quad, inter, area_p + area_q - inter


def convex_iou_aligned(points: torch.Tensor, gt_quads: torch.Tensor):
    """Aligned IoU of the hull of each point set with its gt quad: points
    (n, 18), gt_quads (n, 8) -> (n,); differentiable in points (the JAX
    package's vmapped convex_iou_single)."""
    _, _, inter, union = _aligned_overlap(points, gt_quads)
    return inter / torch.clamp(union, min=_EPS)


def convex_giou(points: torch.Tensor, gt_quads: torch.Tensor):
    """Aligned GIoU of the hull of each point set with its gt quad:
    points (n, 18), gt_quads (n, 8) -> (n,).  GIoU = IoU - (C - U) / C with
    C the area of the hull of all 13 points; differentiable in points."""
    pts, quad, inter, union = _aligned_overlap(points, gt_quads)
    ehull, _, ecount = convex_hull(torch.cat([pts, quad], 1))
    c_area = polygon_area(ehull, ecount)
    iou = inter / torch.clamp(union, min=_EPS)
    return iou - (c_area - union) / torch.clamp(c_area, min=_EPS)


def convex_iou(gt_quads: torch.Tensor, points: torch.Tensor,
               gt_valid=None, points_valid=None):
    """Batched convex IoU matrix: gt quads (B, G, 8) x point sets
    (B, N, 18) -> (B, G, N); with the optional masks gt_valid (B, G) and
    points_valid (B, N), -1.0 wherever either is not valid.

    Every image is shifted by the mean of all its gt corners, padded zero
    rows included (as the JAX package does); then kernel 1's hulls
    (convex_hull_entry) go through the hull-IoU kernel, one launch each for
    the batch, which writes the (B, G, N) layout itself.
    """
    from .hull_iou import hull_quad_iou_matrix
    from .minarearect import convex_hull_entry

    b, n = points.shape[:2]
    g = gt_quads.shape[1]
    pts = points.reshape(b, n, -1, 2).to(torch.float32)
    quads = gt_quads.reshape(b, g, 4, 2).to(torch.float32)
    shift = quads.reshape(b, -1, 2).mean(1)[:, None, None, :]
    pts = (pts - shift).reshape(b * n, -1)
    quads = (quads - shift).reshape(b, g, 8)
    hulls, counts = convex_hull_entry(pts)
    iou = hull_quad_iou_matrix(hulls.reshape(b, n, -1, 2),
                               counts.reshape(b, n), quads, gt_valid,
                               points_valid)
    return iou.transpose(1, 2)


def chamfer_distance_2d(set1: torch.Tensor, set2: torch.Tensor,
                        distance_weight: float = 0.05, eps: float = 1e-12):
    """Symmetric mean nearest-neighbour distance of (..., N, 2) and
    (..., M, 2) point sets, times distance_weight / 2."""
    diff = set1[..., :, None, :] - set2[..., None, :, :]
    d2 = (diff * diff).sum(-1)
    d1 = torch.sqrt(torch.clamp(d2.amin(-1), min=eps))
    d2m = torch.sqrt(torch.clamp(d2.amin(-2), min=eps))
    return (d1.mean(-1) + d2m.mean(-1)) / 2.0 * distance_weight

"""Convex geometry in plain PyTorch: gift-wrapping hulls of point sets,
the min-area rectangle by rotating calipers, polygon areas, Sutherland-
Hodgman clipping by a convex quad, the IoU and GIoU of a point set's hull
with a quad, the IoU of two quads, the inside test and the chamfer
distance.

Ties in the min-area rectangle: areas within a relative TIE_RTOL of the
least count as equal and the first hull edge among them wins.
"""

from __future__ import annotations

import torch

_BIG = 1e20
_EPS = 1e-8
TIE_RTOL = 1e-5


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


def chamfer_distance_2d(set1: torch.Tensor, set2: torch.Tensor,
                        distance_weight: float = 0.05, eps: float = 1e-12):
    """Symmetric mean nearest-neighbour distance of (..., N, 2) and
    (..., M, 2) point sets, times distance_weight / 2."""
    diff = set1[..., :, None, :] - set2[..., None, :, :]
    d2 = (diff * diff).sum(-1)
    d1 = torch.sqrt(torch.clamp(d2.amin(-1), min=eps))
    d2m = torch.sqrt(torch.clamp(d2.amin(-2), min=eps))
    return (d1.mean(-1) + d2m.mean(-1)) / 2.0 * distance_weight


def hull_quad_iou(hull, count, quad):
    """IoU of convex polygons (..., V, 2) with `count` vertices and quads
    (..., 8) of any winding, broadcast -> (...)."""
    q = quad.reshape(quad.shape[:-1] + (4, 2))
    shift = q.mean(-2, keepdim=True)
    hull, q = hull - shift, q - shift
    area_p = polygon_area(hull, count)
    area_q = polygon_area(q)
    clipped, ccount = clip_convex_by_quad(hull, count, q)
    inter = polygon_area(clipped, ccount)
    return inter / torch.clamp(area_p + area_q - inter, min=_EPS)


def quad_iou(a, b):
    """IoU of quads (..., 8) x (..., 8), broadcast."""
    a, b = torch.broadcast_tensors(a, b)
    cnt = torch.full(a.shape[:-1], 4, dtype=torch.int64, device=a.device)
    return hull_quad_iou(a.reshape(a.shape[:-1] + (4, 2)), cnt, b)

"""Point-to-gt assignment, batched over images (counterpart of
core/assigners.py).

  * point_assign — PointAssigner: scale-aware gt level, per gt the pos_num
    nearest points of that level by wh-normalised centre distance, closest
    gt wins, the earlier gt on ties;
  * max_iou_assign — MaxIoUAssigner over the convex IoU (ops.geometry.
    convex_iou: kernel 1's hulls and the hull-IoU kernel, which writes -1
    for the pairs of a padded gt or an invalid point), with step 4's
    gt_max_assign_all: every proposal whose IoU equals a gt's max (compared
    for exact equality) goes to that gt, later gts overwriting earlier ones.

Gt arrays are padded to G with gt_valid masks; returns 1-based gt indices
(0 = background).  Ties resolve as in the JAX package: argmin/argmax take
the first index, top-k orders equal values by index (topk_stable).
"""

from __future__ import annotations

import torch

from ..ops.geometry import convex_iou
from ..ops.nms import topk_stable

_INF = float("inf")


def point_assign(points, points_valid, gt_polys, gt_valid, scale: float = 4.0,
                 pos_num: int = 1):
    """points (N, 3) rows (x, y, stride); points_valid (B, N); gt_polys
    (B, G, 8); gt_valid (B, G).  Returns (B, N) int32, 0 = background,
    g + 1 = gt index."""
    b, g = gt_valid.shape
    xy = points[:, :2]
    lvl = torch.log2(points[:, 2]).to(torch.int32)  # (N,)
    lvl_min = torch.where(points_valid, lvl, 10 ** 6).amin(1)  # (B,)
    lvl_max = torch.where(points_valid, lvl, -(10 ** 6)).amax(1)

    quad = gt_polys.reshape(b, g, 4, 2)
    gmin = quad.amin(2)
    gmax = quad.amax(2)
    gt_cxy = (gmin + gmax) / 2
    gt_wh = torch.clamp(gmax - gmin, min=1e-6)
    gt_lvl = ((torch.log2(gt_wh[..., 0] / scale)
               + torch.log2(gt_wh[..., 1] / scale)) / 2).to(torch.int32)
    gt_lvl = torch.minimum(torch.maximum(gt_lvl, lvl_min[:, None]),
                           lvl_max[:, None])

    # (B, G, N) wh-normalised distances, restricted to the gt's level
    diff = (xy[None, None] - gt_cxy[:, :, None]) / gt_wh[:, :, None]
    dist = torch.sqrt((diff * diff).sum(-1))
    usable = ((lvl[None, None, :] == gt_lvl[..., None])
              & points_valid[:, None, :] & gt_valid[..., None])
    dist = torch.where(usable, dist, _INF)

    neg_top, top_idx = topk_stable(-dist, pos_num)  # (B, G, k)
    top_dist = -neg_top
    selected = torch.full_like(dist, _INF)
    selected.scatter_(2, top_idx, torch.where(torch.isfinite(top_dist),
                                              top_dist, _INF))
    best_dist, _ = selected.min(1)
    best_gt = torch.argmin(selected, dim=1)
    assigned = torch.where(torch.isfinite(best_dist), best_gt + 1, 0)
    return assigned.to(torch.int32)


def max_iou_assign_from_overlaps(overlaps, proposals_valid, gt_valid,
                                 pos_iou_thr: float = 0.1,
                                 neg_iou_thr: float = 0.1,
                                 min_pos_iou: float = 0.0):
    """The 4-step MaxIoUAssigner rule over (B, G, N) overlaps ->
    (B, N) int32."""
    g = overlaps.shape[1]
    max_overlaps = overlaps.amax(1)  # (B, N)
    argmax_overlaps = torch.argmax(overlaps, dim=1)
    gt_max_overlaps = overlaps.amax(2)  # (B, G)

    assigned = torch.full_like(max_overlaps, -1, dtype=torch.int32)
    assigned = torch.where((max_overlaps >= 0) & (max_overlaps < neg_iou_thr),
                           0, assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr,
                           argmax_overlaps.to(torch.int32) + 1, assigned)

    # step 4: the last gt whose max IoU this proposal ties exactly
    qualifies = ((overlaps == gt_max_overlaps[..., None])
                 & (gt_max_overlaps >= min_pos_iou)[..., None]
                 & gt_valid[..., None] & proposals_valid[:, None, :])
    gt_ids = torch.arange(g, dtype=torch.int32, device=overlaps.device)
    last_q = torch.where(qualifies, gt_ids[None, :, None], -1).amax(1)
    assigned = torch.where(last_q >= 0, last_q + 1, assigned)

    assigned = torch.where(proposals_valid, assigned, 0)
    return torch.clamp(assigned, min=0).to(torch.int32)


def max_iou_assign(proposals, proposals_valid, gt_polys, gt_valid,
                   pos_iou_thr: float = 0.1, neg_iou_thr: float = 0.1,
                   min_pos_iou: float = 0.0):
    """proposals (B, N, 18), proposals_valid (B, N), gt_polys (B, G, 8),
    gt_valid (B, G).  Returns (assigned (B, N) int32, overlaps (B, G, N))
    with -1 where the gt or the proposal is not valid."""
    overlaps = convex_iou(gt_polys, proposals, gt_valid, proposals_valid)
    assigned = max_iou_assign_from_overlaps(
        overlaps, proposals_valid, gt_valid, pos_iou_thr=pos_iou_thr,
        neg_iou_thr=neg_iou_thr, min_pos_iou=min_pos_iou)
    return assigned, overlaps

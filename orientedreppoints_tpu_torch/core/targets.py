"""Point-set training targets, batched over images (counterpart of
core/targets.py: init_targets_single / refine_targets_single under vmap).

pos_weight <= 0 in both oriented configs, so positive label weights are 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .assigners import max_iou_assign, point_assign


class Targets(NamedTuple):
    labels: torch.Tensor  # (B, N) int32; 0 = background
    label_weights: torch.Tensor  # (B, N) f32; 0 for padded points
    gt_polys: torch.Tensor  # (B, N, 8) assigned gt per positive point
    pos_weights: torch.Tensor  # (B, N) f32; 1 for positives
    gt_inds: torch.Tensor  # (B, N) int32 1-based gt index (0 = none)


def _build_targets(assigned, points_valid, gt_polys, gt_labels):
    pos = assigned > 0
    gi = torch.clamp(assigned - 1, min=0).long()
    labels = torch.where(pos, torch.gather(gt_labels, 1, gi), 0)
    polys = torch.gather(gt_polys, 1, gi[..., None].expand(-1, -1, 8))
    polys = torch.where(pos[..., None], polys, 0.0)
    return Targets(labels.to(torch.int32), points_valid.to(torch.float32),
                   polys, pos.to(torch.float32), assigned.to(torch.int32))


def init_targets(points, points_valid, gt_polys, gt_valid, gt_labels,
                 scale: float = 4.0, pos_num: int = 1) -> Targets:
    """points (N, 3) (x, y, stride); points_valid (B, N); gt_polys
    (B, G, 8); gt_valid (B, G); gt_labels (B, G) 1-based."""
    assigned = point_assign(points, points_valid, gt_polys, gt_valid,
                            scale=scale, pos_num=pos_num)
    return _build_targets(assigned, points_valid, gt_polys, gt_labels)


def refine_targets(proposals, points_valid, gt_polys, gt_valid, gt_labels,
                   pos_iou_thr: float = 0.1, neg_iou_thr: float = 0.1,
                   min_pos_iou: float = 0.0,
                   stats: dict | None = None) -> Targets:
    """proposals (B, N, 18): the init-stage point sets, detached.  stats,
    when a dict, receives the (B, G, N) overlaps."""
    assigned, overlaps = max_iou_assign(
        proposals, points_valid, gt_polys, gt_valid, pos_iou_thr=pos_iou_thr,
        neg_iou_thr=neg_iou_thr, min_pos_iou=min_pos_iou)
    if stats is not None:
        stats["overlaps"] = overlaps
    return _build_targets(assigned, points_valid, gt_polys, gt_labels)

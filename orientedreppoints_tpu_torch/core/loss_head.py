"""The OrientedRepPoints training loss, batched with fixed shapes
(counterpart of core/loss_head.py).

  1. decode init/refine offsets to image-coordinate point sets;
  2. init targets by the point assigner;
  3. refine targets by the convex max-IoU assigner over the detached init
     point sets;
  4. APAA quality and selection without gradient, over positives compacted
     to max_pos per image;
  5. focal cls loss over the selected positives, convex GIoU and spatial
     border losses for refine (selected candidates) and init (per level,
     over the init assignment).

Batch layout: gt_polys (B, G, 8), gt_labels (B, G) 1-based, gt_valid
(B, G), img_hw (B, 2) true sizes inside the padded canvas.  Head outputs are
per-level NHWC lists, as the port's head returns them.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import torch

from ..ops.deform_conv import bilinear_gather
from ..ops.nms import topk_stable
from ..utils.profiling import annotate
from . import points as P
from .apaa import (compact_positives, gather_rows, quality_assessment,
                   sample_selection)
from .losses import focal_loss, giou_loss, spatial_border_loss
from .targets import init_targets, refine_targets


@dataclasses.dataclass(frozen=True)
class LossConfig:
    strides: Sequence[int] = (8, 16, 32, 64, 128)
    point_base_scale: float = 2.0
    num_points: int = 9
    max_pos: int = 1024  # cap on positive candidates per image
    top_ratio: float = 0.4
    per_level_topk: int = 6
    init_assign_scale: float = 4.0
    init_assign_pos_num: int = 1
    pos_iou_thr: float = 0.1
    neg_iou_thr: float = 0.1
    min_pos_iou: float = 0.0
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 1.0
    loss_rbox_init_weight: float = 0.375
    loss_rbox_refine_weight: float = 1.0
    loss_spatial_init_weight: float = 0.05
    loss_spatial_refine_weight: float = 0.1


def sample_point_features(base_feats, pts, level_ids_cand, strides):
    """Per-point features at the refine points: base_feats per-level
    (B, H, W, C) maps, pts (B, P, 18) image coords, level_ids_cand (B, P).
    Sampled as grid_sample with align_corners=False does, at
    loc / stride - 0.5 with zero padding, in f32 -> (B, P, 9, C)."""
    b, p, _ = pts.shape
    xy = pts.reshape(b, p, 9, 2)
    out = None
    for lvl, feat in enumerate(base_feats):
        s = float(strides[lvl])
        samp = bilinear_gather(feat.to(torch.float32), xy[..., 1] / s - 0.5,
                               xy[..., 0] / s - 0.5)
        sel = (level_ids_cand == lvl)[..., None, None]
        out = samp * sel if out is None else out + samp * sel
    return out


def _concat_levels(maps):
    """Per-level (B, H, W, C) maps -> (B, sum HW, C) f32."""
    return torch.cat([m.reshape(m.shape[0], -1, m.shape[-1]).float()
                      for m in maps], 1)


def _decode_levels(offsets, strides):
    """Per-level (dy, dx) offset maps -> (B, sum HW, 18) f32 point sets."""
    return torch.cat([P.offset_to_pts(m.float(), s)
                      for m, s in zip(offsets, strides)], 1)


def compute_losses(outs, gt_polys, gt_labels, gt_valid, img_hw,
                   cfg: LossConfig, stats: dict | None = None, reduce=None):
    """The loss dict: loss_cls, loss_rbox_init, loss_rbox_refine,
    loss_spatial_init, loss_spatial_refine (the init losses summed over
    levels), num_pos, num_assigned_pos, overflow_pos.

    reduce: for one rank of a data-parallel group, a function summing a
    tensor over the group.  Every count a loss divides by or is gated on
    (num_pos, each level's n_lvl, the spatial losses' outside points and
    positives) is then the global batch's, so each loss is this rank's sum
    over the global count and the group's sum is the one-process loss of
    the global batch; the counts returned stay this rank's.  None: one
    process.

    stats, when a dict, receives the refine assignment (gt_inds (B, N)) and
    the per-image share of valid (gt, point set) pairs with IoU > 0.1
    (iou_gt_0p1), for diagnostics."""
    with annotate("orp.loss"):
        return _losses(outs, gt_polys, gt_labels, gt_valid, img_hw, cfg,
                       stats, reduce)


def _losses(outs, gt_polys, gt_labels, gt_valid, img_hw, cfg, stats,
            reduce):
    """compute_losses' body, in three ranges that tile it: the targets
    (orp.loss.assign), APAA (orp.loss.apaa) and the loss terms
    (orp.loss.terms)."""
    with annotate("orp.loss.assign"):
        cls_maps = outs["cls_scores"]
        dev = cls_maps[0].device
        img_size = (cls_maps[0].shape[1] * cfg.strides[0],
                    cls_maps[0].shape[2] * cfg.strides[0])
        sizes = [h * w for h, w in P.level_shapes(img_size, cfg.strides)]
        bounds = [0, *itertools.accumulate(sizes)]
        level_ids = torch.repeat_interleave(
            torch.arange(len(sizes), device=dev),
            torch.tensor(sizes, device=dev))
        grid = torch.cat(P.multi_level_grid_points(img_size, cfg.strides,
                                                   dev))
        stride_per_pt = grid[:, 2]  # rows (x, y, stride)

        cls_scores = _concat_levels(cls_maps)  # (B, N, C)
        pts_init = _decode_levels(outs["pts_init"], cfg.strides)
        pts_refine = _decode_levels(outs["pts_refine"], cfg.strides)

        img_hw = img_hw.to(dev)
        points_valid = torch.cat(
            P.multi_level_valid_flags(img_size, cfg.strides, img_hw), 1)

        init_tg = init_targets(grid, points_valid, gt_polys, gt_valid,
                               gt_labels, scale=cfg.init_assign_scale,
                               pos_num=cfg.init_assign_pos_num)
        refine_tg = refine_targets(pts_init.detach(), points_valid,
                                   gt_polys, gt_valid, gt_labels,
                                   pos_iou_thr=cfg.pos_iou_thr,
                                   neg_iou_thr=cfg.neg_iou_thr,
                                   min_pos_iou=cfg.min_pos_iou, stats=stats)

    with annotate("orp.loss.apaa"):
        # ---- APAA, without gradient ---------------------------------------
        with torch.no_grad():
            cand = compact_positives(refine_tg.gt_inds, level_ids,
                                     cfg.max_pos)
            pts_feats = sample_point_features(
                outs["base_feats"], gather_rows(pts_refine, cand.idx),
                cand.level, cfg.strides)
            quality = quality_assessment(
                cand, cls_scores, pts_init, pts_refine, refine_tg.labels,
                refine_tg.gt_polys, pts_feats, gamma=cfg.focal_gamma,
                alpha=cfg.focal_alpha)
            keep = sample_selection(cand, quality, gt_polys.shape[1],
                                    len(cfg.strides),
                                    per_level_topk=cfg.per_level_topk,
                                    top_ratio=cfg.top_ratio)
        num_pos = keep.sum()
        num_pos_all = num_pos if reduce is None else reduce(num_pos.clone())
        pos_per_img = (refine_tg.gt_inds > 0).sum(1)
        overflow_pos = torch.clamp(pos_per_img - cfg.max_pos, min=0).sum()

        # ---- unselected positives become background ------------------------
        sel_full = torch.zeros_like(points_valid)
        sel_full.scatter_(1, cand.idx, keep)
        was_pos = refine_tg.gt_inds > 0
        labels_final = torch.where(was_pos & ~sel_full, 0, refine_tg.labels)

    with annotate("orp.loss.terms"):
        has_pos = (num_pos_all > 0).to(torch.float32)
        loss_cls = focal_loss(cls_scores, labels_final,
                              refine_tg.label_weights,
                              avg_factor=num_pos_all, gamma=cfg.focal_gamma,
                              alpha=cfg.focal_alpha,
                              loss_weight=cfg.loss_cls_weight) * has_pos

        # ---- refine losses over the selected candidates --------------------
        nrm = cfg.point_base_scale * stride_per_pt[cand.idx][..., None]
        pred_cand = (gather_rows(pts_refine, cand.idx) / nrm).reshape(-1, 18)
        gt_cand = (gather_rows(refine_tg.gt_polys, cand.idx) / nrm).reshape(
            -1, 8)
        w_keep = keep.to(torch.float32).reshape(-1)
        loss_rbox_refine = giou_loss(
            pred_cand, gt_cand, w_keep, divisor=num_pos_all,
            loss_weight=cfg.loss_rbox_refine_weight) * has_pos
        loss_spatial_refine = spatial_border_loss(
            pred_cand, gt_cand, w_keep,
            loss_weight=cfg.loss_spatial_refine_weight,
            reduce=reduce) * has_pos

        # ---- init losses per level, over max_gt * pos_num rows each ---------
        max_gt = gt_polys.shape[1]
        loss_rbox_init = loss_spatial_init = 0.0
        for lvl, s in enumerate(cfg.strides):
            lo, hi = bounds[lvl], bounds[lvl + 1]
            norm = cfg.point_base_scale * float(s)
            k = min(max_gt * cfg.init_assign_pos_num, hi - lo)
            w_top, top_idx = topk_stable(init_tg.pos_weights[:, lo:hi], k)
            pred = (gather_rows(pts_init[:, lo:hi], top_idx) / norm).reshape(
                -1, 18)
            gt = (gather_rows(init_tg.gt_polys[:, lo:hi], top_idx)
                  / norm).reshape(-1, 8)
            w = w_top.reshape(-1)
            n_lvl = (w > 0).sum()
            if reduce is not None:
                n_lvl = reduce(n_lvl)
            has = (n_lvl > 0).to(torch.float32)
            loss_rbox_init = loss_rbox_init + giou_loss(
                pred, gt, w, divisor=n_lvl,
                loss_weight=cfg.loss_rbox_init_weight) * has
            loss_spatial_init = loss_spatial_init + spatial_border_loss(
                pred, gt, w, loss_weight=cfg.loss_spatial_init_weight,
                reduce=reduce) * has

        if stats is not None:
            pairs = gt_valid[..., None] & points_valid[:, None, :]
            stats["gt_inds"] = refine_tg.gt_inds
            stats["iou_gt_0p1"] = ((stats.pop("overlaps") > 0.1).sum((1, 2))
                                   / pairs.sum((1, 2)).clamp(min=1))
        return {
            "loss_cls": loss_cls,
            "loss_rbox_init": loss_rbox_init,
            "loss_rbox_refine": loss_rbox_refine,
            "loss_spatial_init": loss_spatial_init,
            "loss_spatial_refine": loss_spatial_refine,
            "num_pos": num_pos.to(torch.float32),
            "num_assigned_pos": pos_per_img.sum().to(torch.float32),
            "overflow_pos": overflow_pos.to(torch.float32),
        }

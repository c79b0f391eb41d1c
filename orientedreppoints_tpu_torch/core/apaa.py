"""APAA: adaptive points assessment and assignment, batched over images
(counterpart of core/apaa.py).

Quality Q per positive candidate (lower is better) = focal cls loss
+ 0.2 (loc_init + 0.3 ori_init) + 0.8 (loc_refine + 0.3 ori_refine)
+ 0.1 feature dissimilarity; per (gt, level) the 6 lowest, pooled per gt,
keep ceil(0.4 n) (all when n < 2).  Positives are first compacted to a
fixed max_pos candidate set.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.geometry import chamfer_distance_2d, convex_giou
from ..ops.minarearect import min_area_rect
from ..ops.nms import topk_stable
from .losses import sigmoid_focal_loss_elementwise

_INF = float("inf")


def sample_edge_points(quads: torch.Tensor, points_per_edge: int = 10):
    """(..., 8) quads -> (..., 4 * points_per_edge, 2): per edge, points
    from corner i towards corner i + 1 at linspace(0, 1)."""
    q = quads.reshape(quads.shape[:-1] + (4, 2))
    t = torch.linspace(0.0, 1.0, points_per_edge, device=quads.device)
    t = t[:, None]
    starts = q[..., :, None, :]
    ends = torch.roll(q, -1, dims=-2)[..., :, None, :]
    pts = (1 - t) * starts + t * ends
    return pts.reshape(quads.shape[:-1] + (4 * points_per_edge, 2))


class PosCandidates(NamedTuple):
    idx: torch.Tensor  # (B, P) int64 point indices into the N grid points
    mask: torch.Tensor  # (B, P) bool
    gt_idx: torch.Tensor  # (B, P) 0-based gt index
    level: torch.Tensor  # (B, P) level id


def compact_positives(gt_inds, level_ids, max_pos: int) -> PosCandidates:
    """Up to max_pos positives per image as a fixed-size candidate set.

    gt_inds (B, N) 1-based; level_ids (N,).  Beyond max_pos, the survivors
    are the positives of least Knuth hash (i * 2654435761) mod 2^31 of
    their index, then re-sorted by index, as in the JAX package (the low
    31 bits of the int64 product equal those of its uint32 wraparound).
    """
    n = gt_inds.shape[1]
    pos = gt_inds > 0
    arange = torch.arange(n, dtype=torch.int64, device=gt_inds.device)
    prio = (arange * 2654435761) & 0x7FFFFFFF
    score = torch.where(pos, prio, 0xFFFFFFFF)
    sel = torch.argsort(score, dim=1, stable=True)[:, :max_pos]
    idx = torch.sort(sel, dim=1).values
    gi = torch.gather(gt_inds, 1, idx)
    return PosCandidates(idx=idx, mask=torch.gather(pos, 1, idx),
                         gt_idx=torch.clamp(gi - 1, min=0),
                         level=level_ids[idx])


def feature_dissimilarity(pts_features: torch.Tensor) -> torch.Tensor:
    """(..., 9, C) sampled point features -> (...,): max over the points of
    1 - cosine similarity to the mean point feature (norms clamped at
    1e-2, the cosine's denominator at 1e-6)."""
    feats = pts_features.to(torch.float32)
    mean_f = feats.mean(-2, keepdim=True)
    norm_f = torch.clamp(torch.linalg.norm(feats, dim=-1, keepdim=True),
                         min=1e-2)
    norm_m = torch.clamp(torch.linalg.norm(mean_f, dim=-1, keepdim=True),
                         min=1e-2)
    u = feats / norm_f
    um = mean_f / norm_m
    dot = (u * um).sum(-1)
    denom = torch.clamp(torch.linalg.norm(u, dim=-1)
                        * torch.linalg.norm(um, dim=-1), min=1e-6)
    return (1.0 - dot / denom).amax(-1)


def gather_rows(x, idx):
    """x (B, N, ...) rows at idx (B, P) -> (B, P, ...)."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def quality_assessment(cand: PosCandidates, cls_scores, pts_init, pts_refine,
                       labels, target_polys, pts_features,
                       gamma: float = 2.0, alpha: float = 0.25):
    """Per-candidate quality (B, P), +inf at masked slots.  cls_scores
    (B, N, C) logits; pts_init, pts_refine (B, N, 18); labels (B, N);
    target_polys (B, N, 8); pts_features (B, P, 9, C)."""
    idx = cand.idx
    qua_cls = sigmoid_focal_loss_elementwise(
        gather_rows(cls_scores, idx), gather_rows(labels, idx), gamma,
        alpha).sum(-1)
    init_p = gather_rows(pts_init, idx).reshape(-1, 18)
    refine_p = gather_rows(pts_refine, idx).reshape(-1, 18)
    gt_q = gather_rows(target_polys, idx).reshape(-1, 8)
    samp_gt = sample_edge_points(gt_q)
    qua_ori_init = chamfer_distance_2d(
        samp_gt, sample_edge_points(min_area_rect(init_p.contiguous())))
    qua_ori_refine = chamfer_distance_2d(
        samp_gt, sample_edge_points(min_area_rect(refine_p.contiguous())))
    qua_loc_init = 1.0 - convex_giou(init_p, gt_q)
    qua_loc_refine = 1.0 - convex_giou(refine_p, gt_q)
    shape = idx.shape
    q = (qua_cls
         + 0.2 * (qua_loc_init + 0.3 * qua_ori_init).reshape(shape)
         + 0.8 * (qua_loc_refine + 0.3 * qua_ori_refine).reshape(shape)
         + 0.1 * feature_dissimilarity(pts_features))
    return torch.where(cand.mask, q, _INF)


def sample_selection(cand: PosCandidates, quality, num_gt: int,
                     num_levels: int, per_level_topk: int = 6,
                     top_ratio: float = 0.4):
    """Keep mask (B, P): per (gt, level) the per_level_topk lowest quality,
    pooled per gt and sorted, the first ceil(top_ratio * n) (all if
    n < 2)."""
    b, p = quality.shape
    dev = quality.device
    gt_onehot = cand.gt_idx[:, None, :] == torch.arange(num_gt,
                                                        device=dev)[:, None]
    lvl_onehot = cand.level[:, None, :] == torch.arange(
        num_levels, device=dev)[:, None]
    m = (gt_onehot[:, :, None] & lvl_onehot[:, None] & cand.mask[:, None,
                                                                  None])
    qm = torch.where(m, quality[:, None, None, :], _INF)  # (B, G, L, P)

    k = min(per_level_topk, p)
    neg_top, top_idx = topk_stable(-qm, k)
    top_q = -neg_top
    pool_q = top_q.reshape(b, num_gt, -1)
    pool_idx = top_idx.reshape(b, num_gt, -1)
    pool_valid = torch.isfinite(pool_q)
    order = torch.argsort(torch.where(pool_valid, pool_q, _INF), dim=-1,
                          stable=True)
    sorted_idx = torch.gather(pool_idx, -1, order)
    sorted_valid = torch.gather(pool_valid, -1, order)

    n_g = sorted_valid.sum(-1).to(torch.int32)  # (B, G)
    keep_k = torch.ceil(top_ratio * n_g.to(torch.float32)).to(torch.int32)
    keep_k = torch.where(n_g < 2, n_g, keep_k)
    rank = torch.arange(pool_q.shape[-1], device=dev)
    keep_slot = (rank < keep_k[..., None]) & sorted_valid

    keep = torch.zeros((b, p), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)[:, None, None].expand_as(sorted_idx)
    keep[rows[keep_slot], sorted_idx[keep_slot]] = True
    return keep & cand.mask

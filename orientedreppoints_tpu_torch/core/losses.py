"""Training losses (counterpart of core/losses.py): sigmoid focal, convex
GIoU with the reference's gradient filter, the spatial-border penalty and
the plain convex IoU loss.

All are masked and fixed-shape: rows of weight 0 are inert, and divisors
are passed explicitly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.geometry import convex_iou_aligned, points_in_polygon
from ..ops.giou import convex_giou_grad


def sigmoid_focal_loss_elementwise(logits: torch.Tensor, labels: torch.Tensor,
                                   gamma: float = 2.0, alpha: float = 0.25):
    """Per-(row, class) focal loss; labels in [0, C], 0 = background, c > 0
    the 1-based foreground class."""
    num_classes = logits.shape[-1]
    t = F.one_hot(labels.long(), num_classes + 1)[..., 1:].to(logits.dtype)
    p = torch.sigmoid(logits)
    pt = (1 - p) * t + p * (1 - t)
    focal_weight = (alpha * t + (1 - alpha) * (1 - t)) * pt ** gamma
    bce = torch.clamp(logits, min=0) - logits * t + torch.log1p(
        torch.exp(-logits.abs()))
    return bce * focal_weight


def focal_loss(logits, labels, weight, avg_factor, gamma: float = 2.0,
               alpha: float = 0.25, loss_weight: float = 1.0):
    """loss_weight * sum(elementwise * row weight) / avg_factor."""
    loss = sigmoid_focal_loss_elementwise(logits, labels, gamma, alpha)
    loss = loss * weight[..., None]
    return loss_weight * loss.sum() / torch.clamp(
        torch.as_tensor(avg_factor, dtype=loss.dtype), min=1e-6)


class _GIoULossSum(torch.autograd.Function):
    """sum((1 - giou) * weight) / divisor, with the reference's backward
    (iou_loss.py): d(giou)/d(pred) rows scaled by weight; rows with any
    component > 1 (signed) replaced by +1e-6; the result times
    -loss_weight / divisor.  The upstream grad is ignored, as the reference
    Function ignores it, so scaling the loss afterwards scales only its
    value.  The GIoU and its weighted gradient come from one call of
    orp::convex_giou_grad (the CUDA kernel; on the CPU autograd through
    geometry.convex_giou)."""

    @staticmethod
    def forward(ctx, pred, target, weight, divisor, loss_weight):
        div = torch.clamp(divisor.to(torch.float32), min=1e-6)
        giou, dgiou = convex_giou_grad(pred.detach(), target, weight)
        ctx.save_for_backward(dgiou, div)
        ctx.loss_weight = loss_weight
        return ((1.0 - giou) * weight).sum() / div

    @staticmethod
    def backward(ctx, grad_output):
        dgiou, div = ctx.saved_tensors
        bad = (dgiou > 1.0).any(-1, keepdim=True)
        grad = torch.where(bad, 1e-6, dgiou)
        return -grad / div * ctx.loss_weight, None, None, None, None


def giou_loss(pred_pts, target_quads, weight, divisor,
              loss_weight: float = 1.0):
    """Masked convex GIoU loss: pred (M, 18), targets (M, 8), weight (M,);
    divisor is the count of rows the reference would have selected.
    Returns loss_weight * sum((1 - giou) * weight) / divisor with the
    reference's filtered backward."""
    divisor = torch.as_tensor(divisor, device=pred_pts.device)
    return loss_weight * _GIoULossSum.apply(
        pred_pts, target_quads, weight, divisor, loss_weight)


def spatial_border_loss(pts, gt_quads, weight, loss_weight: float = 1.0,
                        reduce=None):
    """0.2 x distance to the gt centre for points outside their gt quad,
    averaged over those points, over (n_pos + 1e-6).

    pts (M, 18), gt_quads (M, 8), weight (M,) positive mask.  reduce, when
    given, sums the two counts over a data-parallel group (the global
    batch's outside points and positives) before the divisions."""
    m = pts.shape[0]
    p = pts.reshape(m, 9, 2)
    quads = gt_quads.reshape(m, 4, 2)
    inside = points_in_polygon(p, quads)
    pos = weight > 0
    outside = ~inside & pos[:, None]
    center = (quads[:, 0] + quads[:, 2]) / 2.0
    d = torch.sqrt(((p - center[:, None, :]) ** 2).sum(-1) + 1e-12)
    n_out = outside.sum()
    n_pos = pos.sum()
    if reduce is not None:
        n_out, n_pos = reduce(n_out), reduce(n_pos)
    out_term = torch.where(outside, 0.2 * d, 0.0).sum() / torch.clamp(
        n_out, min=1)
    return loss_weight * out_term / (n_pos.to(pts.dtype) + 1e-6)


def iou_loss(pred_pts, target_quads, weight, divisor,
             loss_weight: float = 1.0, eps: float = 1e-6):
    """-log(convex IoU) of each point set's hull with its gt quad, masked
    mean (the reference IoULoss, iou_loss.py:14-62, of the original
    RepPoints recipe; no config uses it): pred (M, 18), targets (M, 8),
    weight (M,) -> loss_weight * sum(-log(max(iou, eps)) * weight) /
    max(divisor, 1e-6), with plain autograd."""
    ious = convex_iou_aligned(pred_pts, target_quads)
    loss = -torch.log(torch.clamp(ious, min=eps))
    divisor = torch.as_tensor(divisor, dtype=loss.dtype,
                              device=loss.device)
    return loss_weight * (loss * weight).sum() / torch.clamp(divisor,
                                                             min=1e-6)

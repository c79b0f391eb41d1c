"""Rotated NMS: batched and single-image multiclass, greedy and soft, and
horizontal-box greedy and soft NMS (counterpart of ops/nms.py).

The JAX package's TPU workarounds are not carried over: the blocked,
unrolled fori_loop scan becomes one CUDA kernel over the bitmask
(csrc/nms_scan.cu), and the shift-add prefix sum becomes torch.cumsum.
The soft-NMS decay loop (an XLA while_loop in the JAX package) is a Python
loop of small device ops here, with one host sync per selection.
"""

from __future__ import annotations

import torch

from . import _ext
from .quad_iou import (_live, pack_bits, quad_iou_matrix, quad_over_mask,
                       quad_over_matrix)

_NEG = -1e9


def topk_stable(x: torch.Tensor, k: int):
    """Top k along the last dim, equal values in index order, as
    jax.lax.top_k orders them (torch.topk leaves that order open)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def greedy_scan_plain(mask: torch.Tensor, valid: torch.Tensor,
                      num_valid: torch.Tensor) -> torch.Tensor:
    """Plain version: walk the rows in order over the (B, N, W) bitmask."""
    b, n = valid.shape
    removed = torch.zeros(mask.shape[0], mask.shape[2], dtype=torch.int64,
                          device=mask.device)
    nv = num_valid.to(mask.device)
    for i in range(int(nv.max()) if b else 0):
        bit = (removed[:, i // 64] >> (i % 64)) & 1
        keep_i = valid[:, i] & (bit == 0) & (i < nv)
        removed |= torch.where(keep_i[:, None], mask[:, i], 0)
    cols = torch.arange(n, device=mask.device)
    bits = (removed[:, cols // 64] >> (cols % 64)) & 1
    return valid & (bits == 0)


@torch.library.custom_op("orp::greedy_scan", mutates_args=(),
                         device_types="cpu")
def greedy_scan(mask: torch.Tensor, valid: torch.Tensor,
                num_valid: torch.Tensor) -> torch.Tensor:
    """Greedy suppression over score-sorted rows.

    mask: (B, N, W) int64 bitmask from quad_over_mask (row i suppresses
    column j > i where its bit is set; bits at j <= i are 0, which the
    kernel relies on); valid: (B, N) bool;
    num_valid: (B,) int32 valid-prefix lengths.  Returns keep (B, N) bool:
    the custom op orp::greedy_scan.
    """
    return greedy_scan_plain(mask, valid, num_valid)


@greedy_scan.register_kernel("cuda")
def _(mask, valid, num_valid):
    return greedy_scan_kernel(mask, valid, num_valid)


@greedy_scan.register_fake
def _(mask, valid, num_valid):
    return valid.new_empty(valid.shape, dtype=torch.bool)


def greedy_scan_kernel(mask, valid, num_valid):
    b, n = valid.shape
    _ext.check_cuda(mask, "mask", torch.int64, (b, n, (n + 63) // 64))
    _ext.check_cuda(valid, "valid", torch.bool, (b, n), mask.device)
    _ext.check_cuda(num_valid, "num_valid", torch.int32, (b,), mask.device)
    keep = torch.empty((b, n), dtype=torch.bool, device=mask.device)
    _ext.launch("orp_nms_scan", mask.data_ptr(), valid.data_ptr(),
                num_valid.data_ptr(), keep.data_ptr(), b, n, on=mask)
    greedy_scan_kernel.launches += 1
    return keep


greedy_scan_kernel.launches = 0


def compact_keep_sorted(keep: torch.Tensor, scores: torch.Tensor,
                        k_out: int):
    """First k_out kept rows of score-descending candidates, in order.

    Returns (out_scores, out_rank, det_valid), each (B, k_out); out_scores
    is 0 where invalid.
    """
    b, n = keep.shape
    kcum = torch.cumsum(keep.to(torch.int32), 1)
    targets = torch.arange(1, k_out + 1, dtype=torch.int32,
                           device=keep.device).expand(b, k_out).contiguous()
    # smallest i with kcum[i] >= j + 1
    out_rank = torch.searchsorted(kcum, targets).clamp(max=n - 1)
    det_valid = targets <= kcum[:, -1:]
    out_scores = torch.where(det_valid, torch.gather(scores, 1, out_rank),
                             0.0)
    return out_scores, out_rank, det_valid


def multiclass_rnms_batch(bboxes: torch.Tensor, scores: torch.Tensor,
                          score_thr: float, iou_thr: float, max_per_img: int,
                          reppoints: torch.Tensor | None = None,
                          pre_nms_cap: int = 4096):
    """Batched multiclass rotated NMS with fixed output shapes.

    bboxes (B, N, 8), scores (B, N, C+1) with column 0 the background pad,
    reppoints (B, N, 18) optional.  Candidates are the top pre_nms_cap
    (box, class) pairs above score_thr; classes are kept apart by the
    class-offset trick; suppression is strict IoU > iou_thr.
    Returns dets (B, max_per_img, 27|9) [reppoints?, poly, score], labels
    (B, max_per_img) int64 0-based, valid (B, max_per_img) bool; kept rows
    in score order.
    """
    b, n, _ = bboxes.shape
    num_classes = scores.shape[2] - 1
    flat_scores = scores[:, :, 1:].reshape(b, -1)
    cap = min(pre_nms_cap, n * num_classes)
    top_scores, top_idx = topk_stable(
        torch.where(flat_scores > score_thr, flat_scores, _NEG), cap)
    top_valid = top_scores > score_thr
    top_labels = top_idx % num_classes
    box_idx = top_idx // num_classes

    def gather(arr, idx):
        return torch.gather(arr, 1, idx[..., None].expand(-1, -1,
                                                           arr.shape[-1]))

    top_boxes = gather(bboxes, box_idx)
    max_coord = torch.where(top_valid[..., None], top_boxes,
                            0.0).amax(dim=(1, 2), keepdim=True)
    boxes_for_nms = top_boxes + top_labels.to(top_boxes.dtype)[..., None] * (
        max_coord + 1.0)

    nv = top_valid.sum(1, dtype=torch.int32)
    mask = quad_over_mask(boxes_for_nms.contiguous(), iou_thr, nv)
    keep = greedy_scan(mask, top_valid, nv)

    k_out = min(max_per_img, cap)
    out_scores, out_rank, det_valid = compact_keep_sorted(keep, top_scores,
                                                          k_out)
    out_boxes = gather(top_boxes, out_rank)
    out_labels = torch.where(det_valid, torch.gather(top_labels, 1,
                                                     out_rank), 0)
    parts = [out_boxes, out_scores[..., None]]
    if reppoints is not None:
        parts.insert(0, gather(gather(reppoints, box_idx), out_rank))
    dets = torch.where(det_valid[..., None], torch.cat(parts, 2), 0.0)
    if max_per_img > cap:
        pad = max_per_img - cap
        dets = torch.nn.functional.pad(dets, (0, 0, 0, pad))
        out_labels = torch.nn.functional.pad(out_labels, (0, pad))
        det_valid = torch.nn.functional.pad(det_valid, (0, pad))
    return dets, out_labels, det_valid


def multiclass_rnms(bboxes: torch.Tensor, scores: torch.Tensor,
                    score_thr: float, iou_thr: float, max_per_img: int,
                    reppoints: torch.Tensor | None = None,
                    pre_nms_cap: int = 4096):
    """Single-image multiclass rotated NMS: bboxes (N, 8), scores (N, C+1),
    reppoints (N, 18) optional -> dets (max_per_img, 27|9), labels, valid;
    multiclass_rnms_batch over a batch of one (one batch-1 over-mask
    launch, the single-image entry of the JAX package)."""
    dets, labels, valid = multiclass_rnms_batch(
        bboxes[None], scores[None], score_thr, iou_thr, max_per_img,
        None if reppoints is None else reppoints[None], pre_nms_cap)
    return dets[0], labels[0], valid[0]


def rotated_nms_mask(quads: torch.Tensor, scores: torch.Tensor,
                     iou_thr: float, valid: torch.Tensor | None = None):
    """Greedy rotated NMS of (N, 8) quads by descending (N,) score; invalid
    rows are never kept.  Returns keep (N,) bool in the original order.

    Equal scores are taken in descending index order, as the JAX package's
    reversed ascending argsort takes them."""
    n = quads.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=quads.device)
    order = torch.argsort(torch.where(valid, scores, _NEG),
                          stable=True).flip(0)
    svalid = valid[order]
    nv = svalid.sum(dtype=torch.int32)
    mask = quad_over_matrix(quads[order].to(torch.float32).contiguous(),
                            iou_thr, nv)
    keep_sorted = greedy_scan(mask[None], svalid[None], nv.reshape(1))[0]
    keep = torch.zeros(n, dtype=torch.bool, device=quads.device)
    keep[order] = keep_sorted
    return keep


def _soft_suppress(iou, scores, valid, method: str, sigma: float,
                   iou_thr: float, min_score: float,
                   max_keep: int | None = None):
    """Soft-NMS decay loop over a precomputed (N, N) IoU matrix.

    Repeatedly take the best unprocessed valid score; stop once it is
    <= min_score (every later pick would fail too, so the kept set is
    exact) or max_keep picks are made; decay every other row's score —
    linear: s *= 1 - iou where iou > iou_thr; gaussian: s *= exp(-iou^2 /
    sigma).  Returns (decayed scores, keep).  One host sync per pick.
    """
    n = scores.shape[0]
    cap = n if max_keep is None else min(n, int(max_keep))
    cur = scores.to(torch.float32).clone()
    processed = torch.zeros(n, dtype=torch.bool, device=scores.device)
    for _ in range(cap):
        masked = torch.where(processed | ~valid, _NEG, cur)
        j = torch.argmax(masked)  # the first of equal maxima, as jnp.argmax
        if not bool(masked[j] > min_score):
            break
        processed[j] = True
        iou_j = iou[j]
        if method == "linear":
            decay = torch.where(iou_j > iou_thr, 1.0 - iou_j, 1.0)
        else:
            decay = torch.exp(-(iou_j * iou_j) / sigma)
        cur = cur * torch.where(processed, 1.0, decay)
    return cur, processed


def soft_rnms(quads: torch.Tensor, scores: torch.Tensor, iou_thr: float = 0.3,
              sigma: float = 0.5, min_score: float = 1e-3,
              method: str = "gaussian", valid: torch.Tensor | None = None,
              max_keep: int | None = None):
    """Soft-NMS over (N, 8) rotated quads with the exact quad IoU (the full
    f32 matrix: csrc/quad_iou.cu on CUDA).  Returns (decayed scores (N,),
    keep (N,) bool) in the original order."""
    if valid is None:
        valid = torch.ones(quads.shape[0], dtype=torch.bool,
                           device=quads.device)
    q = quads.to(torch.float32).contiguous()
    iou = quad_iou_matrix(q, q)
    return _soft_suppress(iou, scores, valid, method, sigma, iou_thr,
                          min_score, max_keep)


def hbb_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of horizontal boxes: a (N, 4), b (M, 4) x1y1x2y2 ->
    (N, M) float32."""
    return _hbb_iou(a, b, 0.0)


def hbb_iou_matrix_legacy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """hbb_iou_matrix in the reference CPU kernels' integer-pixel
    convention: widths, heights and areas with +1 (nms_cpu.cpp:19,52-53).
    Only nms_hbb and soft_nms_hbb use it."""
    return _hbb_iou(a, b, 1.0)


def _hbb_iou(a, b, one: float):
    a, b = a.to(torch.float32), b.to(torch.float32)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt + one, min=0.0)  # + 0.0 is exact
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0] + one) * (a[:, 3] - a[:, 1] + one)
    area_b = (b[:, 2] - b[:, 0] + one) * (b[:, 3] - b[:, 1] + one)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms_hbb(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
            valid: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy horizontal NMS (the reference nms_cpu.cpp): (N, 4) x1y1x2y2
    boxes by descending (N,) score, the legacy +1-pixel IoU, suppression
    at IoU >= iou_thr; invalid rows are never kept.  Returns keep (N,) bool
    in the original order.

    Equal scores are taken in descending index order, as the JAX package's
    reversed ascending argsort takes them.  The IoU matrix and its packed
    upper-triangle bits are plain PyTorch (XLA work in the JAX package);
    the suppression is the scan's custom op (csrc/nms_scan.cu on CUDA)."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    order = torch.argsort(torch.where(valid, scores, _NEG),
                          stable=True).flip(0)
    sboxes = boxes[order]
    svalid = valid[order]
    nv = svalid.sum(dtype=torch.int32).reshape(1)
    rows = torch.arange(n, device=boxes.device)
    over = (hbb_iou_matrix_legacy(sboxes, sboxes) >= iou_thr) & _live(
        rows[:, None], rows[None, :], nv)
    keep_sorted = greedy_scan(pack_bits(over)[None], svalid[None], nv)[0]
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = keep_sorted
    return keep


def soft_nms_hbb(boxes: torch.Tensor, scores: torch.Tensor,
                 iou_thr: float = 0.3, sigma: float = 0.5,
                 min_score: float = 1e-3, method: str = "linear",
                 valid: torch.Tensor | None = None,
                 max_keep: int | None = None):
    """Horizontal soft-NMS (the reference soft_nms entry, nms_cpu.cpp's
    soft_nms kernel and its defaults) over the legacy +1-pixel IoU.
    Returns (decayed scores (N,), keep (N,) bool) in the original order."""
    if valid is None:
        valid = torch.ones(boxes.shape[0], dtype=torch.bool,
                           device=boxes.device)
    iou = hbb_iou_matrix_legacy(boxes, boxes)
    return _soft_suppress(iou, scores, valid, method, sigma, iou_thr,
                          min_score, max_keep)

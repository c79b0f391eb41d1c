"""Head outputs -> detections: per level the top nms_pre locations by
their best class score, the refine point sets decoded to image
coordinates, each set's min-area rectangle, the scale factor undone, the
top pre_nms_cap (box, class) pairs above score_thr, and greedy rotated NMS
within each class (a box is dropped when its IoU with a kept box of the
same class and higher score exceeds iou_thr).  Ties in a ranking go to
the lower index."""

from __future__ import annotations

import numpy as np
import torch

from .geometry import min_area_rect, quad_iou

_CHUNK = 1 << 20  # pairs of quads held at once


def offset_to_pts(off: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, H, W, 2P) (dy, dx) offsets -> (B, H*W, 2P) (x, y) points."""
    b, h, w, c = off.shape
    xy = off.reshape(b, h * w, c // 2, 2).flip(-1)
    ys, xs = torch.meshgrid(torch.arange(h, device=off.device),
                            torch.arange(w, device=off.device), indexing="ij")
    ctr = torch.stack([xs, ys], -1).reshape(1, h * w, 1, 2).float() * stride
    return (xy * float(stride) + ctr).reshape(b, h * w, c)


def _top(x: torch.Tensor, k: int):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def candidates(outs: dict, strides, nms_pre: int):
    """-> (scores (B, N, C), point sets (B, N, 18))."""
    sc, pts = [], []
    for lvl, s in enumerate(strides):
        logits = outs["cls_scores"][lvl].float()
        b, h, w, c = logits.shape
        p = torch.sigmoid(logits.reshape(b, h * w, c))
        q = offset_to_pts(outs["pts_refine"][lvl].float(), s)
        idx = _top(p.amax(-1), min(nms_pre, h * w))[1]
        sc.append(torch.gather(p, 1, idx[..., None].expand(-1, -1, c)))
        pts.append(torch.gather(q, 1, idx[..., None].expand(-1, -1,
                                                             q.shape[-1])))
    return torch.cat(sc, 1), torch.cat(pts, 1)


def overlaps(boxes: torch.Tensor, labels: torch.Tensor, iou_thr: float):
    """Score-ordered rects (n, 8) and labels (n,) -> the pairs (i, j),
    i < j, of one class whose IoU (row i the subject) exceeds iou_thr.
    Pairs whose bounding boxes are apart have IoU 0 and are not clipped."""
    q = boxes.reshape(-1, 4, 2)
    lo, hi = q.amin(1), q.amax(1)
    near = ((lo[:, None] <= hi[None]) & (lo[None] <= hi[:, None])).all(-1)
    near &= labels[:, None] == labels[None]
    i, j = torch.nonzero(torch.triu(near, 1), as_tuple=True)
    iou = torch.cat([quad_iou(boxes[i[s:s + _CHUNK]], boxes[j[s:s + _CHUNK]])
                     for s in range(0, len(i), _CHUNK)] or
                    [boxes.new_zeros(0)])
    over = iou > iou_thr
    return i[over].cpu().numpy(), j[over].cpu().numpy()


def greedy_keep(n: int, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """Greedy suppression in score order over the pairs (i, j), i < j:
    a kept row drops every j it overlaps."""
    order = np.argsort(i, kind="stable")
    i, j = i[order], j[order]
    starts = np.searchsorted(i, np.arange(n + 1))
    removed = np.zeros(n, bool)
    keep = np.zeros(n, bool)
    for r in range(n):
        if not removed[r]:
            keep[r] = True
            removed[j[starts[r]:starts[r + 1]]] = True
    return keep


def nms_image(rects, scores, score_thr, iou_thr, max_per_img, pre_nms_cap):
    """One image: rects (N, 8), scores (N, C) -> (dets (k, 9) float32 numpy
    [poly, score] in score order, labels (k,) 0-based)."""
    n, c = scores.shape
    flat = scores.reshape(-1)
    vals, idx = _top(torch.where(flat > score_thr, flat, -1.0),
                     min(pre_nms_cap, n * c))
    ok = vals > score_thr
    vals, idx = vals[ok], idx[ok]
    labels, boxes = idx % c, rects[idx // c]
    keep = greedy_keep(len(idx), *overlaps(boxes, labels, iou_thr))
    kept = np.nonzero(keep)[0][:max_per_img]
    dets = torch.cat([boxes, vals[:, None]], 1).cpu().numpy()[kept]
    return dets.astype(np.float32), labels.cpu().numpy()[kept]


def detect(outs: dict, test_cfg: dict, scale_factors,
           strides=(8, 16, 32, 64, 128), precision: str | None = None):
    """Head outputs of a batch -> per image (dets (k, 9), labels (k,)).
    precision: the point sets, scores and rectangles rounded to this
    dtype at each stage (the control's decode); None: float32."""
    sc, pts = candidates(outs, strides, test_cfg["nms_pre"])
    if precision is not None:
        dt = getattr(torch, precision)
        sc, pts = sc.to(dt).float(), pts.to(dt).float()
    b, n, _ = pts.shape
    rects = min_area_rect(pts.reshape(b * n, -1)).reshape(b, n, 8)
    if precision is not None:
        rects = rects.to(dt).float()
    out = []
    for i, sf in enumerate(scale_factors):
        out.append(nms_image(rects[i] / float(sf), sc[i],
                             test_cfg["score_thr"],
                             test_cfg["nms"]["iou_thr"],
                             test_cfg["max_per_img"],
                             test_cfg.get("pre_nms_cap", 4096)))
    return out


def per_class(dets: np.ndarray, labels: np.ndarray, num_fg: int) -> list:
    """(k, 9) detections -> num_fg per-class (k_c, 9) arrays."""
    return [dets[labels == i] for i in range(num_fg)]

"""The numbers that decide `correct`, each a gap of the program's output
from the reference's (0 where they agree)."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.geometry import quad_iou

DEVICE = "cuda" if torch.cuda.is_available() else "cpu"


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_l2(prog: dict, ref: dict, keys) -> dict:
    """Per key ||prog - ref|| / ||ref|| over all levels."""
    out = {}
    for k in keys:
        num = sum(float(((p.float() - r.float()) ** 2).sum())
                  for p, r in zip(prog[k], ref[k]))
        den = sum(float((r.float() ** 2).sum()) for r in ref[k])
        out[k] = (num / max(den, 1e-30)) ** 0.5
    return out


def _best_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """For each quad of a (n, 8), its best IoU with a quad of b (m, 8)."""
    if len(a) == 0:
        return np.zeros(0)
    if len(b) == 0:
        return np.zeros(len(a))
    ta = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)
    tb = torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(DEVICE)
    return quad_iou(ta[:, None], tb[None]).amax(1).cpu().numpy()


def missed_share(ref: list, prog: list, top_k: int, iou: float) -> float:
    """Share of the reference's top_k detections an image (by score) that
    the program's detections of that image miss: none of the same class
    overlaps it by IoU >= iou.  ref: per image (dets (k, 9), labels);
    prog: per image the per-class (k_c, 9) arrays."""
    missed = total = 0
    for (dets, labels), per_cls in zip(ref, prog):
        order = np.argsort(-dets[:, 8], kind="stable")[:top_k]
        for c in np.unique(labels[order]):
            rows = dets[order][labels[order] == c]
            best = _best_iou(rows[:, :8], per_cls[c][:, :8])
            missed += int((best < iou).sum())
            total += len(rows)
    return missed / max(total, 1)


def unmatched_share(ref: list, prog: list, iou: float,
                    score_tol: float) -> float:
    """Share of detections without a partner on the other side: same
    class, IoU >= iou, scores within score_tol (max over both
    directions, over all images)."""
    worst = 0.0
    for (dets, labels), per_cls in zip(ref, prog):
        n_ref, n_prog = len(dets), sum(len(p) for p in per_cls)
        miss_ref = miss_prog = 0
        for c in range(len(per_cls)):
            r, p = dets[labels == c], per_cls[c]
            for a, b in ((r, p), (p, r)):
                if len(a) == 0:
                    continue
                if len(b) == 0:
                    m = len(a)
                else:
                    ta = torch.from_numpy(np.ascontiguousarray(
                        a[:, :8])).to(DEVICE)
                    tb = torch.from_numpy(np.ascontiguousarray(
                        b[:, :8])).to(DEVICE)
                    ious = quad_iou(ta[:, None], tb[None]).cpu().numpy()
                    close = np.abs(a[:, 8:9] - b[None, :, 8]) <= score_tol
                    m = int((~((ious >= iou) & close).any(1)).sum())
                if a is r:
                    miss_ref += m
                else:
                    miss_prog += m
        worst = max(worst, miss_ref / max(n_ref, 1),
                    miss_prog / max(n_prog, 1))
    return worst


def leaf_gap(prog: dict, ref: dict, leaves) -> float:
    """Worst leaf of | ||prog|| - ||ref|| | over max(||ref||, the median
    leaf's ||ref||); prog, ref: {leaf: norm}."""
    leaves = list(leaves)
    if not leaves:
        return float("nan")
    med = float(np.median([ref[k] for k in leaves]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in leaves)

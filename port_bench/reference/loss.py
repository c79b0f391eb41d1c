"""The Oriented RepPoints training loss (Li et al. 2022), in two parts so
that a batch can be taken a few images at a time:

  * ``targets`` (no gradient): the point grid, the init assignment (each
    gt's nearest point on its scale's level), the refine assignment (max
    convex IoU of the init point sets' hulls with the gts, thresholds
    pos 0.1 / neg 0.1, then every proposal tying a gt's best IoU goes to
    the last such gt), APAA (quality of each positive from focal, GIoU,
    orientation chamfer and feature dissimilarity; per gt and level the 6
    best, the best 40% of their pool kept), and every count a loss divides
    by, for these images;
  * ``losses``: focal loss over all valid points, convex GIoU (with the
    published backward: rows of any grad component above 1 replaced by
    1e-6) and the spatial border loss over the kept refine positives and,
    per level, over the init assignment, each divided by the batch's
    counts (the sums of ``targets``' counts over all of its images).
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import torch
import torch.nn.functional as F

from .decode import offset_to_pts
from .detector import bilinear
from .geometry import (chamfer_distance_2d, convex_giou, convex_hull,
                       hull_quad_iou, min_area_rect, points_in_polygon)

_INF = float("inf")
_CHUNK = 1 << 20  # live (gt, point set) pairs clipped at once


@dataclasses.dataclass(frozen=True)
class LossConfig:
    strides: tuple = (8, 16, 32, 64, 128)
    point_base_scale: float = 2.0
    max_pos: int = 1024
    top_ratio: float = 0.4
    per_level_topk: int = 6
    init_scale: float = 4.0
    init_pos_num: int = 1
    pos_iou_thr: float = 0.1
    neg_iou_thr: float = 0.1
    min_pos_iou: float = 0.0
    gamma: float = 2.0
    alpha: float = 0.25
    w_cls: float = 1.0
    w_rbox_init: float = 0.375
    w_rbox_refine: float = 1.0
    w_spatial_init: float = 0.05
    w_spatial_refine: float = 0.1


def loss_config(cfg: dict) -> LossConfig:
    h = cfg["model"]["bbox_head"]
    ia = cfg["train_cfg"]["init"]["assigner"]
    ra = cfg["train_cfg"]["refine"]["assigner"]
    return LossConfig(
        strides=tuple(h["point_strides"]),
        point_base_scale=float(h["point_base_scale"]),
        max_pos=cfg.get("tpu", {}).get("max_pos", 1024),
        top_ratio=h.get("top_ratio", 0.4), init_scale=float(ia["scale"]),
        init_pos_num=ia["pos_num"], pos_iou_thr=ra["pos_iou_thr"],
        neg_iou_thr=ra["neg_iou_thr"], min_pos_iou=ra["min_pos_iou"],
        gamma=h["loss_cls"]["gamma"], alpha=h["loss_cls"]["alpha"],
        w_cls=h["loss_cls"]["loss_weight"],
        w_rbox_init=h["loss_rbox_init"]["loss_weight"],
        w_rbox_refine=h["loss_rbox_refine"]["loss_weight"],
        w_spatial_init=h["loss_spatial_init"]["loss_weight"],
        w_spatial_refine=h["loss_spatial_refine"]["loss_weight"])


def _top(x, k):
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def gather_rows(x, idx):
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def _grid(img_size, strides, device):
    """Per point (x, y, stride), levels concatenated, x fastest; per level
    (h, w)."""
    shapes = [(math.ceil(img_size[0] / s), math.ceil(img_size[1] / s))
              for s in strides]
    pts = []
    for (h, w), s in zip(shapes, strides):
        ys, xs = torch.meshgrid(torch.arange(h, device=device),
                                torch.arange(w, device=device), indexing="ij")
        xy = torch.stack([xs, ys], -1).reshape(-1, 2).float() * s
        pts.append(torch.cat([xy, torch.full_like(xy[:, :1], float(s))], 1))
    return torch.cat(pts), shapes


def _valid(shapes, strides, img_hw):
    out = []
    hw = img_hw.float()
    for (fh, fw), s in zip(shapes, strides):
        vh = torch.ceil(hw[:, 0] / s).clamp(max=fh)
        vw = torch.ceil(hw[:, 1] / s).clamp(max=fw)
        r = torch.arange(fh, device=hw.device)[None, :, None]
        c = torch.arange(fw, device=hw.device)[None, None, :]
        out.append(((r < vh[:, None, None]) & (c < vw[:, None, None]))
                   .reshape(len(hw), -1))
    return torch.cat(out, 1)


def point_assign(points, valid, gts, gt_valid, scale, pos_num):
    """-> (B, N) 1-based gt index, 0 background."""
    b, g = gt_valid.shape
    lvl = torch.log2(points[:, 2]).long()
    lo = torch.where(valid, lvl, 10 ** 6).amin(1)
    hi = torch.where(valid, lvl, -(10 ** 6)).amax(1)
    q = gts.reshape(b, g, 4, 2)
    gmin, gmax = q.amin(2), q.amax(2)
    ctr, wh = (gmin + gmax) / 2, torch.clamp(gmax - gmin, min=1e-6)
    glvl = ((torch.log2(wh[..., 0] / scale) + torch.log2(wh[..., 1] / scale))
            / 2).long()
    glvl = torch.minimum(torch.maximum(glvl, lo[:, None]), hi[:, None])
    d = (points[None, None, :, :2] - ctr[:, :, None]) / wh[:, :, None]
    dist = torch.sqrt((d * d).sum(-1))
    ok = (lvl[None, None] == glvl[..., None]) & valid[:, None] & \
        gt_valid[..., None]
    dist = torch.where(ok, dist, _INF)
    neg, idx = _top(-dist, pos_num)
    sel = torch.full_like(dist, _INF)
    sel.scatter_(2, idx, torch.where(torch.isfinite(-neg), -neg, _INF))
    best, arg = sel.min(1)
    return torch.where(torch.isfinite(best), arg + 1, 0)


def convex_iou(gts, sets, gt_valid, valid):
    """(B, G, 8) quads x (B, N, 18) point sets -> (B, G, N) IoU of each
    set's hull with each quad, -1 where either is not valid.  Pairs whose
    bounding boxes are apart have IoU 0 and are not clipped."""
    b, g = gt_valid.shape
    n = sets.shape[1]
    p = sets.reshape(b * n, 9, 2)
    hull, _, cnt = convex_hull(p)
    hull, cnt = hull.reshape(b, n, 9, 2), cnt.reshape(b, n)
    q = gts.reshape(b, g, 4, 2)
    pmin, pmax = p.amin(1).reshape(b, n, 2), p.amax(1).reshape(b, n, 2)
    qmin, qmax = q.amin(2), q.amax(2)
    live = ((pmin[:, None] <= qmax[:, :, None]).all(-1)
            & (qmin[:, :, None] <= pmax[:, None]).all(-1)
            & gt_valid[..., None] & valid[:, None])
    out = torch.zeros((b, g, n), dtype=torch.float32, device=sets.device)
    bi, gi, ni = torch.nonzero(live, as_tuple=True)
    for lo in range(0, len(bi), _CHUNK):
        sl = slice(lo, lo + _CHUNK)
        out[bi[sl], gi[sl], ni[sl]] = hull_quad_iou(
            hull[bi[sl], ni[sl]], cnt[bi[sl], ni[sl]], gts[bi[sl], gi[sl]])
    ok = gt_valid[..., None] & valid[:, None]
    return torch.where(ok, out, -1.0)


def max_iou_assign(ov, valid, gt_valid, pos_thr, neg_thr, min_pos):
    g = ov.shape[1]
    best, arg = ov.amax(1), torch.argmax(ov, 1)
    gbest = ov.amax(2)
    a = torch.full_like(best, -1, dtype=torch.long)
    a = torch.where((best >= 0) & (best < neg_thr), 0, a)
    a = torch.where(best >= pos_thr, arg + 1, a)
    tie = ((ov == gbest[..., None]) & (gbest >= min_pos)[..., None]
           & gt_valid[..., None] & valid[:, None])
    ids = torch.arange(g, device=ov.device)[None, :, None]
    last = torch.where(tie, ids, -1).amax(1)
    a = torch.where(last >= 0, last + 1, a)
    return torch.where(valid, a, 0).clamp(min=0)


def _tg(assigned, gts, labels):
    pos = assigned > 0
    gi = (assigned - 1).clamp(min=0)
    lab = torch.where(pos, torch.gather(labels.long(), 1, gi), 0)
    polys = torch.where(pos[..., None],
                        torch.gather(gts, 1, gi[..., None].expand(-1, -1, 8)),
                        0.0)
    return lab, polys, pos


def focal_elementwise(logits, labels, gamma, alpha):
    t = F.one_hot(labels.long(), logits.shape[-1] + 1)[..., 1:].to(
        logits.dtype)
    p = torch.sigmoid(logits)
    pt = (1 - p) * t + p * (1 - t)
    w = (alpha * t + (1 - alpha) * (1 - t)) * pt ** gamma
    bce = torch.clamp(logits, min=0) - logits * t + torch.log1p(
        torch.exp(-logits.abs()))
    return bce * w


def _edge_points(quads, n=10):
    q = quads.reshape(quads.shape[:-1] + (4, 2))
    t = torch.linspace(0.0, 1.0, n, device=quads.device)[:, None]
    nxt = torch.roll(q, -1, -2)
    pts = (1 - t) * q[..., :, None, :] + t * nxt[..., :, None, :]
    return pts.reshape(quads.shape[:-1] + (4 * n, 2))


def _dissimilarity(f):
    m = f.mean(-2, keepdim=True)
    u = f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True), min=1e-2)
    um = m / torch.clamp(torch.linalg.norm(m, dim=-1, keepdim=True), min=1e-2)
    den = torch.clamp(torch.linalg.norm(u, dim=-1)
                      * torch.linalg.norm(um, dim=-1), min=1e-6)
    return (1.0 - (u * um).sum(-1) / den).amax(-1)


def _spatial_parts(pts, quads, weight):
    """Per row the summed 0.2 x distance to the quad centre of the points
    outside it, the count of such points, and whether the row counts."""
    m = pts.shape[0]
    p = pts.reshape(m, 9, 2)
    q = quads.reshape(m, 4, 2)
    out = ~points_in_polygon(p, q) & (weight > 0)[:, None]
    ctr = (q[:, 0] + q[:, 2]) / 2.0
    d = torch.sqrt(((p - ctr[:, None]) ** 2).sum(-1) + 1e-12)
    return torch.where(out, 0.2 * d, 0.0).sum(), out.sum(), (weight > 0).sum()


class _GIoUSum(torch.autograd.Function):
    """sum((1 - giou) w) / div, backward d giou / d pred times w, rows with a
    component above 1 set to 1e-6, times -loss_weight / div; the upstream
    grad is not used."""

    @staticmethod
    def forward(ctx, pred, target, w, div, lw):
        div = torch.clamp(div.float(), min=1e-6)
        with torch.enable_grad():
            p = pred.detach().requires_grad_(True)
            giou = convex_giou(p, target)
            (dg,) = torch.autograd.grad(giou, p, grad_outputs=w)
        ctx.save_for_backward(dg, div)
        ctx.lw = lw
        return ((1.0 - giou.detach()) * w).sum() / div

    @staticmethod
    def backward(ctx, _):
        dg, div = ctx.saved_tensors
        bad = (dg > 1.0).any(-1, keepdim=True)
        return (-torch.where(bad, 1e-6, dg) / div * ctx.lw, None, None, None,
                None)


def giou_loss(pred, target, w, div, lw):
    return lw * _GIoUSum.apply(pred, target, w, div, lw)


def _levels(outs, key):
    return [m.float() for m in outs[key]]


def targets(outs: dict, batch: dict, cfg: LossConfig) -> dict:
    """Assignments and counts of some images, from detached head outputs.
    batch: gt_polys (b, G, 8), gt_labels (b, G), gt_valid (b, G), img_hw
    (b, 2)."""
    with torch.no_grad():
        return _targets(outs, batch, cfg)


def _targets(outs, batch, cfg):
    cls_maps = _levels(outs, "cls_scores")
    dev = cls_maps[0].device
    s0 = cfg.strides[0]
    img_size = (cls_maps[0].shape[1] * s0, cls_maps[0].shape[2] * s0)
    grid, shapes = _grid(img_size, cfg.strides, dev)
    sizes = [h * w for h, w in shapes]
    level_ids = torch.repeat_interleave(
        torch.arange(len(sizes), device=dev), torch.tensor(sizes, device=dev))
    gts, labels = batch["gt_polys"].float(), batch["gt_labels"]
    gt_valid = batch["gt_valid"].bool()
    valid = _valid(shapes, cfg.strides, batch["img_hw"].to(dev))
    cls = torch.cat([m.reshape(m.shape[0], -1, m.shape[-1])
                     for m in cls_maps], 1)
    p_init = torch.cat([offset_to_pts(m, s) for m, s in
                        zip(_levels(outs, "pts_init"), cfg.strides)], 1)
    p_ref = torch.cat([offset_to_pts(m, s) for m, s in
                       zip(_levels(outs, "pts_refine"), cfg.strides)], 1)

    init_a = point_assign(grid, valid, gts, gt_valid, cfg.init_scale,
                          cfg.init_pos_num)
    _, init_polys, init_pos = _tg(init_a, gts, labels)
    ov = convex_iou(gts, p_init, gt_valid, valid)
    ref_a = max_iou_assign(ov, valid, gt_valid, cfg.pos_iou_thr,
                           cfg.neg_iou_thr, cfg.min_pos_iou)
    ref_lab, ref_polys, ref_pos = _tg(ref_a, gts, labels)

    # APAA over up to max_pos positives an image (least Knuth hash first)
    n = ref_a.shape[1]
    prio = (torch.arange(n, device=dev) * 2654435761) & 0x7FFFFFFF
    sel = torch.argsort(torch.where(ref_pos, prio, 0xFFFFFFFF), dim=1,
                        stable=True)[:, :cfg.max_pos]
    idx = torch.sort(sel, 1).values
    cmask = torch.gather(ref_pos, 1, idx)
    cgt = (torch.gather(ref_a, 1, idx) - 1).clamp(min=0)
    clvl = level_ids[idx]
    b, p = idx.shape
    cand_ref = gather_rows(p_ref, idx)
    xy = cand_ref.reshape(b, p, 9, 2)
    feats = 0.0
    for lvl, fm in enumerate(_levels(outs, "base_feats")):
        s = float(cfg.strides[lvl])
        smp = bilinear(fm, (xy[..., 1] / s - 0.5).reshape(b, -1),
                       (xy[..., 0] / s - 0.5).reshape(b, -1))
        feats = feats + smp.reshape(b, p, 9, -1) * (clvl == lvl)[..., None,
                                                               None]
    q_cls = focal_elementwise(gather_rows(cls, idx), gather_rows(ref_lab, idx),
                              cfg.gamma, cfg.alpha).sum(-1)
    ip = gather_rows(p_init, idx).reshape(-1, 18)
    rp = cand_ref.reshape(-1, 18)
    gq = gather_rows(ref_polys, idx).reshape(-1, 8)
    eg = _edge_points(gq)
    ori_i = chamfer_distance_2d(eg, _edge_points(min_area_rect(ip)))
    ori_r = chamfer_distance_2d(eg, _edge_points(min_area_rect(rp)))
    loc_i, loc_r = 1.0 - convex_giou(ip, gq), 1.0 - convex_giou(rp, gq)
    qual = (q_cls + (0.2 * (loc_i + 0.3 * ori_i)
                     + 0.8 * (loc_r + 0.3 * ori_r)).reshape(b, p)
            + 0.1 * _dissimilarity(feats))
    qual = torch.where(cmask, qual, _INF)

    g = gts.shape[1]
    nl = len(cfg.strides)
    m = ((cgt[:, None, :] == torch.arange(g, device=dev)[:, None])[:, :, None]
         & (clvl[:, None, :] == torch.arange(nl, device=dev)[:, None])[:, None]
         & cmask[:, None, None])
    qm = torch.where(m, qual[:, None, None], _INF)
    neg, top = _top(-qm, min(cfg.per_level_topk, p))
    pool_q, pool_i = (-neg).reshape(b, g, -1), top.reshape(b, g, -1)
    pv = torch.isfinite(pool_q)
    order = torch.argsort(torch.where(pv, pool_q, _INF), dim=-1, stable=True)
    s_idx, s_ok = torch.gather(pool_i, -1, order), torch.gather(pv, -1, order)
    ng = s_ok.sum(-1)
    kk = torch.ceil(cfg.top_ratio * ng.float()).long()
    kk = torch.where(ng < 2, ng, kk)
    slot = (torch.arange(pool_q.shape[-1], device=dev) < kk[..., None]) & s_ok
    keep = torch.zeros((b, p), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)[:, None, None].expand_as(s_idx)
    keep[rows[slot], s_idx[slot]] = True
    keep &= cmask

    selected = torch.zeros_like(valid)
    selected.scatter_(1, idx, keep)
    labels_final = torch.where(ref_pos & ~selected, 0, ref_lab)
    stride_pt = grid[:, 2]
    nrm = cfg.point_base_scale * stride_pt[idx][..., None]
    gt_cand = (gather_rows(ref_polys, idx) / nrm).reshape(-1, 8)
    w_keep = keep.float().reshape(-1)
    _, n_out, n_pos = _spatial_parts((cand_ref / nrm).reshape(-1, 18),
                                     gt_cand, w_keep)
    counts = {"num_pos": keep.sum(), "ref_out": n_out, "ref_pos": n_pos}
    bounds = [0, *itertools.accumulate(sizes)]
    init_rows = []
    for lvl, s in enumerate(cfg.strides):
        lo, hi = bounds[lvl], bounds[lvl + 1]
        k = min(g * cfg.init_pos_num, hi - lo)
        w_top, top_i = _top(init_pos[:, lo:hi].float(), k)
        nrm_l = cfg.point_base_scale * float(s)
        gt_l = (gather_rows(init_polys[:, lo:hi], top_i) / nrm_l).reshape(-1,
                                                                         8)
        w = w_top.reshape(-1)
        pr = (gather_rows(p_init[:, lo:hi], top_i) / nrm_l).reshape(-1, 18)
        _, o, q = _spatial_parts(pr, gt_l, w)
        counts[f"init{lvl}_pos"] = (w > 0).sum()
        counts[f"init{lvl}_out"] = o
        counts[f"init{lvl}_spos"] = q
        init_rows.append((lo, hi, top_i, gt_l, w))
    return {"labels": labels_final, "label_weights": valid.float(),
            "idx": idx, "gt_cand": gt_cand, "w_keep": w_keep, "nrm": nrm,
            "init_rows": init_rows, "counts": counts,
            "overlaps_gt_0p1": ((ov > 0.1).sum((1, 2)).float()
                                / (gt_valid[..., None] & valid[:, None])
                                .sum((1, 2)).clamp(min=1))}


def losses(outs: dict, tg: dict, counts: dict, cfg: LossConfig) -> dict:
    """The loss terms of some images over the batch's counts (differentiable
    in the head outputs)."""
    cls = torch.cat([m.float().reshape(m.shape[0], -1, m.shape[-1])
                     for m in outs["cls_scores"]], 1)
    p_init = torch.cat([offset_to_pts(m.float(), s) for m, s in
                        zip(outs["pts_init"], cfg.strides)], 1)
    p_ref = torch.cat([offset_to_pts(m.float(), s) for m, s in
                       zip(outs["pts_refine"], cfg.strides)], 1)
    num_pos = counts["num_pos"].float()
    has = (num_pos > 0).float()
    fl = focal_elementwise(cls, tg["labels"], cfg.gamma, cfg.alpha)
    loss_cls = cfg.w_cls * (fl * tg["label_weights"][..., None]).sum() / \
        torch.clamp(num_pos, min=1e-6) * has
    pred = (gather_rows(p_ref, tg["idx"]) / tg["nrm"]).reshape(-1, 18)
    loss_ref = giou_loss(pred, tg["gt_cand"], tg["w_keep"], num_pos,
                         cfg.w_rbox_refine) * has
    s, _, _ = _spatial_parts(pred, tg["gt_cand"], tg["w_keep"])
    loss_sp_ref = cfg.w_spatial_refine * s / torch.clamp(
        counts["ref_out"], min=1) / (counts["ref_pos"].float() + 1e-6) * has
    loss_init = loss_sp_init = 0.0
    for lvl, (lo, hi, top_i, gt_l, w) in enumerate(tg["init_rows"]):
        nrm_l = cfg.point_base_scale * float(cfg.strides[lvl])
        pr = (gather_rows(p_init[:, lo:hi], top_i) / nrm_l).reshape(-1, 18)
        n_l = counts[f"init{lvl}_pos"]
        h_l = (n_l > 0).float()
        loss_init = loss_init + giou_loss(pr, gt_l, w, n_l,
                                          cfg.w_rbox_init) * h_l
        s, _, _ = _spatial_parts(pr, gt_l, w)
        loss_sp_init = loss_sp_init + cfg.w_spatial_init * s / torch.clamp(
            counts[f"init{lvl}_out"], min=1) / (
            counts[f"init{lvl}_spos"].float() + 1e-6) * h_l
    return {"loss_cls": loss_cls, "loss_rbox_init": loss_init,
            "loss_rbox_refine": loss_ref, "loss_spatial_init": loss_sp_init,
            "loss_spatial_refine": loss_sp_ref}

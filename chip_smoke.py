"""Drive the PyTorch port's serving path and training step on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases, each printing one line or more (a failed phase exits non-zero):
  1. device: the card, its power limit, and the build of the CUDA kernels;
  2. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes of the R-50 1344^2 batch-4 serving path (min-area rect with
     its hull output, over-mask, scan, DCN sampling) and of the batch-2
     training step (hull IoU, DCN backward), with times;
  3. slice: Predictor on configs/dota/orientedreppoints_r50_demo.py (R-50,
     canvas 1344^2, bf16, batch 4) over 8 seeded 1024^2 images, with seeded
     random weights perturbed so that the decode has thousands of
     candidates; launch counts, finiteness, images/s and peak memory;
  4. decode: the same head outputs decoded through the kernels and through
     the plain versions, det for det;
  5. train: the config's SGD step (R-50, canvas 1344^2, bf16, batch 2,
     frozen_stages 1, max_gt 512, max_pos 1024) on a seeded batch of 150
     rotated gts per image, seeded random weights with the point convs
     scaled up (else all 9 points coincide and the refine assigner
     degenerates): 1 warm-up step, 5 timed steps; per step the losses and
     assignment statistics, then step ms, images/s, peak memory, launches;
  6. train_check: one f32 step from the same weights and batch through the
     kernels and through the plain versions: the same refine assignment,
     the same losses, the grads within the atomics' tolerance.
Then one JSON line with every kernel's numbers, the card's line from
nvidia-smi, and {"ok": true, "device": {...}} last.

Imports torch, numpy and the port only.  Exits non-zero, printing no
result, without a GPU or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG = "configs/dota/orientedreppoints_r50_demo.py"
SEED = 0
BATCH = 4
N_IMAGES = 8
PTS_SCALE = 30.0  # point-conv gain: R-50 width, spread ~1 stride
NMS_THR = 0.4
LEVELS = [(BATCH, 168, 168), (BATCH, 84, 84), (BATCH, 42, 42),
          (BATCH, 21, 21), (BATCH, 11, 11)]  # 1344^2 canvas, strides 8..128
RECT_TOL = 1e-3  # px, corners up to order; coordinates <= ~1.5e3 in f32
IOU_TIE = 1e-4  # over-mask bits may differ only this close to the threshold
TRAIN_BATCH = 2  # data.imgs_per_gpu
TRAIN_CANVAS = 1344
TRAIN_HW = ((1280, 1280), (1024, 1024))  # true image sizes on the canvas
TRAIN_GTS = 150  # rotated gts per image: long side 12-300 px, aspect 1-6
TRAIN_STEPS = 5
TRAIN_LEVELS = [(TRAIN_BATCH, -(-TRAIN_CANVAS // s), -(-TRAIN_CANVAS // s))
                for s in (8, 16, 32, 64, 128)]
# DCN backward: f32 sums of up to ~500 terms reordered by the atomics and
# the warp reduction; bf16: one rounding step (2^-8) either side, both
# relative to the largest grad of the tensor
DCN_BWD_RTOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
# train_check: grads through the kernels vs the plain versions, relative to
# each tensor's largest element.  The f32 atomics of the DCN backward and
# cuDNN's weight-grad reductions sum in another order from run to run
# (~1e-6 of a grad); 1e-3 leaves room for that through ~60 layers
GRAD_RTOL = 1e-3

SOURCES = {
    "min_area_rect": ("orientedreppoints_tpu_torch/csrc/minarearect.cu",
                      "orientedreppoints_tpu/ops/pallas_minarearect.py:30"),
    "quad_over_mask": ("orientedreppoints_tpu_torch/csrc/quad_over.cu",
                       "orientedreppoints_tpu/ops/pallas_quad_iou.py:208"),
    "nms_scan": ("orientedreppoints_tpu_torch/csrc/nms_scan.cu",
                 "orientedreppoints_tpu/ops/nms.py:35"),
    "deform_sample_pair": ("orientedreppoints_tpu_torch/csrc/deform_sample.cu",
                           "orientedreppoints_tpu/ops/deform_conv.py:380"),
    "hull_quad_iou": ("orientedreppoints_tpu_torch/csrc/hull_iou.cu",
                      "orientedreppoints_tpu/ops/pallas_quad_iou.py:347"),
    "deform_sample_pair_backward": (
        "orientedreppoints_tpu_torch/csrc/deform_sample_bwd.cu",
        "orientedreppoints_tpu/ops/deform_conv.py:410"),
}
SERVING_KERNELS = ("min_area_rect", "quad_over_mask", "nms_scan",
                   "deform_sample_pair")
TRAIN_KERNELS = ("min_area_rect", "hull_quad_iou", "deform_sample_pair",
                 "deform_sample_pair_backward")


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rect_err(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row max corner distance over b's corner rotations/reversal."""
    a, b = a.view(-1, 4, 2), b.view(-1, 4, 2)
    errs = [(a - bb.roll(s, 1)).abs().amax((1, 2))
            for bb in (b, b.flip(1)) for s in range(4)]
    return torch.stack(errs).amin(0)


def rect_area(r: torch.Tensor) -> torch.Tensor:
    r = r.view(-1, 4, 2).double()
    return (r[:, 1] - r[:, 0]).norm(dim=-1) * (r[:, 2] - r[:, 1]).norm(dim=-1)


def point_sets(rng, n):
    """n 9-point sets over a 1344^2 canvas; 1% coincident, 1% collinear."""
    pts = rng.uniform(0, 1344, (n, 1, 2)) + rng.normal(0, 24, (n, 9, 2))
    m = n // 100
    pts[:m] = pts[:m, :1]
    t = rng.integers(-8, 9, (m, 9, 1)).astype(np.float64)
    pts[m:2 * m] = np.round(pts[m:2 * m, :1]) + t * np.array([3.0, 1.0])
    return pts.reshape(n, 18)


def nms_quads(rng, b, n, classes=15):
    """Score-sorted-like quads: jittered copies of n/8 base boxes (many
    IoUs near the threshold), shifted by class as multiclass NMS does."""
    base = rng.integers(0, n // 8, (b, n))
    c = rng.uniform(0, 1344, (b, n // 8, 2))[np.arange(b)[:, None], base]
    c = c + rng.normal(0, 8, (b, n, 2))
    wh = rng.uniform(16, 96, (b, n, 2))
    ang = rng.uniform(0, np.pi, (b, n))
    lx = np.array([-0.5, 0.5, 0.5, -0.5]) * wh[..., :1]
    ly = np.array([-0.5, -0.5, 0.5, 0.5]) * wh[..., 1:]
    cs, sn = np.cos(ang)[..., None], np.sin(ang)[..., None]
    q = np.stack([cs * lx - sn * ly + c[..., :1],
                  sn * lx + cs * ly + c[..., 1:]], -1).reshape(b, n, 8)
    return q + (base % classes)[..., None] * 1345.0


def phase_kernels(dev, rng):
    from orientedreppoints_tpu_torch.ops import (deform_conv, geometry,
                                                 minarearect, nms, quad_iou)
    res = {}

    # min-area rect: the decode's B * sum(min(2000, HW)) = 25304 sets
    n = BATCH * sum(min(2000, h * w) for _, h, w in LEVELS)
    p = torch.tensor(point_sets(rng, n), dtype=torch.float32, device=dev)
    got = minarearect.min_area_rect(p)
    want = minarearect.min_area_rect_plain(p)
    err = rect_err(got, want)
    off = err > RECT_TOL
    # a differing box is accepted only as a tie: the same area within the
    # tie rule's relative 1e-5 (twice, for the two roundings)
    rel = (rect_area(got) - rect_area(want)).abs() / rect_area(want).clamp(
        min=1e-6)
    ties = int(off.sum())
    ok = bool((rel[off] <= 2 * geometry.TIE_RTOL).all())
    # the hull output (the assigner's) must give the plain version's bits
    hull, count = minarearect.convex_hull_entry(p)
    hull_p, count_p = minarearect.convex_hull_plain(p)
    hull_exact = torch.equal(hull, hull_p) and torch.equal(count, count_p)
    res["min_area_rect"] = dict(
        max_abs_err=float(err[~off].max()), ok=ok and hull_exact,
        shape=[n, 18], hull_exact=hull_exact,
        hull_max_abs_err=float((hull - hull_p).abs().max()),
        ms=cuda_ms(lambda: minarearect.min_area_rect(p), 20),
        plain_ms=cuda_ms(lambda: minarearect.min_area_rect_plain(p), 3),
        hull_plain_ms=cuda_ms(lambda: minarearect.convex_hull_plain(p), 3))
    say("kernel", name="min_area_rect", sets=n, ties=ties,
        tol_px=RECT_TOL, **res["min_area_rect"])

    # over-mask: B 4, N 4096 class-offset quads, nv = 4096
    nq = 4096
    q = torch.tensor(nms_quads(rng, BATCH, nq), dtype=torch.float32,
                     device=dev)
    nv = torch.full((BATCH,), nq, dtype=torch.int32, device=dev)
    mask = quad_iou.quad_over_mask(q, NMS_THR, nv)
    mask_plain = quad_iou.quad_over_mask_plain(q, NMS_THR, nv)
    diff = quad_iou.unpack_bits(mask ^ mask_plain, nq)
    bi, ri, ci = diff.nonzero(as_tuple=True)
    iou = geometry.quad_iou(q[bi, ri], q[bi, ci])
    set_bits = int(quad_iou.unpack_bits(mask_plain, nq).sum())
    res["quad_over_mask"] = dict(
        max_abs_err=float(int(diff.any())), mismatches=int(diff.sum()),
        ok=bool(((iou - NMS_THR).abs() < IOU_TIE).all()), set_bits=set_bits,
        ms=cuda_ms(lambda: quad_iou.quad_over_mask(q, NMS_THR, nv), 10),
        plain_ms=cuda_ms(
            lambda: quad_iou.quad_over_mask_plain(q, NMS_THR, nv), 1))
    say("kernel", name="quad_over_mask", batch=BATCH, n=nq,
        iou_tie=IOU_TIE, **res["quad_over_mask"])

    # scan: the kernel's mask through both scans, which must agree exactly
    valid = torch.ones((BATCH, nq), dtype=torch.bool, device=dev)
    keep = nms.greedy_scan(mask, valid, nv)
    keep_plain = nms.greedy_scan_plain(mask, valid, nv)
    res["nms_scan"] = dict(
        max_abs_err=float((keep != keep_plain).sum()),
        ok=bool(torch.equal(keep, keep_plain)), kept=int(keep.sum()),
        ms=cuda_ms(lambda: nms.greedy_scan(mask, valid, nv), 20),
        plain_ms=cuda_ms(lambda: nms.greedy_scan_plain(mask, valid, nv), 1))
    say("kernel", name="nms_scan", **res["nms_scan"])

    # paired DCN sampling over the 1344^2 batch-4 pyramid, C = 256
    rows = sum(b * h * w for b, h, w in LEVELS)
    errs, times = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        ta = torch.randn(rows, 256, device=dev).to(dt)
        tb = torch.randn(rows, 256, device=dev).to(dt)
        offs = (torch.randn(rows, 18, device=dev) * 3).to(dt)
        got = deform_conv.deform_sample_pair(ta, tb, offs, LEVELS)
        want = deform_conv.deform_sample_pair_plain(ta, tb, offs, LEVELS)
        errs[dt] = max(float((g.float() - w.float()).abs().max())
                       for g, w in zip(got, want))
        del got, want
        times[dt] = (
            cuda_ms(lambda: deform_conv.deform_sample_pair(
                ta, tb, offs, LEVELS), 5),
            cuda_ms(lambda: deform_conv.deform_sample_pair_plain(
                ta, tb, offs, LEVELS), 2))
    # f32: one rounding either way; bf16: at most one bf16 step (2^-8
    # relative) where the f32 sums round to different sides
    ok = errs[torch.float32] <= 1e-5 and errs[torch.bfloat16] <= 2 ** -8 * 8
    res["deform_sample_pair"] = dict(
        max_abs_err=errs[torch.bfloat16], ok=ok,
        ms=times[torch.bfloat16][0], plain_ms=times[torch.bfloat16][1])
    say("kernel", name="deform_sample_pair", rows=rows, channels=256,
        max_abs_err_f32=errs[torch.float32],
        max_abs_err_bf16=errs[torch.bfloat16],
        ms_f32=times[torch.float32][0], plain_ms_f32=times[torch.float32][1],
        ms_bf16=times[torch.bfloat16][0],
        plain_ms_bf16=times[torch.bfloat16][1], ok=ok)
    return res


def rotated_gts(rng, h, w, n):
    """n rotated rectangles centred in an h x w image: long side 12-300 px,
    aspect 1-6, any angle -> (n, 8)."""
    long = rng.uniform(12, 300, n)
    short = long / rng.uniform(1, 6, n)
    c = rng.uniform(0, 1, (n, 2)) * [w, h]
    ang = rng.uniform(0, np.pi, n)
    lx = np.array([-0.5, 0.5, 0.5, -0.5]) * long[:, None]
    ly = np.array([-0.5, -0.5, 0.5, 0.5]) * short[:, None]
    cs, sn = np.cos(ang)[:, None], np.sin(ang)[:, None]
    return np.stack([cs * lx - sn * ly + c[:, :1],
                     sn * lx + cs * ly + c[:, 1:]], -1).reshape(n, 8)


def train_batch(rng, max_gt):
    """A seeded batch in the collated layout (data/loader.py): uint8
    canvases with content inside img_hw, TRAIN_GTS gts per image padded to
    max_gt, labels 1-15."""
    b = len(TRAIN_HW)
    images = np.zeros((b, TRAIN_CANVAS, TRAIN_CANVAS, 3), np.uint8)
    polys = np.zeros((b, max_gt, 8), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    for i, (h, w) in enumerate(TRAIN_HW):
        images[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        polys[i, :TRAIN_GTS] = rotated_gts(rng, h, w, TRAIN_GTS)
        labels[i, :TRAIN_GTS] = rng.integers(1, 16, TRAIN_GTS)
        valid[i, :TRAIN_GTS] = True
    return dict(images=images, gt_polys=polys, gt_labels=labels,
                gt_valid=valid, img_hw=np.array(TRAIN_HW, np.int32))


def phase_train_kernels(dev, rng):
    """The training step's kernels at its shapes: kernel 1's hulls of the
    B 2 x 37,606 point sets, hull IoU with G 512 gts of which 150 real, and
    the DCN backward (75,212 rows, C 256)."""
    from orientedreppoints_tpu_torch.ops import (deform_conv, hull_iou,
                                                 minarearect)
    res = {}
    b = TRAIN_BATCH
    n = sum(h * w for _, h, w in TRAIN_LEVELS)
    g = 512  # the config's tpu.max_gt
    quads = np.zeros((b, g, 8), np.float32)
    for i, (h, w) in enumerate(TRAIN_HW):
        quads[i, :TRAIN_GTS] = rotated_gts(rng, h, w, TRAIN_GTS)
    quads = torch.tensor(quads, device=dev)
    pts = torch.tensor(point_sets(rng, b * n), dtype=torch.float32,
                       device=dev).view(b, n, 9, 2)
    # as convex_iou does: shift by the mean of all gt corners (padding too)
    shift = quads.view(b, -1, 2).mean(1)[:, None, None, :]
    sets = (pts - shift).reshape(b * n, 18).contiguous()
    hulls, counts = minarearect.convex_hull_entry(sets)
    hulls_p, counts_p = minarearect.convex_hull_plain(sets)
    hull_exact = torch.equal(hulls, hulls_p) and torch.equal(counts, counts_p)
    hull_ms = cuda_ms(lambda: minarearect.convex_hull_entry(sets), 20)
    hull_plain_ms = cuda_ms(lambda: minarearect.convex_hull_plain(sets), 3)
    hulls, counts = hulls.view(b, n, 9, 2), counts.view(b, n)
    q = (quads.view(b, g, 4, 2) - shift).reshape(b, g, 8).contiguous()
    got = hull_iou.hull_quad_iou_matrix(hulls, counts, q)
    want = hull_iou.hull_quad_iou_matrix_plain(hulls, counts, q)
    bits = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    err = float((got[..., :TRAIN_GTS] - want[..., :TRAIN_GTS]).abs().max())
    res["hull_quad_iou"] = dict(
        max_abs_err=err, differing_bits=bits,
        ok=(bits == 0 or err <= 1e-6) and hull_exact,
        pairs_iou_gt_0p1=int((want[..., :TRAIN_GTS] > 0.1).sum()),
        ms=cuda_ms(lambda: hull_iou.hull_quad_iou_matrix(hulls, counts, q),
                   10),
        plain_ms=cuda_ms(lambda: hull_iou.hull_quad_iou_matrix_plain(
            hulls, counts, q), 1))
    say("kernel", name="hull_quad_iou", batch=b, hulls=n, gts=g,
        pairs=b * n * g, hull_sets=b * n, hull_exact=hull_exact,
        hull_ms=hull_ms, hull_plain_ms=hull_plain_ms, **res["hull_quad_iou"])
    del got, want

    rows = sum(bb * h * w for bb, h, w in TRAIN_LEVELS)
    c, k = 256, 9
    errs, times = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        ta, tb = (torch.randn(rows, c, device=dev).to(dt) for _ in range(2))
        offs = (torch.randn(rows, 2 * k, device=dev) * 3).to(dt)
        ga, gb = (torch.randn(rows, k * c, device=dev).to(dt)
                  for _ in range(2))
        args = (ta, tb, offs, ga, gb, TRAIN_LEVELS)
        got = deform_conv.deform_sample_pair_backward(*args)
        want = deform_conv.deform_sample_pair_backward_plain(*args)
        name = str(dt).split(".")[-1]
        errs[name] = [(float((x.float() - y.float()).abs().max()),
                       max(1.0, float(y.float().abs().max())))
                      for x, y in zip(got, want)]
        del got, want
        times[name] = (
            cuda_ms(lambda: deform_conv.deform_sample_pair_backward(*args), 5),
            cuda_ms(lambda: deform_conv.deform_sample_pair_backward_plain(
                *args), 1))
        del args, ta, tb, offs, ga, gb
        torch.cuda.empty_cache()
    ok = all(e <= DCN_BWD_RTOL[name] * scale
             for name in errs for e, scale in errs[name])
    res["deform_sample_pair_backward"] = dict(
        max_abs_err=max(e for e, _ in errs["bfloat16"]), ok=ok,
        ms=times["bfloat16"][0], plain_ms=times["bfloat16"][1])
    say("kernel", name="deform_sample_pair_backward", rows=rows, channels=c,
        max_abs_err_f32=[e for e, _ in errs["float32"]],
        max_abs_err_bf16=[e for e, _ in errs["bfloat16"]],
        grad_scale_f32=[s for _, s in errs["float32"]],
        grad_scale_bf16=[s for _, s in errs["bfloat16"]],
        rtol=DCN_BWD_RTOL, ms_f32=times["float32"][0],
        plain_ms_f32=times["float32"][1], ms_bf16=times["bfloat16"][0],
        plain_ms_bf16=times["bfloat16"][1], ok=ok)
    return res


def perturbed_weights(rng):
    """Seeded random weights with cls_out's bias drawn above score_thr and
    the point convs scaled up, so that the decode sees thousands of
    candidates and spread point sets (random init scores ~0.0099 everywhere
    and puts all 9 points together)."""
    from orientedreppoints_tpu_torch.apis import init_detector

    model, _ = init_detector(CONFIG, compute_dtype="float32", device="cpu",
                             seed=SEED)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    bias = sd["bbox_head.cls_out.bias"]
    sd["bbox_head.cls_out.bias"] = torch.from_numpy(
        rng.uniform(-2.0, 1.0, bias.shape).astype(np.float32))
    for name in ("pts_init_out", "pts_refine_out"):
        sd[f"bbox_head.{name}.weight"] *= PTS_SCALE
    return sd


def candidates(outs, tc):
    """Per-image count of (box, class) pairs entering NMS: the decode's
    top nms_pre rows per level, scores above score_thr, capped."""
    from orientedreppoints_tpu_torch.ops.nms import topk_stable

    counts = 0
    for s in outs["cls_scores"]:
        b, h, w, c = s.shape
        sc = torch.sigmoid(s.reshape(b, h * w, c).float())
        top = topk_stable(sc.amax(-1), min(tc["nms_pre"], h * w))[1]
        sc = torch.gather(sc, 1, top[..., None].expand(-1, -1, c))
        counts = counts + (sc > tc["score_thr"]).sum((1, 2))
    return counts.clamp(max=tc.get("pre_nms_cap", 4096)).tolist()


def phase_slice(dev, rng, ops_mod, card):
    from orientedreppoints_tpu_torch.serving import Predictor

    pred = Predictor(CONFIG, state_dict=perturbed_weights(rng),
                     batch_size=BATCH, compute_dtype="bfloat16", device=dev)
    images = [(rng.random((1024, 1024, 3)) * 255).astype(np.uint8)
              for _ in range(N_IMAGES)]
    pred(images[:BATCH])  # warm-up batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops_mod.reset_launch_counts()
    out = pred(images)
    torch.cuda.synchronize()
    launches = ops_mod.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred(images)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    cand, first_outs = [], None
    with torch.inference_mode():
        for lo in range(0, N_IMAGES, BATCH):
            outs = pred.model(pred.prepare(images[lo:lo + BATCH])[0])
            cand += candidates(outs, pred.test_cfg)
            first_outs = first_outs or outs
    kept = [sum(len(a) for a in per_class) for per_class in out]
    finite = all(np.isfinite(a).all() for per_class in out
                 for a in per_class) and all(
        bool(torch.isfinite(t.float()).all()) for ts in first_outs.values()
        for t in ts)
    ok = (min(cand) >= 1000 and all(launches[k] > 0 for k in SERVING_KERNELS)
          and finite and min(kept) > 0 and len(out) == N_IMAGES)
    ips = [N_IMAGES / t for t in times]
    say("slice", config=CONFIG, batch=BATCH, images=N_IMAGES,
        dtype="bfloat16", candidates_per_image=cand, dets_kept=kept,
        launches=launches, finite=finite,
        images_per_s_median=statistics.median(ips), images_per_s=ips,
        max_memory_allocated_bytes=peak, card=card, ok=ok)
    return ok, launches, pred, first_outs


@contextlib.contextmanager
def plain_decode():
    """Route decode_detections through the plain versions on the card."""
    from orientedreppoints_tpu_torch.models import detector
    from orientedreppoints_tpu_torch.ops import geometry, nms, quad_iou

    saved = (detector.min_area_rect, nms.quad_over_mask, nms.greedy_scan)
    detector.min_area_rect = geometry.min_area_rect
    nms.quad_over_mask = quad_iou.quad_over_mask_plain
    nms.greedy_scan = nms.greedy_scan_plain
    try:
        yield
    finally:
        detector.min_area_rect, nms.quad_over_mask, nms.greedy_scan = saved


def phase_decode(pred, outs):
    from orientedreppoints_tpu_torch.models.detector import decode_detections

    tc = pred.test_cfg
    kw = dict(nms_pre=tc["nms_pre"], score_thr=tc["score_thr"],
              iou_thr=tc["nms"]["iou_thr"], max_per_img=tc["max_per_img"],
              pre_nms_cap=tc.get("pre_nms_cap", 4096))
    outs = {k: [t.float() for t in outs[k]]
            for k in ("cls_scores", "pts_refine")}
    with torch.inference_mode():
        dets, labels, valid = decode_detections(outs, **kw)
        with plain_decode():
            dets_p, labels_p, valid_p = decode_detections(outs, **kw)
    same_valid = bool(torch.equal(valid, valid_p))
    same_labels = same_valid and bool(torch.equal(labels[valid],
                                                  labels_p[valid]))
    err_pts = err_poly = err_score = float("inf")
    if same_valid:
        d, p = dets[valid], dets_p[valid]
        err_pts = float((d[:, :18] - p[:, :18]).abs().max())
        err_poly = float(rect_err(d[:, 18:26], p[:, 18:26]).max())
        err_score = float((d[:, 26] - p[:, 26]).abs().max())
    ok = (same_labels and err_pts == 0.0 and err_score == 0.0
          and err_poly <= RECT_TOL)
    say("decode", dets=int(valid.sum()), same_valid=same_valid,
        same_labels=same_labels, max_err_reppoints=err_pts,
        max_err_poly_px=err_poly, max_err_score=err_score, ok=ok)
    return ok


def build_trainer(sd, compute_dtype, dev):
    """The config's training setup: model with frozen_stages frozen, SGD
    with its LR schedule, and the step (device_normalize on)."""
    from orientedreppoints_tpu_torch.apis import (build_detector,
                                                  build_img_norm,
                                                  build_loss_config)
    from orientedreppoints_tpu_torch.host import load_config
    from orientedreppoints_tpu_torch.parallel import train

    cfg = load_config(CONFIG)
    model = build_detector(cfg, compute_dtype)
    model.load_state_dict(sd, strict=True)
    model.to(dev)
    train.freeze(model, train.default_frozen_prefixes(
        cfg["model"]["backbone"]["frozen_stages"]))
    opt, lr = cfg["optimizer"], cfg["lr_config"]
    if opt["type"] != "SGD":
        raise NotImplementedError(f"optimizer {opt['type']} is not ported")
    sched = train.lr_schedule(
        base_lr=opt["lr"], warmup_iters=lr["warmup_iters"],
        warmup_ratio=lr["warmup_ratio"], step_epochs=lr["step"])
    optimizer, scheduler = train.build_optimizer(
        model, sched, momentum=opt["momentum"],
        weight_decay=opt["weight_decay"])
    step = train.make_train_step(
        model, build_loss_config(cfg), optimizer, scheduler,
        grad_clip=cfg["optimizer_config"]["grad_clip"]["max_norm"],
        img_norm=build_img_norm(cfg))
    return model, step


def phase_train(dev, ops_mod, card, sd, batch):
    model, step = build_trainer(sd, "bfloat16", dev)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    n = sum(h * w for _, h, w in TRAIN_LEVELS)
    step(batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops_mod.reset_launch_counts()
    times, records = [], []
    for i in range(TRAIN_STEPS):
        stats = {}
        t0 = time.perf_counter()
        losses = step(batch, stats)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rec = {k: float(v) for k, v in losses.items()}
        rec["refine_pos_per_image"] = (stats["gt_inds"] > 0).sum(1).tolist()
        rec["iou_gt_0p1_share"] = stats["iou_gt_0p1"].tolist()
        records.append(rec)
        say("train_step", step=i, **rec)
    launches = ops_mod.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    frozen_same, unchanged, trainable = 0, [], 0
    for k, p in model.named_parameters():
        same = torch.equal(p.detach(), before[k])
        if p.requires_grad:
            trainable += 1
            unchanged += [k] if same else []
        else:
            frozen_same += same
    n_frozen = sum(not p.requires_grad for p in model.parameters())
    finite = all(np.isfinite(v) for r in records for k, v in r.items()
                 if not isinstance(v, list))
    ok = (finite and min(r["num_pos"] for r in records) > 0
          and max(max(r["refine_pos_per_image"]) for r in records) < n
          and min(min(r["iou_gt_0p1_share"]) for r in records) > 0
          and all(launches[k] > 0 for k in TRAIN_KERNELS)
          and n_frozen > 0 and frozen_same == n_frozen and not unchanged)
    med = statistics.median(times)
    say("train", config=CONFIG, batch=TRAIN_BATCH, canvas=TRAIN_CANVAS,
        dtype="bfloat16", steps=TRAIN_STEPS, point_sets_per_image=n,
        step_ms=[t * 1e3 for t in times], step_ms_median=med * 1e3,
        train_images_per_s=TRAIN_BATCH / med,
        max_memory_allocated_bytes=peak, launches=launches,
        frozen_tensors=n_frozen, frozen_unchanged=frozen_same,
        trainable_tensors=trainable, trainable_unchanged=unchanged,
        finite=finite, card=card, ok=ok)
    return ok, launches


@contextlib.contextmanager
def plain_train():
    """Route the training step through the plain versions on the card."""
    from orientedreppoints_tpu_torch.core import apaa
    from orientedreppoints_tpu_torch.ops import (deform_conv, geometry,
                                                 hull_iou, minarearect)

    swaps = [(deform_conv, "deform_sample_pair",
              deform_conv.deform_sample_pair_plain),
             (deform_conv, "deform_sample_pair_backward",
              deform_conv.deform_sample_pair_backward_plain),
             (hull_iou, "hull_quad_iou_matrix",
              hull_iou.hull_quad_iou_matrix_plain),
             (minarearect, "convex_hull_entry", minarearect.convex_hull_plain),
             (apaa, "min_area_rect", geometry.min_area_rect)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def phase_train_check(dev, ops_mod, sd, batch):
    runs = {}
    for route in ("kernels", "plain"):
        model, step = build_trainer(sd, "float32", dev)
        ops_mod.reset_launch_counts()
        stats = {}
        with plain_train() if route == "plain" else contextlib.nullcontext():
            losses = step(batch, stats)
        torch.cuda.synchronize()
        grads = {k: p.grad.detach().clone()
                 for k, p in model.named_parameters() if p.requires_grad}
        runs[route] = (losses, stats["gt_inds"], grads,
                       ops_mod.launch_counts())
        del model, step
        torch.cuda.empty_cache()
    (lk, gk, grk, nk), (lp, gp, grp, np_) = runs["kernels"], runs["plain"]
    same_assign = torch.equal(gk, gp)
    loss_rel = max(abs(float(lk[k]) - float(lp[k]))
                   / max(abs(float(lp[k])), 1e-6) for k in lp)
    grad_rel = max(float((grk[k] - grp[k]).abs().max())
                   / max(float(grp[k].abs().max()), 1e-30) for k in grp)
    ok = (same_assign and loss_rel <= 1e-5 and grad_rel <= GRAD_RTOL
          and all(nk[k] > 0 for k in TRAIN_KERNELS)
          and not any(np_.values()))
    say("train_check", dtype="float32", tf32=False,
        refine_assignment_identical=same_assign,
        refine_pos=int((gk > 0).sum()), max_loss_rel_err=loss_rel,
        max_grad_rel_err=grad_rel, grad_rtol=GRAD_RTOL,
        losses={k: float(v) for k, v in lk.items()},
        launches_kernels=nk, launches_plain=np_, ok=ok)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    from orientedreppoints_tpu_torch import ops as ops_mod
    from orientedreppoints_tpu_torch.ops import _ext

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _ext.lib()
    say("device", name=torch.cuda.get_device_name(0), card=card,
        torch=torch.__version__, cuda=torch.version.cuda,
        build_s=_ext.build_seconds, load_s=time.perf_counter() - t0)

    torch.manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    rng_train = np.random.default_rng(SEED + 1)
    kernels = phase_kernels(dev, rng)
    kernels.update(phase_train_kernels(dev, rng_train))
    ok_slice, launches, pred, outs = phase_slice(dev, rng, ops_mod, card)
    ok_decode = phase_decode(pred, outs)
    del pred, outs
    torch.cuda.empty_cache()

    from orientedreppoints_tpu_torch.host import load_config
    from orientedreppoints_tpu_torch.parallel.train import to_device

    sd = perturbed_weights(rng_train)
    max_gt = load_config(CONFIG)["tpu"]["max_gt"]
    batch = to_device(train_batch(rng_train, max_gt), dev)
    ok_train, launches_train = phase_train(dev, ops_mod, card, sd, batch)
    torch.cuda.empty_cache()
    ok_check = phase_train_check(dev, ops_mod, sd, batch)

    # launches: the serving run's count plus the training run's
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCES[name][0],
             replaces=SOURCES[name][1],
             launches=launches[name] + launches_train[name],
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"])
        for name, r in kernels.items()]}))
    print(card)
    if not (all(r["ok"] for r in kernels.values()) and ok_slice
            and ok_decode and ok_train and ok_check):
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

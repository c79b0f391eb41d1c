"""Drive the PyTorch port's serving path, training step and TTA test path
on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line or more (a failed phase exits non-zero):
  1. device: the card, its power limit, and the build of the CUDA kernels;
  2. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes of the R-50 1344^2 batch-4 serving path (min-area rect with
     its hull output, also timed at the training step's three calls;
     over-mask bit for bit with the share of live pairs whose clip empties
     at each stage; scan exactly with its time a row; DCN sampling bit for
     bit and also timed at the training and the 2016^2 TTA shapes), of the
     batch-2 training step (hull IoU with the step's masks, bit for bit
     over every pair, with the share of live pairs whose clip empties at
     each stage; DCN backward on f32 sample grads) and of the quad-IoU
     entries (full and upper-triangle f32 IoU, the single-image over-mask
     and the scan at batch 1, the over-mask against the triangle,
     soft_rnms and box_iou_rotated), with times, each kernel's bound and,
     where one PyTorch call computes the same function, that call's time
     (grid_sample for the DCN kernels);
  2b. host: host.imrescale (cv2's uint8 resize) on the card equals the
     same call on the CPU at sizes that resize;
  3. slice: Predictor on configs/dota/orientedreppoints_r50_demo.py (R-50,
     canvas 1344^2, bf16, batch 4) over 8 seeded 1024^2 images, with seeded
     random weights perturbed so that the decode has thousands of
     candidates; launch counts, finiteness, images/s and peak memory;
  4. decode: the same head outputs decoded through the kernels and through
     the plain versions, det for det, and both NMS kernels checked and timed
     on that decode's own candidates (the top 4096 class-offset boxes an
     image);
  5. tta: run_inference_tta with the multi-scale x flip recipe TTA_AUGS
     (scales 0.5, 1.0, 1.5, each on its own /32 canvas, x flip; R-50 bf16,
     batch 2) over 4 seeded 1024^2 images resized to fill the canvas: per
     aug the candidates, then dets, launches, finiteness, det centres in
     the image frame, images/s (median of 3 passes after a warm-up) and
     peak memory;
  6. tta_check: (a) the identity recipe [(1.0, False)] equals
     run_inference det for det; (b) one batch of the full recipe with
     every DCN forward (bit for bit) and min-area-rect call (each scale's
     canvas) held against its plain version on the same inputs, and its
     merged candidates through the kernels and through the plain
     over-mask and scan giving the same dets;
  7. iou_path: soft_rnms and the upper-triangle IoU entry over the merged
     TTA candidates of one image, the path of the f32 IoU kernels;
  8. train: the config's SGD step (R-50, canvas 1344^2, bf16, batch 2,
     frozen_stages 1, max_gt 512, max_pos 1024) on a seeded batch of 150
     rotated gts per image, seeded random weights with the point convs
     scaled up (else all 9 points coincide and the refine assigner
     degenerates): 1 warm-up step, 5 timed steps; per step the losses and
     assignment statistics, then step ms, images/s, peak memory, launches;
  9. train_check: one f32 step from the same weights and batch through the
     kernels and through the plain versions: the same refine assignment,
     the same losses, the grads within the atomics' tolerance.
Each counted run (slice, tta, iou_path, train) sets the launch counts to 0
just before and reads them just after; it fails if a kernel of its path
was not launched.  Then one JSON line with every kernel's numbers, the
card's line from nvidia-smi, and {"ok": true, "device": {...}} last.

bound_ms is the least time the card could take for a kernel's work on this
run's inputs: the larger of its bytes (each input read once, each output
written once) over 3.35 TB/s and its f32 operations over 33.5 T op/s (the
published 67 TFLOP/s of an H100 SXM counts a fused multiply-add as two; the
library is built with -fmad=false, so each multiply and add is one
instruction).  The operation counts are the op models of *_ops below,
evaluated on this run's data where the work depends on it (clip vertex
counts, hull sizes, live pairs, kept rows; the hull IoU's live pairs are
those of a valid gt and a valid point set); work that depends on one input
of a pair only counts once for that input.

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
TRAIN_BATCH = 2  # data.imgs_per_gpu
TRAIN_CANVAS = 1344
TRAIN_HW = ((1280, 1280), (1024, 1024))  # true image sizes on the canvas
TRAIN_GTS = 150  # rotated gts per image: long side 12-300 px, aspect 1-6
TRAIN_STEPS = 5
STRIDES = (8, 16, 32, 64, 128)
TRAIN_LEVELS = [(TRAIN_BATCH, -(-TRAIN_CANVAS // s), -(-TRAIN_CANVAS // s))
                for s in STRIDES]
# DCN backward: f32 sums of up to ~500 terms reordered by the atomics and
# the warp reduction; bf16: one rounding step (2^-8) either side, both
# relative to the largest grad of the tensor
DCN_BWD_RTOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
# train_check: grads through the kernels vs the plain versions, relative to
# each tensor's largest element.  The f32 atomics of the DCN backward and
# cuDNN's weight-grad reductions sum in another order from run to run
# (~1e-6 of a grad); 1e-3 leaves room for that through ~60 layers
GRAD_RTOL = 1e-3

TTA_AUGS = [(0.5, False), (0.5, True), (1.0, False), (1.0, True),
            (1.5, False), (1.5, True)]  # TTA_BENCH.json's recipe shape
TTA_BATCH = 2
TTA_LEVELS = [(TTA_BATCH, -(-2016 // s), -(-2016 // s)) for s in STRIDES]
TTA_IMAGES = 4
TTA_SIZE = 1024
NQ = 4096  # NMS candidates an image: pre_nms_cap
TRI_NV = [NQ, 3000, 1000, 0]  # the upper-triangle kernel's prefixes
HBM_BYTES_PER_MS = 3.35e12 / 1e3  # H100 SXM
# GPU clock cycles to cover the host's enqueue of one timed call (~100 us
# at ~2 GHz, more than a wrapper's allocations and ctypes launch take)
HOST_CYCLES_PER_CALL = 2e5
FP32_OPS_PER_MS = 33.5e12 / 1e3  # 67 TFLOP/s with an FMA counted as two
# grid_sample against the plain DCN in f32: the normalised grid moves a
# sample by up to ~1e-5 px (at w = 168), so values differ by that times the
# difference of neighbouring values (up to ~8 here); the offset grads are
# compared away from pixel lines, where that move may change the cell
LIBRARY_TOL = 1e-3
CELL_EDGE = 1e-3  # px
# random point sets reach up to about a stride past their location, so a
# det's centre may lie that far outside the image; an aug's boxes mapped
# back with a wrong scale land hundreds of px away
FRAME_SPREAD = 128

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
    "quad_iou_full": ("orientedreppoints_tpu_torch/csrc/quad_iou.cu",
                      "orientedreppoints_tpu/ops/pallas_quad_iou.py:154"),
    "quad_iou_tri": ("orientedreppoints_tpu_torch/csrc/quad_iou.cu",
                     "orientedreppoints_tpu/ops/pallas_quad_iou.py:158"),
    "quad_over_mask_single": (
        "orientedreppoints_tpu_torch/csrc/quad_over.cu",
        "orientedreppoints_tpu/ops/pallas_quad_iou.py:253"),
}
SERVING_KERNELS = ("min_area_rect", "quad_over_mask", "nms_scan",
                   "deform_sample_pair")
TRAIN_KERNELS = ("min_area_rect", "hull_quad_iou", "deform_sample_pair",
                 "deform_sample_pair_backward")
TTA_KERNELS = ("min_area_rect", "deform_sample_pair", "quad_over_mask",
               "nms_scan")  # the over-mask here is the single-image entry
IOU_PATH_KERNELS = ("quad_iou_full", "quad_iou_tri")


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call over reps calls, after one
    warm-up.  The card is first kept busy (torch.cuda._sleep) for longer
    than the host takes to enqueue the calls, so that a small kernel is
    timed back to back and not at the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * HOST_CYCLES_PER_CALL))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> dict:
    """The least time for nbytes of traffic and ops f32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_MS
    t_ops = ops / FP32_OPS_PER_MS
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=float(nbytes), operations=float(ops))


def clip_pair_ops(sub, cnt, quads, live=None, exits=None) -> float:
    """f32 operations of the pair IoU (quad_clip.cuh, hull_iou.cu) over
    subjects sub (B, N, V, 2) with vertex counts cnt (B, N) and clip quads
    (B, M, 8), over the live (B, N, M) pairs only if live(rows, cols) gives
    a mask.  Work that depends on one side only counts once for each row
    or column with a live pair (an area does not change when the pair is
    recentred, so a kernel may take it once): a subject's area and half of
    it 4 n0 + 1, a clip quad's shift to its vertex 0, area, half area and
    four edge vectors 8 + 16 + 1 + 8.  Per pair, with n0 the subject's
    vertices, c_e and x_e the vertices entering and the edges crossing
    clip stage e, c4 the clipped vertices: the subject's shift 2 n0, per
    stage 5 c_e + 8 x_e, the clipped area 4 c4, the union and ratio 5.
    exits, a list of 5 counts if given, receives the live pairs whose clip
    empties at stage 0, 1, 2, 3, and those that keep a vertex."""
    from orientedreppoints_tpu_torch.ops.geometry import _clip_half_plane

    b, n, v, _ = sub.shape
    m = quads.shape[1]
    total = 0.0
    col_live = torch.zeros((b, m), dtype=torch.bool, device=sub.device)
    step = max(1, (1 << 20) // max(1, b * m))
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        o = quads[:, None, :, None, :2]  # (B, 1, M, 1, 2)
        verts = sub[:, r0:r1, None] - o
        c = cnt[:, r0:r1, None].expand(-1, -1, m).to(torch.int64)
        q = quads.view(b, 1, m, 4, 2) - o
        area2 = (q[..., 0] * q[..., [1, 2, 3, 0], 1]
                 - q[..., [1, 2, 3, 0], 0] * q[..., 1]).sum(-1)
        q = torch.where((area2 < 0)[..., None, None], q[..., [0, 3, 2, 1], :],
                        q).expand(-1, r1 - r0, -1, -1, -1)
        lv = torch.ones_like(c, dtype=torch.bool)
        if live is not None:
            rows = torch.arange(r0, r1, device=sub.device)[None, :, None]
            cols = torch.arange(m, device=sub.device)[None, None, :]
            lv = live(rows, cols).expand_as(c)
        ops = 2 * c + 5
        for e in range(4):
            a, bb = q[..., e, :], q[..., (e + 1) % 4, :]
            ex, ey = (bb - a).unbind(-1)
            side = ex[..., None] * (verts[..., 1] - a[..., None, 1]) - \
                ey[..., None] * (verts[..., 0] - a[..., None, 0])
            slots = torch.arange(verts.shape[-2], device=sub.device)
            inside = ((side >= 0) & (slots < c[..., None])).sum(-1)
            verts, c_out = _clip_half_plane(verts, c, a, bb,
                                            v + 1 + e)
            ops = ops + 5 * c + 8 * (c_out - inside)
            if exits is not None:
                exits[e] += int((lv & (c > 0) & (c_out == 0)).sum())
            c = c_out
        ops = ops + 4 * c
        if exits is not None:
            exits[4] += int((lv & (c > 0)).sum())
        row_ops = 4 * cnt[:, r0:r1].to(torch.int64) + 1
        total += float(torch.where(lv, ops, 0).sum())
        total += float(torch.where(lv.any(-1), row_ops, 0).sum())
        col_live |= lv.any(1)
    return total + 33.0 * float(col_live.sum())


def quad_subjects(quads):
    """(B, N, 8) quads as clip_pair_ops subjects: 4 slots, count 4."""
    b, n, _ = quads.shape
    return quads.view(b, n, 4, 2), torch.full((b, n), 4, device=quads.device)


def tri_live(nv):
    """The upper triangle inside the valid prefixes nv (B,)."""
    nv = nv.to(torch.int64).view(-1, 1, 1)
    return lambda rows, cols: (cols > rows) & (rows < nv) & (cols < nv)


def over_mask_case(entry, q, nv, thr=NMS_THR, reps=10):
    """The over-mask kernel (entry() launches it on quads q (B, N, 8) with
    prefixes nv and threshold thr) against its plain version, bit for bit:
    (the kernel line's fields, the plain version's words).  The live pairs
    are those of the upper triangle inside the prefixes; their clip-stage
    exits come from clip_pair_ops."""
    from orientedreppoints_tpu_torch.ops import quad_iou

    n = q.shape[1]
    got = entry()
    want = quad_iou.quad_over_mask_plain(q, thr, nv)
    diff = int(quad_iou.unpack_bits(got ^ want, n).sum())
    exits = [0] * 5
    ops = clip_pair_ops(*quad_subjects(q), q, tri_live(nv), exits)
    v = nv.to(torch.int64).clamp(0, n)
    live = max(1, int((v * (v - 1) // 2).sum()))
    return dict(
        max_abs_err=float(diff), differing_bits=diff, ok=diff == 0,
        set_bits=int(quad_iou.unpack_bits(want, n).sum()), live_pairs=live,
        live_stage0_exit_share=exits[0] / live,
        live_exit_share_by_stage=[x / live for x in exits[:4]],
        live_clip_nonempty_share=exits[4] / live,
        ms=cuda_ms(entry, reps),
        plain_ms=cuda_ms(lambda: quad_iou.quad_over_mask_plain(q, thr, nv),
                         1),
        library_ms=None,
        **bound(q.numel() * 4 + nv.numel() * 4 + want.numel() * 8, ops)), \
        want


def scan_case(words, valid, nv, reps=20):
    """The scan kernel against its plain version on one bitmask: the same
    keep exactly; the time per row is the kernel's over the longest prefix
    (the images run side by side)."""
    from orientedreppoints_tpu_torch.ops import nms

    n = valid.shape[1]
    keep = nms.greedy_scan(words, valid, nv)
    keep_plain = nms.greedy_scan_plain(words, valid, nv)
    ms = cuda_ms(lambda: nms.greedy_scan(words, valid, nv), reps)
    rows = max(1, int(nv.max()))
    inside = torch.arange(n, device=words.device) < nv[:, None].long()
    row_words = words.shape[-1] - torch.arange(n, device=words.device) // 64
    return dict(
        max_abs_err=float((keep != keep_plain).sum()),
        ok=bool(torch.equal(keep, keep_plain)), kept=int(keep.sum()),
        ms=ms, rows_walked=rows, ns_per_row=ms * 1e6 / rows,
        plain_ms=cuda_ms(lambda: nms.greedy_scan_plain(words, valid, nv), 1),
        library_ms=None,
        # the kept rows' mask words from their own word on, valid in, keep
        # out; no arithmetic
        **bound(float(((keep & inside) * row_words).sum()) * 8
                + 2 * keep.numel(), 0.0))


def min_area_rect_ops(counts) -> float:
    """Op model of one min-area rect per set with a hull of h vertices:
    the centroid 20, per gift-wrapping step (h + 1 of them) 9 distances
    and 81 cross products 279, per caliper edge (h) the rotated hull and
    its extent 6 h + 50, the rotation back 30."""
    h = counts.to(torch.float64)
    return float((50 + (h + 1) * 279 + h * (6 * h + 50)).sum())


def dcn_bytes_ops(rows, c, k, elem, backward, grad_elem=4):
    """Bytes and ops of the paired DCN sampling over rows x k samples of C
    channels in an elem-byte dtype.  Forward: two tables and the offsets
    in, two (rows, k C) buffers out; per sample 30 ops of plan, per
    channel and table 7 (four weighted corners).  Backward: tables,
    offsets and the two buffers' grads (grad_elem bytes: f32, as the
    autograd node hands them over) in, table and offset grads out; per
    channel and table 22 (four weighted scatters, two corner differences
    and their products with the grad)."""
    tables, offs = 2 * rows * c * elem, rows * 2 * k * elem
    if backward:
        return (tables + offs + 2 * rows * k * c * grad_elem + tables + offs,
                rows * k * (30 + 44 * c))
    return tables + offs + 2 * rows * k * c * elem, rows * k * (30 + 14 * c)


def rect_err(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row max corner distance over b's corner rotations/reversal."""
    a, b = a.view(-1, 4, 2), b.view(-1, 4, 2)
    errs = [(a - bb.roll(s, 1)).abs().amax((1, 2))
            for bb in (b, b.flip(1)) for s in range(4)]
    return torch.stack(errs).amin(0)


def rect_area(r: torch.Tensor) -> torch.Tensor:
    r = r.view(-1, 4, 2).double()
    return (r[:, 1] - r[:, 0]).norm(dim=-1) * (r[:, 2] - r[:, 1]).norm(dim=-1)


def rect_check(got: torch.Tensor, want: torch.Tensor):
    """Min-area rects of the kernel against the plain version: (max corner
    error over the boxes that agree, boxes that differ by more than
    RECT_TOL, ok).  A differing box is accepted only as a tie: the same
    area within the tie rule's relative 1e-5 (twice, for the two
    roundings)."""
    from orientedreppoints_tpu_torch.ops.geometry import TIE_RTOL

    err = rect_err(got, want)
    off = err > RECT_TOL
    rel = (rect_area(got) - rect_area(want)).abs() / rect_area(want).clamp(
        min=1e-6)
    return (float(err[~off].max()) if bool((~off).any()) else 0.0,
            int(off.sum()), bool((rel[off] <= 2 * TIE_RTOL).all()))


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
    from orientedreppoints_tpu_torch.ops import minarearect, quad_iou

    res = {}

    # min-area rect: the decode's B * sum(min(2000, HW)) = 25304 sets
    n = BATCH * sum(min(2000, h * w) for _, h, w in LEVELS)
    p = torch.tensor(point_sets(rng, n), dtype=torch.float32, device=dev)
    err, ties, ok = rect_check(minarearect.min_area_rect(p),
                               minarearect.min_area_rect_plain(p))
    # the hull output (the assigner's) must give the plain version's bits
    hull, count = minarearect.convex_hull_entry(p)
    hull_p, count_p = minarearect.convex_hull_plain(p)
    hull_exact = torch.equal(hull, hull_p) and torch.equal(count, count_p)
    res["min_area_rect"] = dict(
        max_abs_err=err, ok=ok and hull_exact,
        shape=[n, 18], hull_exact=hull_exact,
        hull_max_abs_err=float((hull - hull_p).abs().max()),
        ms=cuda_ms(lambda: minarearect.min_area_rect(p), 100),
        plain_ms=cuda_ms(lambda: minarearect.min_area_rect_plain(p), 3),
        hull_plain_ms=cuda_ms(lambda: minarearect.convex_hull_plain(p), 3),
        library_ms=None,
        # 72 bytes in, rect, hull and count (108 bytes) out a set
        **bound(n * (72 + 108), min_area_rect_ops(count_p)))
    say("kernel", name="min_area_rect", sets=n, ties=ties,
        tol_px=RECT_TOL, **res["min_area_rect"])

    # over-mask: B 4, N 4096 class-offset quads, nv = 4096; the scan over
    # the plain version's words
    q = torch.tensor(nms_quads(rng, BATCH, NQ), dtype=torch.float32,
                     device=dev)
    nv = torch.full((BATCH,), NQ, dtype=torch.int32, device=dev)
    res["quad_over_mask"], words = over_mask_case(
        lambda: quad_iou.quad_over_mask(q, NMS_THR, nv), q, nv)
    say("kernel", name="quad_over_mask", batch=BATCH, n=NQ,
        **res["quad_over_mask"])
    valid = torch.ones((BATCH, NQ), dtype=torch.bool, device=dev)
    res["nms_scan"] = scan_case(words, valid, nv)
    say("kernel", name="nms_scan", batch=BATCH, n=NQ, **res["nms_scan"])

    # paired DCN sampling over the 1344^2 batch-4 pyramid, C = 256, then
    # at the training and the 2016^2 TTA shapes
    rows = sum(b * h * w for b, h, w in LEVELS)
    errs, times = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        errs[dt], times[dt] = dcn_forward_case(dev, LEVELS, dt, 5)
    lib_err, lib_ms = grid_sample_check(dev, rows, LEVELS, backward=False)
    res["deform_sample_pair"] = dict(
        max_abs_err=errs[torch.bfloat16][0],
        ok=all(e[1] for e in errs.values()) and lib_err <= LIBRARY_TOL,
        ms=times[torch.bfloat16][0], plain_ms=times[torch.bfloat16][1],
        library_ms=lib_ms, **bound(*dcn_bytes_ops(rows, 256, 9, 2, False)))
    say("kernel", name="deform_sample_pair", rows=rows, channels=256,
        max_abs_err_f32=errs[torch.float32][0],
        max_abs_err_bf16=errs[torch.bfloat16][0],
        bit_equal_f32=errs[torch.float32][1],
        bit_equal_bf16=errs[torch.bfloat16][1],
        ms_f32=times[torch.float32][0], plain_ms_f32=times[torch.float32][1],
        ms_bf16=times[torch.bfloat16][0],
        plain_ms_bf16=times[torch.bfloat16][1],
        library="grid_sample, one call per level, bf16",
        library_max_abs_err_f32=lib_err, library_tol=LIBRARY_TOL,
        **{k: res["deform_sample_pair"][k] for k in
           ("library_ms", "bound_ms", "bound_by", "ok")})
    for what, levels in (("train", TRAIN_LEVELS), ("tta_2016", TTA_LEVELS)):
        n = sum(b * h * w for b, h, w in levels)
        (err, same), (ms, plain_ms) = dcn_forward_case(dev, levels,
                                                       torch.bfloat16, 5)
        res["deform_sample_pair"]["ok"] &= same
        say("kernel_shape", name="deform_sample_pair", shape=what, rows=n,
            channels=256, dtype="bfloat16", max_abs_err=err, bit_equal=same,
            ms=ms, plain_ms=plain_ms, ok=same,
            **bound(*dcn_bytes_ops(n, 256, 9, 2, False)))
    return res


def dcn_forward_case(dev, levels, dt, reps):
    """The paired DCN forward kernel against its plain version on seeded
    random tables and offsets (C 256, K 9): ((max error, bit equal),
    (kernel ms, plain ms))."""
    from orientedreppoints_tpu_torch.ops import deform_conv

    rows = sum(b * h * w for b, h, w in levels)
    ta = torch.randn(rows, 256, device=dev).to(dt)
    tb = torch.randn(rows, 256, device=dev).to(dt)
    offs = (torch.randn(rows, 18, device=dev) * 3).to(dt)
    got = deform_conv.deform_sample_pair(ta, tb, offs, levels)
    want = deform_conv.deform_sample_pair_plain(ta, tb, offs, levels)
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    same = all(differing_bits(g, w) == 0 for g, w in zip(got, want))
    del got, want
    times = (cuda_ms(lambda: deform_conv.deform_sample_pair(
                 ta, tb, offs, levels), reps),
             cuda_ms(lambda: deform_conv.deform_sample_pair_plain(
                 ta, tb, offs, levels), 2))
    del ta, tb, offs
    torch.cuda.empty_cache()
    return (err, same), times


def grid_sample_check(dev, rows, levels, backward: bool):
    """torch's grid_sample over the paired DCN's sample points (bilinear,
    zero padding; a pixel x lies at (2 x + 1) / w - 1), both
    tables as one 2C-channel map, one call per pyramid level; backward:
    its autograd backward (aten.grid_sampler_2d_backward).  Returns (max
    |grid_sample - plain version| in f32 over the outputs, relative to
    each output's largest element for the backward; the time of the calls
    in bf16).  Offset grads are compared at samples more than CELL_EDGE
    from a pixel line only: there the gradient jumps from one cell's
    difference to the next, and the two formulations round the position
    differently."""
    from orientedreppoints_tpu_torch.ops import deform_conv

    c, k = 256, 9
    errs, ms = [], None
    for dt in (torch.float32, torch.bfloat16):
        ta, tb = (torch.randn(rows, c, device=dev).to(dt) for _ in range(2))
        offs = (torch.randn(rows, 2 * k, device=dev) * 3).to(dt)
        ga, gb = ((torch.randn(rows, k * c, device=dev).to(dt)
                   for _ in range(2)) if backward else (None, None))
        base = deform_conv.dcn_base_offset(3).to(dev).view(k, 2)
        calls, start, edge = [], 0, []
        for b, h, w in levels:
            n = b * h * w
            off = offs[start:start + n].float().view(b, h, w, k, 2) + base
            py = off[..., 0] + torch.arange(h, device=dev).view(1, h, 1, 1)
            px = off[..., 1] + torch.arange(w, device=dev).view(1, 1, w, 1)
            grid = torch.stack([(2 * px + 1) / w - 1, (2 * py + 1) / h - 1],
                               -1).view(b, h * w * k, 1, 2).to(dt)
            frac = torch.stack([py, px], -1).frac().abs()
            edge.append((torch.minimum(frac, 1 - frac) < CELL_EDGE).any(-1)
                        .reshape(-1, k).repeat_interleave(2, 1))
            x = torch.cat([ta[start:start + n], tb[start:start + n]], 1)
            x = x.view(b, h, w, 2 * c).permute(0, 3, 1, 2).contiguous()
            g = None
            if backward:
                g = torch.cat([ga[start:start + n].view(b, h * w * k, c),
                               gb[start:start + n].view(b, h * w * k, c)], 2)
                g = g.permute(0, 2, 1)[..., None].contiguous()
            calls.append((x, grid, g, (b, h, w)))
            start += n

        def library():
            if backward:
                return [torch.ops.aten.grid_sampler_2d_backward(
                    g, x, grid, 0, 0, False, [True, True])
                    for x, grid, g, _ in calls]
            return [torch.nn.functional.grid_sample(
                x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=False) for x, grid, _, _ in calls]

        if dt == torch.bfloat16:
            ms = cuda_ms(library, 5) if dev.type == "cuda" else None
            break
        outs = library()
        if backward:
            want = deform_conv.deform_sample_pair_backward_plain(
                ta, tb, offs, ga, gb, levels)
            gtab = torch.cat([gx.permute(0, 2, 3, 1).reshape(-1, 2 * c)
                              for gx, _ in outs])
            goff = torch.cat([
                (gg.view(b, h, w, k, 2)
                 * torch.tensor([2 / w, 2 / h], device=dev)
                 ).flip(-1).reshape(-1, 2 * k)
                for (_, gg), (_, _, _, (b, h, w)) in zip(outs, calls)])
            goff = torch.where(torch.cat(edge), want[2], goff)
            got = (gtab[:, :c], gtab[:, c:], goff)
            errs = [float((x - y).abs().max() / y.abs().max())
                    for x, y in zip(got, want)]
        else:
            want = deform_conv.deform_sample_pair_plain(ta, tb, offs, levels)
            out = torch.cat([o.permute(0, 2, 1, 3).reshape(-1, k, 2 * c)
                             for o in outs])
            got = (out[..., :c].reshape(rows, -1),
                   out[..., c:].reshape(rows, -1))
            errs = [float((x - y).abs().max()) for x, y in zip(got, want)]
        del calls, outs, want, got
    return max(errs), ms


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
    from orientedreppoints_tpu_torch.core import points
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
    # the step's masks: 150 valid gts, the points inside the true sizes
    gt_valid = torch.zeros((b, g), dtype=torch.bool, device=dev)
    gt_valid[:, :TRAIN_GTS] = True
    rows_valid = torch.cat(points.multi_level_valid_flags(
        (TRAIN_CANVAS, TRAIN_CANVAS), STRIDES,
        torch.tensor(TRAIN_HW, device=dev)), 1).contiguous()
    got = hull_iou.hull_quad_iou_matrix(hulls, counts, q, gt_valid,
                                        rows_valid)
    want = hull_iou.hull_quad_iou_matrix_plain(hulls, counts, q, gt_valid,
                                               rows_valid)
    bits = differing_bits(got, want)
    # the entry without masks, every pair computed
    got_all = hull_iou.hull_quad_iou_matrix(hulls, counts, q)
    bits_all = differing_bits(got_all, hull_iou.hull_quad_iou_matrix_plain(
        hulls, counts, q))
    del got_all
    exits = [0] * 5
    ops = clip_pair_ops(hulls, counts, q, lambda rows, cols: (
        rows_valid[:, rows[0, :, 0], None] & gt_valid[:, None, cols[0, 0]]),
        exits)
    live_pairs = int((rows_valid[:, :, None] & gt_valid[:, None, :]).sum())
    res["hull_quad_iou"] = dict(
        max_abs_err=float((got - want).abs().max()), differing_bits=bits,
        differing_bits_unmasked=bits_all,
        ok=bits == 0 and bits_all == 0 and hull_exact,
        pairs_iou_gt_0p1=int((want > 0.1).sum()),
        ms=cuda_ms(lambda: hull_iou.hull_quad_iou_matrix(
            hulls, counts, q, gt_valid, rows_valid), 10),
        ms_unmasked=cuda_ms(lambda: hull_iou.hull_quad_iou_matrix(
            hulls, counts, q), 10),
        plain_ms=cuda_ms(lambda: hull_iou.hull_quad_iou_matrix_plain(
            hulls, counts, q, gt_valid, rows_valid), 1),
        library_ms=None,
        # hulls, counts, quads and masks in; the (B, G, N) f32 matrix out;
        # the operations of the live pairs only
        **bound(hulls.numel() * 4 + counts.numel() * 4 + q.numel() * 4
                + gt_valid.numel() + rows_valid.numel() + got.numel() * 4,
                ops))
    say("kernel", name="hull_quad_iou", batch=b, hulls=n, gts=g,
        valid_gts=TRAIN_GTS, valid_rows=int(rows_valid.sum()),
        pairs=b * n * g, live_pairs=live_pairs,
        live_exit_share_by_stage=[x / max(1, live_pairs) for x in exits[:4]],
        live_clip_nonempty_share=exits[4] / max(1, live_pairs),
        hull_sets=b * n, hull_exact=hull_exact, hull_ms=hull_ms,
        hull_plain_ms=hull_plain_ms, **res["hull_quad_iou"])
    del got, want

    # the min-area rect at the step's other two calls: APAA's rects of the
    # init and refine point sets of B x max_pos candidates
    apaa = torch.tensor(point_sets(rng, b * 1024), dtype=torch.float32,
                        device=dev)
    err, ties, ok = rect_check(minarearect.min_area_rect(apaa),
                               minarearect.min_area_rect_plain(apaa))
    hull_a, count_a = minarearect.convex_hull_entry(apaa)
    hull_ap, count_ap = minarearect.convex_hull_plain(apaa)
    exact = torch.equal(hull_a, hull_ap) and torch.equal(count_a, count_ap)
    res["min_area_rect_train"] = dict(ok=ok and exact and hull_exact)
    for what, x, counts in (("train_apaa", apaa, count_ap),
                            ("train_convex_iou", sets, counts_p)):
        say("kernel_shape", name="min_area_rect", shape=what,
            sets=int(x.shape[0]), max_abs_err=err if x is apaa else None,
            ties=ties if x is apaa else None, hull_exact=exact
            if x is apaa else hull_exact,
            ms=cuda_ms(lambda: minarearect.min_area_rect_kernel(x), 100),
            plain_ms=cuda_ms(lambda: minarearect.min_area_rect_plain(x), 3),
            **bound(x.shape[0] * (72 + 108), min_area_rect_ops(counts)))

    rows = sum(bb * h * w for bb, h, w in TRAIN_LEVELS)
    c, k = 256, 9
    errs, times = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        ta, tb = (torch.randn(rows, c, device=dev).to(dt) for _ in range(2))
        offs = (torch.randn(rows, 2 * k, device=dev) * 3).to(dt)
        # the sample grads come from the autograd node's f32 matmul
        ga, gb = (torch.randn(rows, k * c, device=dev) for _ in range(2))
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
    lib_err, lib_ms = grid_sample_check(dev, rows, TRAIN_LEVELS,
                                        backward=True)
    torch.cuda.empty_cache()
    res["deform_sample_pair_backward"] = dict(
        max_abs_err=max(e for e, _ in errs["bfloat16"]),
        ok=ok and lib_err <= LIBRARY_TOL,
        ms=times["bfloat16"][0], plain_ms=times["bfloat16"][1],
        library_ms=lib_ms, **bound(*dcn_bytes_ops(rows, c, k, 2, True)))
    say("kernel", name="deform_sample_pair_backward", rows=rows, channels=c,
        max_abs_err_f32=[e for e, _ in errs["float32"]],
        max_abs_err_bf16=[e for e, _ in errs["bfloat16"]],
        grad_scale_f32=[s for _, s in errs["float32"]],
        grad_scale_bf16=[s for _, s in errs["bfloat16"]],
        rtol=DCN_BWD_RTOL, ms_f32=times["float32"][0],
        plain_ms_f32=times["float32"][1], ms_bf16=times["bfloat16"][0],
        plain_ms_bf16=times["bfloat16"][1],
        library="aten.grid_sampler_2d_backward, one call per level, bf16",
        library_max_rel_err_f32=lib_err, library_tol=LIBRARY_TOL,
        **{k: res["deform_sample_pair_backward"][k] for k in
           ("library_ms", "bound_ms", "bound_by", "ok")})
    return res


@contextlib.contextmanager
def plain_quad_iou():
    """Route the f32 IoU entries (soft_rnms, box_iou_rotated) through the
    plain version on the card."""
    from orientedreppoints_tpu_torch.ops import nms, quad_iou

    saved = (nms.quad_iou_matrix, quad_iou.quad_iou_matrix)
    plain = (lambda a, b: quad_iou.quad_iou_matrix_plain(a[None],
                                                         b[None])[0])
    nms.quad_iou_matrix = quad_iou.quad_iou_matrix = plain
    try:
        yield
    finally:
        nms.quad_iou_matrix, quad_iou.quad_iou_matrix = saved


def differing_bits(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of two f32 or bf16 tensors whose bits differ."""
    as_int = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return int((a.view(as_int) != b.view(as_int)).sum())


def phase_quad_kernels(dev, rng):
    """Kernels 4 and 5 (full and upper-triangle f32 IoU) and the
    single-image over-mask at NMS shapes, each against its plain version;
    the over-mask bits against (tri > thr); soft_rnms and box_iou_rotated
    through the kernel and through the plain version."""
    from orientedreppoints_tpu_torch.ops import geometry, nms, quad_iou

    res = {}
    nq = NQ
    q4 = torch.tensor(nms_quads(rng, 4, nq), dtype=torch.float32,
                      device=dev)
    q = q4[0].contiguous()
    full = quad_iou.quad_iou_matrix(q, q)
    full_p = quad_iou.quad_iou_matrix_plain(q[None], q[None])[0]
    bits = differing_bits(full, full_p)
    res["quad_iou_full"] = dict(
        max_abs_err=float((full - full_p).abs().max()), differing_bits=bits,
        ok=bits == 0, iou_gt_0p4=int((full_p > NMS_THR).sum()),
        ms=cuda_ms(lambda: quad_iou.quad_iou_matrix(q, q), 10),
        plain_ms=cuda_ms(lambda: quad_iou.quad_iou_matrix_plain(
            q[None], q[None]), 1),
        library_ms=None,
        **bound(2 * q.numel() * 4 + full.numel() * 4,
                clip_pair_ops(*quad_subjects(q[None]), q[None])))
    say("kernel", name="quad_iou_full", n=nq, m=nq, **res["quad_iou_full"])
    del full, full_p

    nv = torch.tensor(TRI_NV, dtype=torch.int32, device=dev)
    tri = quad_iou.quad_iou_matrix_batch(q4, q4, True, nv)
    tri_p = quad_iou.quad_iou_matrix_plain(q4, q4, True, nv)
    bits = differing_bits(tri, tri_p)
    live = tri_live(nv)
    res["quad_iou_tri"] = dict(
        max_abs_err=float((tri - tri_p).abs().max()), differing_bits=bits,
        ok=bits == 0,
        ms=cuda_ms(lambda: quad_iou.quad_iou_matrix_batch(q4, q4, True, nv),
                   10),
        plain_ms=cuda_ms(lambda: quad_iou.quad_iou_matrix_plain(
            q4, q4, True, nv), 1),
        library_ms=None,
        **bound(2 * q4.numel() * 4 + nv.numel() * 4 + tri.numel() * 4,
                clip_pair_ops(*quad_subjects(q4), q4, live)))
    say("kernel", name="quad_iou_tri", batch=4, n=nq, num_valid=TRI_NV,
        **res["quad_iou_tri"])
    del tri_p

    # the over-mask's bits are (tri > thr) of the same pairs, every bit
    mask = quad_iou.quad_over_mask(q4, NMS_THR, nv)
    over_vs_tri = int(quad_iou.unpack_bits(
        mask ^ quad_iou.pack_bits(tri > NMS_THR), nq).sum())
    del mask, tri
    res["quad_over_mask_single"], words = over_mask_case(
        lambda: quad_iou.quad_over_matrix(q, NMS_THR, nv[0])[None], q[None],
        nv[:1])
    res["quad_over_mask_single"].update(
        over_mask_vs_tri_differing_bits=over_vs_tri,
        ok=res["quad_over_mask_single"]["ok"] and over_vs_tri == 0)
    say("kernel", name="quad_over_mask_single", n=nq,
        **res["quad_over_mask_single"])

    # the scan at the merge's shape (one image), over the same words
    valid = torch.ones((1, nq), dtype=torch.bool, device=dev)
    scan = scan_case(words, valid, nv[:1])
    say("kernel_shape", name="nms_scan", batch=1, n=nq, **scan)
    same = scan["ok"]

    # the entries of kernel 4 through the kernel and the plain version
    qs = q[:nq // 2].contiguous()
    scores = torch.tensor(rng.uniform(0.05, 1.0, len(qs)),
                          dtype=torch.float32, device=dev)
    rb = torch.tensor(np.concatenate([rng.uniform(0, 1344, (3000, 2)),
                                      rng.uniform(8, 120, (3000, 2)),
                                      rng.uniform(-np.pi, np.pi, (3000, 1))],
                                     1), dtype=torch.float32, device=dev)
    runs = []
    for route in ("kernel", "plain"):
        with plain_quad_iou() if route == "plain" else \
                contextlib.nullcontext():
            runs.append((nms.soft_rnms(qs, scores),
                         geometry.box_iou_rotated(rb[:2000], rb[1000:])))
    ((sk, kk), bk), ((sp, kp), bp) = runs
    same_soft = bool(torch.equal(kk, kp)) and bool(torch.equal(sk, sp))
    bits = differing_bits(bk, bp)
    say("entries", soft_rnms_same_keep_and_scores=same_soft,
        soft_rnms_kept=int(kk.sum()), box_iou_rotated_differing_bits=bits,
        box_iou_rotated_pairs_gt_0p3=int((bp > 0.3).sum()),
        ok=same_soft and bits == 0)
    return res, same_soft and bits == 0 and same


def normalized_images(cfg, rng, n, size):
    """n seeded size^2 BGR uint8 images as the dataset items run_inference
    takes: normalized, and resized (bilinear, keep ratio) to fill the
    canvas, with that scale factor.  Random weights detect all over the
    canvas, padding included; filling it puts every det's origin inside
    the image, so that mapped back each must land in its size^2 frame."""
    from orientedreppoints_tpu_torch.host import Normalize, resize_linear

    norm = Normalize(**cfg["img_norm_cfg"])
    canvas = tuple(cfg["tpu"]["canvas_buckets"][-1])
    factor = min(canvas) / size
    side = int(size * factor + 0.5)
    items = []
    for i in range(n):
        img = norm(torch.from_numpy(
            (rng.random((size, size, 3)) * 255).astype(np.uint8)))
        items.append(dict(
            img=resize_linear(img[None], (side, side))[0].numpy(),
            scale_factor=factor, img_info=dict(file_name=f"img{i}.png")))
    return items


@contextlib.contextmanager
def wrapping(module, name, on_call):
    """Wrap module.name so that every call also passes (args, kwargs,
    result) to on_call."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        on_call(args, kwargs, out)
        return out
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def recording(module, name, record):
    """Append (args, kwargs, result) of every call of module.name."""
    return wrapping(module, name, lambda *call: record.append(call))


def checking(module, name, plain, compare, record):
    """Also run plain on the inputs of every call of module.name and
    append compare(args, result, plain result) to record."""
    return wrapping(module, name, lambda args, kwargs, out: record.append(
        compare(args, out, plain(*args, **kwargs))))


def dcn_compare(args, got, want):
    """One paired-DCN forward call against its plain version: the
    pyramid's first level and rows, the max error, and ok if the two give
    the same bits."""
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    bits = sum(differing_bits(g, w) for g, w in zip(got, want))
    return dict(level0=list(args[3][0]), rows=int(args[0].shape[0]),
                dtype=str(got[0].dtype).split(".")[-1], max_abs_err=err,
                differing_bits=bits, ok=bits == 0)


def rect_compare(args, got, want):
    err, ties, ok = rect_check(got, want)
    return dict(sets=int(args[0].shape[0]), max_abs_err=err, ties=ties,
                ok=ok)


def centres_in_frame(results, size):
    """(every det finite, dets whose centre lies in the size^2 image frame
    +- 8 px, dets within +- (8 px + FRAME_SPREAD), dets) over
    run_inference-style results."""
    dets = np.concatenate([a for per_class in results.values()
                           for a in per_class])
    c = np.stack([dets[:, 0:8:2].mean(1), dets[:, 1:8:2].mean(1)], 1)

    def inside(margin):
        return int(((c > -margin) & (c < size + margin)).all(1).sum())
    return (bool(np.isfinite(dets).all()), inside(8),
            inside(8 + FRAME_SPREAD), len(dets))


def phase_tta(model, cfg, test_cfg, dataset, ops_mod, card):
    from orientedreppoints_tpu_torch import apis

    canvas = tuple(cfg["tpu"]["canvas_buckets"][-1])

    def run(data, record=None):
        with (recording(apis, "decode_no_nms", record)
              if record is not None else contextlib.nullcontext()):
            out = apis.run_inference_tta(model, data, test_cfg, TTA_AUGS,
                                         canvas=canvas, batch_size=TTA_BATCH)
        torch.cuda.synchronize()
        return out

    run(dataset[:TTA_BATCH])  # warm-up batch
    torch.cuda.reset_peak_memory_stats()
    record = []
    ops_mod.reset_launch_counts()
    results = run(dataset, record)
    launches = ops_mod.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(dataset)
        times.append(time.perf_counter() - t0)

    # decode_no_nms calls: per batch, the augs of each scale in turn
    order = [ai for r in dict.fromkeys(r for r, _ in TTA_AUGS)
             for ai, (rr, _) in enumerate(TTA_AUGS) if rr == r]
    thr = test_cfg["score_thr"]
    per_aug = {ai: [] for ai in range(len(TTA_AUGS))}
    for i, (_, _, (boxes, scores)) in enumerate(record):
        per_aug[order[i % len(order)]] += (scores > thr).sum((1, 2)).tolist()
    for ai, (r, flip) in enumerate(TTA_AUGS):
        say("tta_aug", scale=r, flip=flip,
            candidates_per_image=per_aug[ai][:TTA_IMAGES])
    merged = [min(sum(per_aug[ai][i] for ai in per_aug),
                  test_cfg.get("pre_nms_cap", 4096))
              for i in range(TTA_IMAGES)]
    finite, near, within, dets = centres_in_frame(results, TTA_SIZE)
    kept = [sum(len(a) for a in results[f"img{i}"])
            for i in range(TTA_IMAGES)]
    ips = [TTA_IMAGES / t for t in times]
    ok = (len(results) == TTA_IMAGES and min(kept) > 0 and finite
          and within == dets and min(merged) >= 1000
          and all(launches[k] > 0 for k in TTA_KERNELS))
    say("tta", config=CONFIG, augs=TTA_AUGS, batch=TTA_BATCH,
        images=TTA_IMAGES, image_size=TTA_SIZE, dtype="bfloat16",
        merged_candidates_per_image=merged, dets_kept=kept,
        launches=launches, finite=finite, dets=dets,
        centres_within_8px_of_frame=near,
        centres_within_8px_plus_spread=within, spread_px=FRAME_SPREAD,
        images_per_s_median=statistics.median(ips), images_per_s=ips,
        max_memory_allocated_bytes=peak, card=card, ok=ok)
    return ok, launches


@contextlib.contextmanager
def plain_merge():
    """Route the TTA merge's NMS through the plain versions on the card."""
    from orientedreppoints_tpu_torch.ops import nms, quad_iou

    saved = (nms.quad_over_mask, nms.greedy_scan)
    nms.quad_over_mask = quad_iou.quad_over_mask_plain
    nms.greedy_scan = nms.greedy_scan_plain
    try:
        yield
    finally:
        nms.quad_over_mask, nms.greedy_scan = saved


def same_dets(a, b) -> tuple[bool, float, float]:
    """(labels equal, max poly error px, max score error) of two
    (dets, labels, valid) triples."""
    (d, lab, v), (d2, lab2, v2) = a, b
    if not (torch.equal(v, v2) and torch.equal(lab[v], lab2[v])):
        return False, float("inf"), float("inf")
    return (True, float(rect_err(d[v][:, :8], d2[v][:, :8]).max()),
            float((d[v][:, 8] - d2[v][:, 8]).abs().max()))


def phase_tta_check(model, cfg, test_cfg, dataset):
    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch.models import detector

    canvas = tuple(cfg["tpu"]["canvas_buckets"][-1])
    data = dataset[:TTA_BATCH]
    plain = apis.run_inference(model, data, test_cfg, canvas=canvas,
                               batch_size=TTA_BATCH)
    ident = apis.run_inference_tta(model, data, test_cfg, [(1.0, False)],
                                   canvas=canvas, batch_size=TTA_BATCH)
    same_labels, poly_err, score_err, dets = True, 0.0, 0.0, 0
    for name, per_class in plain.items():
        for a, b in zip(per_class, ident[name]):
            same_labels &= a.shape == b.shape
            if same_labels and len(a):
                poly_err = max(poly_err, float(rect_err(
                    torch.from_numpy(a[:, :8]),
                    torch.from_numpy(b[:, :8])).max()))
                score_err = max(score_err, float(np.abs(a[:, 8]
                                                        - b[:, 8]).max()))
                dets += len(a)
    ok_a = (same_labels and set(plain) == set(ident) and dets > 0
            and poly_err <= RECT_TOL and score_err == 0.0)

    # (b) one batch of the full recipe: every DCN forward and min-area-rect
    # call of the path (each scale's canvas) against its plain version on
    # the same inputs, then the merged candidates through the kernels and
    # through the plain over-mask and scan
    from orientedreppoints_tpu_torch.ops import deform_conv, geometry

    record, dcn, rects = [], [], []
    with recording(apis, "merge_aug_and_nms", record), \
            checking(deform_conv, "deform_sample_pair",
                     deform_conv.deform_sample_pair_plain, dcn_compare, dcn), \
            checking(detector, "min_area_rect", geometry.min_area_rect,
                     rect_compare, rects):
        apis.run_inference_tta(model, data, test_cfg, TTA_AUGS,
                               canvas=canvas, batch_size=TTA_BATCH)
    for name, calls in (("deform_sample_pair", dcn), ("min_area_rect", rects)):
        for c in calls:
            say("tta_kernel", name=name, **c)
    ok_b = (len(dcn) == len(rects) == len(TTA_AUGS)
            and all(c["ok"] for c in dcn + rects))
    errs = []
    with torch.inference_mode():
        for args, kwargs, out in record:
            with plain_merge():
                out_p = detector.merge_aug_and_nms(*args, **kwargs)
            same, pe, se = same_dets(out, out_p)
            errs.append((int(out[2].sum()), pe, se))
            ok_b &= same and pe <= RECT_TOL and se == 0.0
    say("tta_check", identity_same_labels=same_labels, identity_dets=dets,
        identity_max_err_poly_px=poly_err, identity_max_err_score=score_err,
        dcn_calls_checked=len(dcn), min_area_rect_calls_checked=len(rects),
        merge_dets_poly_err_score_err=errs, ok=ok_a and ok_b)
    return ok_a and ok_b, record


def phase_iou_path(record, ops_mod, test_cfg):
    """The f32 IoU kernels' path: soft_rnms over one image's merged TTA
    candidates (the top 2048 boxes by best class score) and the
    upper-triangle IoU entry over them, score-sorted with their valid
    prefix."""
    from orientedreppoints_tpu_torch.ops import nms, quad_iou

    args, _, _ = record[0]
    boxes = torch.cat(args[0])  # each aug in its test-scale frame
    scores = torch.cat(args[1])[:, 1:].amax(1)
    top, idx = nms.topk_stable(scores, 2048)
    quads = boxes[idx].contiguous()
    ops_mod.reset_launch_counts()
    with torch.inference_mode():
        decayed, keep = nms.soft_rnms(quads, top, method="gaussian")
        nv = (top > test_cfg["score_thr"]).sum(dtype=torch.int32)
        tri = quad_iou.quad_iou_matrix(quads, quads, upper_tri=True,
                                       num_valid=nv)
    torch.cuda.synchronize()
    launches = ops_mod.launch_counts()
    ok = (all(launches[k] > 0 for k in IOU_PATH_KERNELS)
          and bool(torch.isfinite(decayed).all()) and int(keep.sum()) > 0
          and bool(torch.isfinite(tri).all()))
    say("iou_path", candidates=int(quads.shape[0]), num_valid=int(nv),
        soft_kept=int(keep.sum()), tri_pairs_gt_0p4=int((tri > 0.4).sum()),
        launches=launches, ok=ok)
    return ok, launches


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


def phase_host(dev, rng):
    """host.imrescale (cv2's uint8 INTER_LINEAR in int32) on the card
    against the same call on the CPU, at sizes that resize under the demo
    config's (1333, 1024) test scale: integer arithmetic, so equal."""
    from orientedreppoints_tpu_torch.host import imrescale

    ok, lines = True, []
    for h, w in ((1023, 767), (1500, 2000), (800, 800)):
        img = torch.from_numpy(rng.integers(0, 256, (h, w, 3),
                                            dtype=np.uint8))
        want, factor = imrescale(img, (1333, 1024))
        got, factor_dev = imrescale(img.to(dev), (1333, 1024))
        same = (got.dtype == want.dtype == torch.uint8
                and factor_dev == factor
                and torch.equal(got.cpu(), want))
        ok &= same
        lines.append(dict(size=[h, w], out=list(want.shape[:2]),
                          equal=same))
    say("host", name="imrescale", cases=lines, ok=ok)
    return ok


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
    from orientedreppoints_tpu_torch.ops import nms, quad_iou

    tc = pred.test_cfg
    kw = dict(nms_pre=tc["nms_pre"], score_thr=tc["score_thr"],
              iou_thr=tc["nms"]["iou_thr"], max_per_img=tc["max_per_img"],
              pre_nms_cap=tc.get("pre_nms_cap", 4096))
    outs = {k: [t.float() for t in outs[k]]
            for k in ("cls_scores", "pts_refine")}
    overs, scans = [], []
    with torch.inference_mode():
        with recording(nms, "quad_over_mask", overs), \
                recording(nms, "greedy_scan", scans):
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
          and err_poly <= RECT_TOL and len(overs) == len(scans) == 1)
    # both NMS kernels on this batch's own candidates (the top 4096
    # class-offset boxes an image), bit for bit and timed
    (q, thr, nv), _, _ = overs[0]
    (words, top_valid, _), _, _ = scans[0]
    with torch.inference_mode():
        over, want = over_mask_case(
            lambda: quad_iou.quad_over_mask(q, thr, nv), q, nv, thr)
        scan = scan_case(want, top_valid, nv)
    ok = ok and over["ok"] and scan["ok"] and torch.equal(words, want)
    for name, line in (("quad_over_mask", over), ("nms_scan", scan)):
        say("kernel_shape", name=name, shape="decode_candidates",
            batch=int(q.shape[0]), n=int(q.shape[1]),
            num_valid=nv.tolist(), **line)
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
    rng_quad = np.random.default_rng(SEED + 2)
    rng_host = np.random.default_rng(SEED + 3)
    kernels = phase_kernels(dev, rng)
    train_res = phase_train_kernels(dev, rng_train)
    kernels["min_area_rect"]["ok"] &= train_res.pop(
        "min_area_rect_train")["ok"]
    kernels.update(train_res)
    quad_res, ok_entries = phase_quad_kernels(dev, rng_quad)
    kernels.update(quad_res)
    ok_host = phase_host(dev, rng_host)
    ok_slice, launches, pred, outs = phase_slice(dev, rng, ops_mod, card)
    ok_decode = phase_decode(pred, outs)
    del outs
    dataset = normalized_images(pred.cfg, rng, TTA_IMAGES, TTA_SIZE)
    ok_tta, launches_tta = phase_tta(pred.model, pred.cfg, pred.test_cfg,
                                     dataset, ops_mod, card)
    ok_tta_check, merges = phase_tta_check(pred.model, pred.cfg,
                                           pred.test_cfg, dataset)
    ok_iou, launches_iou = phase_iou_path(merges, ops_mod, pred.test_cfg)
    del pred, merges
    torch.cuda.empty_cache()

    from orientedreppoints_tpu_torch.host import load_config
    from orientedreppoints_tpu_torch.parallel.train import to_device

    sd = perturbed_weights(rng_train)
    max_gt = load_config(CONFIG)["tpu"]["max_gt"]
    batch = to_device(train_batch(rng_train, max_gt), dev)
    ok_train, launches_train = phase_train(dev, ops_mod, card, sd, batch)
    torch.cuda.empty_cache()
    ok_check = phase_train_check(dev, ops_mod, sd, batch)

    # launches: each kernel's count over the counted runs of the paths
    # that run it (serving, training, TTA, the IoU path); the single-image
    # over-mask is the TTA run's over-mask count
    runs = (launches, launches_train, launches_tta, launches_iou)
    counts = {name: sum(r[name] for r in runs) for name in ops_mod.KERNELS}
    counts["quad_over_mask"] = launches["quad_over_mask"] + \
        launches_train["quad_over_mask"]
    counts["quad_over_mask_single"] = launches_tta["quad_over_mask"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCES[name][0],
             replaces=SOURCES[name][1], launches=counts[name],
             **{k: r[k] for k in keys})
        for name, r in kernels.items()]}))
    print(card)
    if not (all(r["ok"] for r in kernels.values()) and ok_entries
            and ok_host and ok_slice and ok_decode and ok_tta and ok_tta_check
            and ok_iou and ok_train and ok_check):
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

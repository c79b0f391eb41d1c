"""The serving driver: closed loop, one client, batches of the mix's
images through serving.Predictor.__call__.

Set-up builds the Predictor from the seeded weights, on the mix's
canvas, and calls it on the warm-up batch (images outside the window's
pool).  The window calls it back to back over the pool for --seconds and
times each call from entry to its per-class results on the host.  A
sample of the window's batches, drawn from the seed before it, has its
prepared canvases and head outputs copied as they pass; once the window
has closed and the program is dropped, the reference works out the same
batches from the same images and weights and judges:

  canvas_max_abs    the prepared canvases (resize, normalize, paste);
  head_rel_l2       the class logits and both point sets at all levels,
                    ||program - reference|| / ||reference||, the worst of
                    the three;
  decode_unmatched  the reference's decode and NMS on the program's own
                    head outputs against the program's detections: share
                    without a partner (class, IoU >= 0.99, score within
                    1e-4), so the decode stage is judged by itself;

Beside them, not compared: each head output's gap, and dets_missed, the
share of the reference's own top_compare detections an image that the
program's miss (same class, IoU >= 0.9), the whole chain end to end.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from port_bench.reference import decode, detector, ops, prep

from . import compare, measure, traffic, weights
from .main import Cell

HEAD_KEYS = ("cls_scores", "pts_init", "pts_refine")


class Capture:
    """Copies of the prepared canvases and head outputs of the calls made
    while `on`, taken where the Predictor passes them on."""

    def __init__(self, pred):
        self.on, self.got = False, {}
        model = pred.model

        def prepare(images):
            out = type(pred).prepare(pred, images)
            if self.on:
                self.got["canvases"] = out[0].clone()
            return out

        def forward(*args, **kwargs):
            outs = type(model).forward(model, *args, **kwargs)
            if self.on:
                self.got["head"] = {k: [t.clone() for t in outs[k]]
                                    for k in HEAD_KEYS}
            return outs

        pred.prepare, model.forward = prepare, forward

    def take(self) -> dict:
        got, self.got = self.got, {}
        return got


def canvas(cell: Cell) -> tuple[int, int]:
    """The mix's canvas: the images are pasted onto it."""
    return (cell.traffic["canvas"],) * 2


def program_cfg(cell: Cell) -> dict:
    """The configuration the Predictor runs: the cell's, its one canvas
    bucket the mix's canvas."""
    cfg = dict(cell.cfg)
    cfg["tpu"] = dict(cfg["tpu"], canvas_buckets=[list(canvas(cell))])
    return cfg


def test_cfg(cell: Cell) -> dict:
    tc = dict(cell.cfg["test_cfg"])
    tc.update(cell.traffic.get("test_cfg", {}))
    return tc


def ref_canvases(cell: Cell, images: list, device):
    """The reference's prepared canvases of a batch, and its scale
    factors."""
    cfg = cell.cfg
    scale = next(s["img_scale"] for s in cfg["data"]["test"]["pipeline"]
                 if s["type"] == "RotateResize")
    norm = cfg["img_norm_cfg"]
    canv, sfs = zip(*(prep.canvas(im, scale, norm["mean"], norm["std"],
                                  canvas(cell)) for im in images))
    return torch.stack(canv).to(device), sfs


BIAS_KEY = "bbox_head.cls_out.bias"


def draw_weights(cell: Cell, device, bias=None) -> dict:
    """The cell's seeded weights (weights.draw).  Where the mix's weight
    rules give cls_share, each class's cls_out bias is then `bias`, the
    one that set-up calibrated for the program, or else is set from the
    reference's float32 logits on the warm-up batch's first image (apart
    from the window's), so that that share of the class's (location,
    class) pairs scores above score_thr: the logits' mean and spread move
    with the seed by more than a fixed bias can hold."""
    mix = cell.traffic
    p = weights.draw(cell.cfg, mix["weights"], cell.seed, device)
    share = mix["weights"].get("cls_share")
    if share is None:
        return p
    if bias is not None:
        p[BIAS_KEY] = bias
        return p
    image = traffic.serve_images(mix, cell.seed, device)[0][0]
    canv, _ = ref_canvases(cell, [image], device)
    with torch.no_grad(), ops.f32_inside():
        levels = detector.forward(p, canv, cell.cfg)["cls_scores"]
    r = torch.cat([x.reshape(-1, x.shape[-1]) for x in levels]) - p[BIAS_KEY]
    mean, std = r.mean(0), r.std(0)
    z = torch.quantile(((r - mean) / std).flatten(), 1.0 - share)
    thr = test_cfg(cell)["score_thr"]
    p[BIAS_KEY] = (math.log(thr / (1.0 - thr)) - mean - z * std).contiguous()
    return p


def reference(cell: Cell, p: dict, images: list, device,
              precision: str | None = None,
              decode_precision: str | None = None) -> dict:
    """The reference's canvases, head outputs and detections of a batch;
    the model's products at `precision`, the decode at
    `decode_precision` (None: float32)."""
    cfg, mix = cell.cfg, cell.traffic
    canvases, sfs = ref_canvases(cell, images, device)
    t0 = time.perf_counter()
    parts = []
    chunk = mix["reference_chunk"]
    with torch.no_grad(), ops.lower_precision(precision):
        for lo in range(0, len(images), chunk):
            outs = detector.forward(p, canvases[lo:lo + chunk], cfg)
            parts.append({k: outs[k] for k in HEAD_KEYS})
            del outs
    head = {k: [torch.cat(lv) for lv in zip(*(q[k] for q in parts))]
            for k in HEAD_KEYS}
    t = time.perf_counter()
    dets = decode.detect(head, test_cfg(cell), sfs,
                         precision=decode_precision)
    measure.say(f"reference forward {t - t0:.1f} s, decode "
                f"{time.perf_counter() - t:.1f} s")
    num_fg = cfg["model"]["bbox_head"]["num_classes"] - 1
    return {"canvases": canvases, "sfs": sfs, "head": head, "dets": dets,
            "results": [decode.per_class(d, lab, num_fg) for d, lab in dets]}


def numbers(cell: Cell, prog: dict, ref: dict) -> tuple[dict, dict]:
    """The compared numbers of one batch, and what is reported beside
    them: the head gaps by output and dets_missed (the share of the
    reference's top detections that the program's miss; bf16 rounding
    reorders the dense random-weight candidates, so it reads up to ~0.4
    for a sound program and ~0.98 for the control, too close to judge
    by)."""
    gaps = compare.rel_l2(prog["head"], ref["head"], HEAD_KEYS)
    gaps["dets_missed"] = compare.missed_share(
        ref["dets"], prog["results"], cell.traffic["top_compare"], 0.9)
    on_prog = decode.detect({k: [t.float() for t in v]
                             for k, v in prog["head"].items()},
                            test_cfg(cell), ref["sfs"])
    return {
        "canvas_max_abs": compare.max_abs(prog["canvases"],
                                          ref["canvases"]),
        "head_rel_l2": max(gaps[k] for k in HEAD_KEYS),
        "decode_unmatched": compare.unmatched_share(
            on_prog, prog["results"], 0.99, 1e-4),
    }, gaps


def worst(per_batch: list) -> dict:
    return {k: max(n[k] for n in per_batch) for k in per_batch[0]}


def check_indices(cell: Cell) -> list[int]:
    mix = cell.traffic
    rng = np.random.default_rng(cell.seed)
    return sorted(int(i) for i in rng.choice(mix["check_within"],
                                             mix["check_batches"],
                                             replace=False))


def run(cell: Cell) -> dict:
    from orientedreppoints_tpu_torch.serving import Predictor

    mix, device = cell.traffic, cell.device
    phases = measure.Phases(cell)
    sd = draw_weights(cell, device)
    bias = sd[BIAS_KEY].clone()  # the check judges by the same bias
    measure.reset_peak(cell)  # the program's peak, not the calibration's
    phases.mark("weights")
    pred = Predictor(program_cfg(cell), state_dict=sd,
                     batch_size=mix["batch"],
                     compute_dtype=cell.conf["compute_dtype"],
                     test_cfg_overrides=mix.get("test_cfg"), device=device,
                     devices=None)
    del sd
    phases.mark("model")
    warm, pool = traffic.serve_images(mix, cell.seed, device)
    phases.mark("inputs")
    for _ in range(mix["warmup_calls"]):
        pred(warm)
    cap = Capture(pred)
    check = check_indices(cell)
    kept = {}
    measure.sync(device)
    phases.mark("warm-up")
    setup_s = time.perf_counter() - cell.t_start
    state = {"i": 0}

    def call():
        i = state["i"]
        state["i"] += 1
        batch = traffic.serve_batch(mix, pool, i)
        cap.on = i in check
        t = time.perf_counter()
        res = pred(batch)
        lat = time.perf_counter() - t
        if cap.on:
            kept[i] = (batch, res, cap.take())
            cap.on = False
        return lat, len(batch)

    metrics, extra, breakdown = {}, {}, None
    if cell.trace:
        rate = measure.rate(mix["rate_seconds"], lambda: call()[1], device)

        def body():
            n = sum(call()[1] for _ in range(mix["trace_batches"]))
            return n, mix["trace_batches"]
        metrics, extra, breakdown = measure.traced(cell, body, "serve",
                                                   rate)
        attempted = state["i"] * mix["batch"]
    else:
        lats, attempted = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < cell.seconds:
            lat, n = call()
            lats.append(lat)
            attempted += n
        window = time.perf_counter() - t0
        q = 1e3 * np.percentile(lats, [50, 90, 99, 100])
        measure.say(f"window {window:.3f} s, {len(lats)} batches, "
                    f"{attempted} images; p95 over {len(lats)} samples; "
                    "latency ms p50 {:.2f} p90 {:.2f} p99 {:.2f} max {:.2f}"
                    .format(*q))
        values = {"serve_images_per_s": attempted / window,
                  "serve_p95_ms": 1e3 * float(np.percentile(lats, 95)),
                  "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in values.items() if k in units}
    peak = measure.memory_peak(cell)
    device_info = measure.device_info(cell, peak)
    device_info.update(extra)
    del pred, cap, warm, pool
    measure.release()

    ops.f32_no_tf32()
    p = draw_weights(cell, device, bias)
    per_batch, missing = [], 0
    for i in check:
        if i not in kept:  # the window ended first: nothing to judge
            missing += 1
            continue
        batch, res, got = kept.pop(i)
        t = time.perf_counter()
        ref = reference(cell, p, batch, device)
        t_ref = time.perf_counter() - t
        prog = {"canvases": got["canvases"][:len(batch)],
                "head": got["head"], "results": res}
        nums, gaps = numbers(cell, prog, ref)
        measure.say(f"batch {i}: reference {t_ref:.1f} s, judged in "
                    f"{time.perf_counter() - t - t_ref:.1f} s; "
                    + ", ".join(f"{k} {v:.6g}" for k, v in gaps.items()))
        per_batch.append(nums)
        del ref, prog, got
    nums = worst(per_batch) if per_batch else {}
    if missing:
        nums["check_batches_missing"] = missing
    checks = measure.judged(nums, cell.limits)
    return measure.result(measure.all_within(checks), attempted, 0,
                          metrics, device_info, checks, breakdown)

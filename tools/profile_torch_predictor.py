#!/usr/bin/env python
"""Where the PyTorch port's serving time goes, on one NVIDIA GPU.

    python tools/profile_torch_predictor.py [--config CONFIG] \
        [--batches 3] [--trace PATH]

Runs the Predictor of chip_smoke.py (the R-50 demo config unless --config
names another, e.g. configs/dota/orientedreppoints_swin_tiny_demo.py;
canvas 1344^2, bf16, batch 4, perturbed seeded weights, seeded 1024^2
images) and prints:
  * stage times of one batch, each stage ended by a synchronize: prepare
    (host -> device, normalize, canvas), backbone, neck, head, decode;
  * a torch.profiler table of device time by kernel over --batches
    batches, the device-busy sum against the wall time of that window, and
    with --trace a chrome trace of that window.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)


def stage_times(pred, images):
    from orientedreppoints_tpu_torch.models.detector import decode_detections

    tc = pred.test_cfg
    t = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        t[name] = (time.perf_counter() - t0) * 1e3
        return time.perf_counter()

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs, sfs = pred.prepare(images)
        t0 = mark("prepare_ms", t0)
        m = pred.model
        x = imgs.to(m.dtype)
        if m.backbone_type != "swin":
            x = x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
        feats = m.backbone(x)
        t0 = mark("backbone_ms", t0)
        feats = m.neck(feats)
        t0 = mark("neck_ms", t0)
        outs = m.bbox_head(feats)
        t0 = mark("head_ms", t0)
        dets = decode_detections(
            outs, nms_pre=tc["nms_pre"], score_thr=tc["score_thr"],
            iou_thr=tc["nms"]["iou_thr"], max_per_img=tc["max_per_img"],
            pre_nms_cap=tc.get("pre_nms_cap", 4096),
            scale_factor=sfs[:, None, None])
        t0 = mark("decode_ms", t0)
        [d.cpu() for d in dets]
        mark("to_host_ms", t0)
    return t


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config",
                    default="configs/dota/orientedreppoints_r50_demo.py")
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--trace", help="write a chrome trace to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    os.chdir(ROOT)
    import chip_smoke
    from orientedreppoints_tpu_torch.serving import Predictor

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print("card:", card, "config:", args.config)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(chip_smoke.SEED)
    pred = Predictor(args.config,
                     state_dict=chip_smoke.perturbed_weights(rng,
                                                             args.config),
                     batch_size=chip_smoke.BATCH, compute_dtype="bfloat16",
                     device="cuda")
    images = [(rng.random((1024, 1024, 3)) * 255).astype(np.uint8)
              for _ in range(chip_smoke.BATCH)]
    for _ in range(2):
        pred(images)
    for _ in range(3):
        print("stages:", {k: round(v, 3) for k, v in
                          stage_times(pred, images).items()})

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.batches):
            pred(images)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"window: {args.batches} batches, wall {wall * 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / 1e3 / (wall * 1e3):.1f}% of wall)")
    print(events.table(sort_by="self_device_time_total", row_limit=30,
                       max_name_column_width=60))
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Where the PyTorch port's training step spends its time, on one NVIDIA GPU.

    python tools/profile_torch_train.py [--config CONFIG] [--steps 3] \
        [--trace PATH]

Builds chip_smoke.py's training setup (the R-50 demo config unless
--config names another, e.g. configs/dota/orientedreppoints_swin_tiny_
demo.py; canvas 1344^2, bf16, batch 2, the config's SGD or AdamW recipe,
perturbed seeded weights, the seeded batch of 150 rotated gts per image)
and prints:
  * stage times of one step, each stage ended by a synchronize: normalize,
    forward (in train mode, DropPath drawing), compute_losses, backward,
    and the optimizer (clip + the config's SGD or AdamW);
  * a torch.profiler table of device time by kernel over --steps steps, the
    device-busy sum against the wall time of that window, and with --trace
    a chrome trace of that window.
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


def stage_times(model, cfg, batch, seed):
    from orientedreppoints_tpu_torch.apis import (build_img_norm,
                                                  build_loss_config,
                                                  build_trainer)
    from orientedreppoints_tpu_torch.core.loss_head import compute_losses
    from orientedreppoints_tpu_torch.parallel import train

    params = [p for p in model.parameters() if p.requires_grad]
    opt, sched, _ = build_trainer(model, cfg)
    t = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        t[name] = (time.perf_counter() - t0) * 1e3
        return time.perf_counter()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imgs = train.device_normalize(batch["images"], batch["img_hw"],
                                  **build_img_norm(cfg))
    t0 = mark("normalize_ms", t0)
    model.train()
    outs = model(imgs, train.step_generator(seed, 0, imgs.device))
    model.eval()
    t0 = mark("forward_ms", t0)
    losses = compute_losses(outs, batch["gt_polys"], batch["gt_labels"],
                            batch["gt_valid"], batch["img_hw"],
                            build_loss_config(cfg))
    t0 = mark("losses_ms", t0)
    total = sum(v for k, v in losses.items() if k.startswith("loss"))
    opt.zero_grad(set_to_none=False)
    total.backward()
    t0 = mark("backward_ms", t0)
    train.clip_by_global_norm_([p.grad for p in params], 35.0)
    opt.step()
    sched.step()
    mark("optimizer_ms", t0)
    return t


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config",
                    default="configs/dota/orientedreppoints_r50_demo.py")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", help="write a chrome trace to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    os.chdir(ROOT)
    import chip_smoke
    from orientedreppoints_tpu_torch.host import load_config
    from orientedreppoints_tpu_torch.parallel.train import to_device

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print("card:", card, "config:", args.config)
    dev = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED + 1)
    sd = chip_smoke.perturbed_weights(rng, args.config)
    cfg = load_config(args.config)
    batch = to_device(chip_smoke.train_batch(rng, cfg["tpu"]["max_gt"]), dev)
    model, step = chip_smoke.build_trainer(sd, "bfloat16", dev, args.config)
    for _ in range(2):
        step(batch)
    for _ in range(3):
        print("stages:", {k: round(v, 3) for k, v in stage_times(
            model, cfg, batch, chip_smoke.SEED).items()})

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(e.count for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"window: {args.steps} steps, wall {wall * 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / 1e3 / (wall * 1e3):.1f}% of wall), "
          f"{launches} device kernels")
    print(events.table(sort_by="self_device_time_total", row_limit=30,
                       max_name_column_width=60))
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()

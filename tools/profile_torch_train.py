#!/usr/bin/env python
"""Where the PyTorch port's training step spends its time, on one NVIDIA GPU.

    python tools/profile_torch_train.py [--config CONFIG] [--steps 3] \
        [--trace DIR]

Builds chip_smoke.py's training setup (the R-50 demo config unless
--config names another, e.g. configs/dota/orientedreppoints_swin_tiny_
demo.py; canvas 1344^2, bf16, batch 2, the config's SGD or AdamW recipe,
perturbed seeded weights, the seeded batch of 150 rotated gts per image)
and runs --steps steps under utils/profiling.trace, and prints the
device-busy sum against the wall time of that window, the program's
orp.* spans (utils/profiling.SPANS: host and device ms a step, from the
window's key_averages(); the backward's kernels, launched on autograd's
thread, are not under orp.train.backward there, though they fall inside
it in the trace's time, where the benchmark reads them) and a table of
device time by kernel.  The window's
chrome trace goes to --trace DIR/trace.json (default: a temporary
directory, removed).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config",
                    default="configs/dota/orientedreppoints_r50_demo.py")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", metavar="DIR",
                    help="write the window's chrome trace to DIR/trace.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    os.chdir(ROOT)
    import chip_smoke
    from orientedreppoints_tpu_torch.host import load_config
    from orientedreppoints_tpu_torch.parallel.train import to_device
    from orientedreppoints_tpu_torch.utils import profiling

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
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        with profiling.trace(args.trace or tmp) as prof:
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
    print("\n".join(profiling.span_rows(events, args.steps)))
    print(events.table(sort_by="self_device_time_total", row_limit=30,
                       max_name_column_width=60))


if __name__ == "__main__":
    main()

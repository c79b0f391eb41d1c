#!/usr/bin/env python
"""Where the PyTorch port's serving time goes, on one NVIDIA GPU.

    python tools/profile_torch_predictor.py [--config CONFIG] \
        [--batches 3] [--trace DIR]

Runs the Predictor of chip_smoke.py (the R-50 demo config unless --config
names another, e.g. configs/dota/orientedreppoints_swin_tiny_demo.py;
canvas 1344^2, bf16, batch 4, perturbed seeded weights, seeded 1024^2
images) for --batches batches under utils/profiling.trace, and prints the
device-busy sum against the wall time of that window, the program's
orp.* spans (utils/profiling.SPANS: host and device ms a batch, from the
window's key_averages()) and a table of device time by kernel.  The
window's chrome trace goes to --trace DIR/trace.json (default: a
temporary directory, removed).
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
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--trace", metavar="DIR",
                    help="write the window's chrome trace to DIR/trace.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    os.chdir(ROOT)
    import chip_smoke
    from orientedreppoints_tpu_torch.serving import Predictor
    from orientedreppoints_tpu_torch.utils import profiling

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
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        with profiling.trace(args.trace or tmp) as prof:
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
    print("\n".join(profiling.span_rows(events, args.batches)))
    print(events.table(sort_by="self_device_time_total", row_limit=30,
                       max_name_column_width=60))


if __name__ == "__main__":
    main()

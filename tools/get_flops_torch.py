#!/usr/bin/env python
"""Parameters and forward FLOPs of a config's detector (counterpart of
tools/get_flops.py).

    python3 tools/get_flops_torch.py CONFIG [--shape H W] [--device cuda]

The detector is built in float32 with seeded random weights and run once
on a zero (1, H, W, 3) image under torch.utils.flop_counter.FlopCounterMode,
which counts 2 x the multiply-adds of every convolution and matrix product
(the DCN's sampling, a custom op, and elementwise work are not counted; the
JAX tool's XLA cost analysis also counts elementwise work).  Params counts
the model's parameters (FrozenBN's running mean and var are buffers, as
they are batch_stats in the JAX package).
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))


def count(config, shape=(1024, 1024), device="cuda"):
    """-> (params, forward FLOPs, seconds of the counted forward) of the
    config (a path or a dict) on a zero (1, H, W, 3) image."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from orientedreppoints_tpu_torch.apis import init_detector

    model, _ = init_detector(config, compute_dtype="float32", device=device)
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.zeros((1, *shape, 3), dtype=torch.float32,
                    device=next(model.parameters()).device)
    counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with torch.no_grad(), counter:
        model(x)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return n_params, counter.get_total_flops(), time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--shape", type=int, nargs=2, default=[1024, 1024])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    h, w = args.shape
    n_params, flops, _ = count(args.config, (h, w), args.device)
    print(f"Input shape: (1, {h}, {w}, 3)")
    print(f"Params: {n_params / 1e6:.2f} M")
    print(f"Forward FLOPs (torch.utils.flop_counter): {flops / 1e9:.2f} "
          "GFLOPs")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Dry run of the PyTorch port's data-parallel training step on the CPU
(counterpart of __graft_entry__.dryrun_multichip).

    python3 tools/dryrun_ddp_torch.py N

Starts N gloo processes on this host (tools/launch_torch.launch_local: the
ORP_* env contract, tcp://localhost), each one rank of the full training
step (forward, the whole APAA loss, backward, the grads summed over the
group, the global-norm clip, SGD with stem and layer1 frozen) at one
image a rank: R-18, 3 FPN levels, 256^2 canvas, f32, max_gt 32, max_pos
256, 12 rotated gts an image, seeded weights and batch.  Then one process
steps the same global batch of N images from the same weights, and the
run asserts that the group's loss (every rank returns the sum over the
ranks) equals it within 2e-5 relative.  Prints one line and exits 0.
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

IMG = 256
MAX_GT = 32
GTS = 12


def make_step(group):
    """R-18 with 3 levels from seed 0, its SGD recipe and step."""
    from orientedreppoints_tpu_torch.core.loss_head import LossConfig
    from orientedreppoints_tpu_torch.models.detector import \
        OrientedRepPointsDetector
    from orientedreppoints_tpu_torch.parallel import train

    model = OrientedRepPointsDetector(depth=18, num_classes=16, num_levels=3)
    model.init_weights(torch.Generator().manual_seed(0))
    train.freeze(model, train.default_frozen_prefixes(1))
    opt, sched = train.build_optimizer(
        model, train.lr_schedule(iters_per_epoch=100))
    return train.make_train_step(
        model, LossConfig(max_pos=256, strides=(8, 16, 32)), opt, sched,
        group=group)


def make_batch(b: int) -> dict:
    """__graft_entry__.dryrun_multichip's seeded batch of b images."""
    rng = np.random.RandomState(0)
    gt = np.zeros((b, MAX_GT, 8), np.float32)
    lb = np.zeros((b, MAX_GT), np.int32)
    gv = np.zeros((b, MAX_GT), bool)
    for i in range(b):
        for j in range(GTS):
            cx, cy = rng.rand(2) * (IMG - 120) + 60
            w, h = rng.rand(2) * 60 + 12
            a = rng.rand() * np.pi
            c, s = np.cos(a), np.sin(a)
            rot = np.array([[-w / 2, -h / 2], [w / 2, -h / 2],
                            [w / 2, h / 2], [-w / 2, h / 2]])
            gt[i, j] = ((rot @ [[c, s], [-s, c]]) + [cx, cy]).reshape(-1)
            lb[i, j] = rng.randint(1, 16)
            gv[i, j] = True
    return dict(images=rng.rand(b, IMG, IMG, 3).astype(np.float32),
                gt_polys=gt, gt_labels=lb, gt_valid=gv,
                img_hw=np.full((b, 2), IMG, np.int32))


def rank_main() -> int:
    """One rank: its image of the global batch through one step."""
    from orientedreppoints_tpu_torch.parallel import dist

    group = dist.init_from_env("cpu")
    try:
        r, w = dist.rank(group), dist.world_size(group)
        batch = {k: v[r:r + 1] for k, v in make_batch(w).items()}
        losses = make_step(group)(batch)
        print(json.dumps({k: float(v) for k, v in losses.items()}),
              flush=True)
    finally:
        dist.destroy(group)
    loaded = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "flax", "orientedreppoints_tpu")]
    assert not loaded, loaded
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, help="processes (the global batch)")
    p.add_argument("--timeout", type=float, default=1200.0)
    args = p.parse_args(argv)
    from tools.launch_torch import launch_local

    outs = launch_local([sys.executable, osp.abspath(__file__), str(args.n)],
                        args.n, timeout=args.timeout)
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    total = ranks[0]["loss_total"]
    assert all(r == ranks[0] for r in ranks), ranks
    assert np.isfinite(total), ranks[0]
    total_1 = float(make_step(None)(make_batch(args.n))["loss_total"])
    tol = 2e-5 * max(1.0, abs(total_1))
    assert abs(total - total_1) <= tol, (
        f"DDP loss {total} != one-process loss {total_1} (tol {tol})")
    print(f"dryrun_ddp_torch({args.n}): R-18@{IMG} 1 image a rank, "
          f"loss_total={total:.5f} (one process {total_1:.5f}) OK")
    return 0


if __name__ == "__main__":
    sys.exit(rank_main() if os.environ.get("ORP_COORDINATOR_ADDRESS")
             else main())

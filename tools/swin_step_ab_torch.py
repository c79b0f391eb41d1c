#!/usr/bin/env python
"""The Swin-T training step of a checkout, on one NVIDIA GPU, to compare
two checkouts' steps in one call.

    python tools/swin_step_ab_torch.py [--root DIR]

Imports chip_smoke.py and the orientedreppoints_tpu_torch package from DIR
(default: this checkout), builds the kernels and runs the smoke's
`swin_train` phase as chip_smoke.py's main sets it up (Swin-T demo config,
AdamW, DropPath 0.2, 1344^2, bf16, batch 2, the train phase's seeded
batch of 150 gts an image; a warm-up step, then 5 timed steps), printing
its line (step ms, DropPath's masks).  Run it on two checkouts in one
call, A B B A, so that both steps are read on the same card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose chip_smoke.py and package to run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("swin_step_ab_torch: no CUDA device", file=sys.stderr)
        return 2
    root = osp.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    cs = importlib.import_module("chip_smoke")
    from orientedreppoints_tpu_torch import ops as ops_mod
    from orientedreppoints_tpu_torch.host import load_config
    from orientedreppoints_tpu_torch.ops import _ext
    from orientedreppoints_tpu_torch.parallel.train import to_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _ext.lib()
    print(json.dumps(dict(root=root, card=card)))
    torch.manual_seed(cs.SEED)
    # the train phase's batch as main() draws it, and Swin weights from
    # rng_swin's seed (main() draws them after the Swin serving phase)
    rng_train = np.random.default_rng(cs.SEED + 1)
    cs.perturbed_weights(rng_train)
    max_gt = load_config(cs.CONFIG)["tpu"]["max_gt"]
    batch = to_device(cs.train_batch(rng_train, max_gt), dev)
    sd = cs.perturbed_weights(np.random.default_rng(cs.SEED + 4),
                              cs.SWIN_CONFIG)
    ok, _ = cs.phase_train(dev, ops_mod, card, sd, batch, cs.SWIN_CONFIG,
                           "swin_train")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

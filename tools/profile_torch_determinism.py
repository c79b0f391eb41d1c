#!/usr/bin/env python
"""Whether the training step repeats bit for bit, and what its
deterministic settings cost, on one NVIDIA GPU.

    python tools/profile_torch_determinism.py [--steps 3] [--rounds 2]

For the R-50 demo (SGD) and the Swin-T demo (AdamW, DropPath) configs at
chip_smoke.py's train phase set-up (canvas 1344^2, bf16, batch 2, its
seeded batch of 150 gts an image, seeded weights perturbed as the smoke
perturbs them):
  * --steps steps twice from the same weights in fresh objects: whether
    every loss and every tensor of the model is equal bit for bit;
  * the step with its deterministic settings (utils/determinism.py, as
    parallel/train.make_train_step runs it) and without them (the
    settings left as PyTorch's defaults), in turns A B B A repeated
    --rounds times, --steps steps a turn after one warm-up step: each
    step's wall ms, ended by a synchronize.
One JSON line a config, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import os.path as osp
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)


def states_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_determinism: no CUDA device", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    import chip_smoke as smoke
    from orientedreppoints_tpu_torch.host import load_config
    from orientedreppoints_tpu_torch.parallel import train

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(smoke.SEED + 1)
    sd = smoke.perturbed_weights(rng)
    batch = train.to_device(smoke.train_batch(
        rng, load_config(smoke.CONFIG)["tpu"]["max_gt"]), dev)
    configs = (("r50", smoke.CONFIG, sd),
               ("swin_t", smoke.SWIN_CONFIG, smoke.perturbed_weights(
                   np.random.default_rng(smoke.SEED + 4), smoke.SWIN_CONFIG)))
    real = train.deterministic
    for name, config, weights in configs:
        runs = []
        for _ in range(2):
            model, step = smoke.build_trainer(weights, "bfloat16", dev,
                                              config)
            losses = [step(batch) for _ in range(args.steps)]
            runs.append((losses, {k: v.detach().clone()
                                  for k, v in model.state_dict().items()}))
            del model, step
        repeat = (states_equal(runs[0][1], runs[1][1])
                  and all(states_equal(a, b)
                          for a, b in zip(runs[0][0], runs[1][0])))
        del runs
        torch.cuda.empty_cache()
        model, step = smoke.build_trainer(weights, "bfloat16", dev, config)
        step(batch)
        ms = {"with": [], "without": []}
        try:
            for turn in ("with", "without", "without", "with") * args.rounds:
                train.deterministic = (real if turn == "with"
                                       else contextlib.nullcontext)
                for _ in range(args.steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(batch)
                    torch.cuda.synchronize()
                    ms[turn].append((time.perf_counter() - t0) * 1e3)
        finally:
            train.deterministic = real
        del model, step
        torch.cuda.empty_cache()
        print(json.dumps(dict(
            config=config, name=name, steps=args.steps, rounds=args.rounds,
            repeat_bitwise=repeat,
            step_ms_with=ms["with"], step_ms_without=ms["without"],
            median_ms_with=statistics.median(ms["with"]),
            median_ms_without=statistics.median(ms["without"]),
            card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

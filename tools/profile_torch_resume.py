#!/usr/bin/env python
"""How far a resumed epoch lands from an uninterrupted one, on one NVIDIA
GPU, where that noise comes from, and what a faulty resume reads on the
same scale.

    python tools/profile_torch_resume.py [--scenes 8]

chip_smoke.py's synth_train set-up (configs/dota/synth_r18_512.py: R-18,
bf16, batch 8, canvas 512^2; 8 rendered train scenes, 4 steps an epoch):
epochs 1 and 2 uninterrupted (A) with a checkpoint after epoch 1, then
epoch 2 from that checkpoint in fresh objects: twice as it should resume
(B, C), twice so under PyTorch's and cuDNN's deterministic algorithms
(D, E: only the DCN backward's atomics still vary), and once with each
fault:
  momentum: the SGD momentum buffers zeroed after loading;
  lr_step:  the LR schedule one step ahead;
  data:     the loader's shuffles and draws from another seed.
One JSON line for each run against A and for the pairs B-C and D-E:
chip_smoke.param_diffs (the norm of the difference relative to the
epoch's update, its median over tensors, the largest element difference
relative to its tensor's largest element), the largest loss difference of
any step and whether num_pos agrees, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import os.path as osp
import subprocess
import sys
import tempfile

import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)


def zero_momentum(model, loader, opt, sched):
    for g in opt.param_groups:
        for p in g["params"]:
            opt.state[p]["momentum_buffer"].zero_()


def lr_step(model, loader, opt, sched):
    sched.step()


def other_seed(model, loader, opt, sched):
    loader.seed += 1


# run -> (deterministic algorithms, fault applied after loading)
RUNS = {"B": (False, None), "C": (False, None), "D": (True, None),
        "E": (True, None), "momentum": (False, zero_momentum),
        "lr_step": (False, lr_step), "data": (False, other_seed)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_resume: no CUDA device", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    import chip_smoke as smoke
    from orientedreppoints_tpu_torch import apis

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as wd:
        cfg, ds = smoke.synth_train_data(wd, args.scenes)
        model, loader, opt, sched, step = smoke.synth_trainer(cfg, ds, dev)
        losses_a, start = [], {}

        def keep(epoch, losses, stats, batch):
            if epoch == 1:
                losses_a.append({k: float(v) for k, v in losses.items()})

        def epoch_done(reached, it):
            if reached == 1:
                start.update(smoke.model_state(model))

        apis.train_epochs(model, loader, step, opt, sched,
                          osp.join(wd, "ckpts"), 2, on_step=keep,
                          on_epoch=epoch_done)
        state_a = smoke.model_state(model)
        del model, opt, sched, step
        runs = {"A": (losses_a, state_a)}
        for name, (det, fault) in RUNS.items():
            losses = []
            with (smoke.deterministic([]) if det
                  else contextlib.nullcontext()):
                _, _, state = smoke.resumed_epoch(
                    cfg, ds, dev, osp.join(wd, "ckpts", "epoch_1.pt"),
                    osp.join(wd, "ckpts_" + name),
                    on_step=lambda e, lo, s, b: losses.append(
                        {k: float(v) for k, v in lo.items()}),
                    after_load=fault)
            runs[name] = (losses, state)
        for a, b in [("A", r) for r in RUNS] + [("B", "C"), ("D", "E")]:
            (la, sa), (lb, sb) = runs[a], runs[b]
            print(json.dumps(dict(
                runs=[a, b], scenes=args.scenes, tiles=len(ds),
                steps=len(lb),
                num_pos_equal=[x["num_pos"] == y["num_pos"]
                               for x, y in zip(la, lb)],
                max_loss_abs=smoke.loss_diff(la, lb)[0],
                **smoke.param_diffs(sb, sa, start), card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

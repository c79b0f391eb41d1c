#!/usr/bin/env python
"""Stage times of the synthetic benchmark's evaluation path on one NVIDIA
GPU.

    python tools/profile_torch_eval.py [--reps 5] [--root DIR]

chip_smoke.py's phase eval set-up (configs/dota/synth_r18_512.py: R-18,
bf16, batch 4; the 12 val scenes of 768^2 cut into 48 tiles of 512^2; its
seeded weights) and, after one warm-up batch, per repetition: the test
pipeline over every tile on the host (DotaDataset: load, resize,
normalize, pad), then apis.run_inference over every tile (the pipeline
again, batching, the model, decode) ended by a synchronize.  --root DIR
imports the package and chip_smoke.py from another checkout, to compare
two trees in one call.  Prints one JSON line: each repetition's seconds,
the medians, tiles/s, the package's path, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose package is timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_eval: no CUDA device", file=sys.stderr)
        return 2
    root = osp.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as smoke
    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch.data.synth import generate_synth_dota
    from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
    from orientedreppoints_tpu_torch.devkit.img_split import ImgSplit
    from orientedreppoints_tpu_torch.host import load_config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as wd:
        generate_synth_dota(osp.join(wd, "raw"), smoke.EVAL_SCENES,
                            size=smoke.EVAL_SCENE_SIZE,
                            n_objects=smoke.EVAL_OBJECTS,
                            seed=smoke.EVAL_SEED, prefix="V")
        ImgSplit(osp.join(wd, "raw"), osp.join(wd, "split"),
                 gap=smoke.EVAL_GAP, subsize=smoke.EVAL_SUBSIZE, ext=".npy",
                 num_process=1).splitdata()
        cfg = load_config(smoke.EVAL_CONFIG)
        cfg["data"]["test"].update(
            ann_file=dota2coco_train(osp.join(wd, "split"),
                                     osp.join(wd, "test.json"), ext=".npy"),
            img_prefix=osp.join(wd, "split", "images"), test_mode=True)
        ds = apis.build_dataset(cfg["data"]["test"])
        model, _ = apis.init_detector(
            cfg, state_dict=smoke.perturbed_weights(
                np.random.default_rng(smoke.SEED + 5), smoke.EVAL_CONFIG,
                smoke.EVAL_BIAS),
            compute_dtype=cfg["tpu"]["compute_dtype"], device=dev)
        tc = cfg["test_cfg"]
        kw = dict(canvas=tuple(cfg["tpu"]["canvas_buckets"][-1]),
                  batch_size=smoke.EVAL_BATCH, num_fg=len(ds.CLASSES))
        apis.run_inference(model, ds, tc, max_images=smoke.EVAL_BATCH, **kw)
        torch.cuda.synchronize()
        pipeline_s, inference_s = [], []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for i in range(len(ds)):
                ds[i]
            pipeline_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            apis.run_inference(model, ds, tc, **kw)
            torch.cuda.synchronize()
            inference_s.append(time.perf_counter() - t0)
    import orientedreppoints_tpu_torch as pkg

    print(json.dumps(dict(
        package=osp.dirname(pkg.__file__), tiles=len(ds),
        pipeline_s=pipeline_s, inference_s=inference_s,
        pipeline_s_median=statistics.median(pipeline_s),
        inference_s_median=statistics.median(inference_s),
        tiles_per_s_median=len(ds) / statistics.median(inference_s),
        tiles_per_s=[len(ds) / t for t in inference_s], card=card)),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

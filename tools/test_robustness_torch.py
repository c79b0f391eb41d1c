#!/usr/bin/env python
"""Score a detector of the PyTorch port under image corruptions: mPC
(counterpart of tools/test_robustness.py, after mmdetection's
test_robustness.py and robustness_eval.py).

    python3 tools/test_robustness_torch.py CONFIG [--checkpoint FILE_OR_DIR] \\
        [--corruptions gaussian_noise motion_blur ...] [--severities 1 3 5] \\
        [--max_images 100] [--data_root WORK_DIR] [--out robust.json] \\
        [--batch_size 4] [--device cuda]

Each (corruption, severity) setting inserts a Corrupt stage
(data/pipelines.py) at index 1 of the config's val pipeline, right after
the load, builds the dataset and scores the first --max_images tiles with
apis.run_inference + apis.evaluate_results (tile-level mAP); severity 0,
the clean baseline, is scored once.  As in JAX:

  P   = the clean mAP;
  mPC = the mean of every setting's mAP (each rounded to 4 decimals);
  rPC = mPC / P.

The checkpoint is a file or directory of tools/train_torch.py or a state
dict (as tools/test_torch.py takes it); without one the weights are
random (seed 0).  The canvas is the config's last tpu.canvas_buckets
entry.  --data_root points the val split at
<root>/val_split/{test.json,images/}, the layout of
tools/synth_benchmark_torch.py's work dir.  Prints a line per setting and
one JSON line (JAX's keys), which --out also writes.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np  # noqa: E402

from orientedreppoints_tpu_torch.data.corruptions import (  # noqa: E402
    CORRUPTIONS)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Each image's corruption is drawn from a RandomState seeded "
               "by hash(file name), which Python salts per process: run "
               "with a fixed PYTHONHASHSEED (e.g. PYTHONHASHSEED=0) for "
               "scores that repeat from run to run.")
    p.add_argument("config")
    p.add_argument("--checkpoint",
                   help="a port checkpoint (file or directory) or an "
                   "exported state dict")
    p.add_argument("--corruptions", nargs="+", default=list(CORRUPTIONS))
    p.add_argument("--severities", nargs="+", type=int, default=[1, 3, 5],
                   help="severities >= 1; the clean baseline (severity 0) "
                        "is always scored once")
    p.add_argument("--max_images", type=int, default=100)
    p.add_argument("--out", help="path for the JSON artifact")
    p.add_argument("--data_root",
                   help="score <root>/val_split/{test.json,images/} (a "
                        "tools/synth_benchmark_torch.py work dir)")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def eval_setting(model, cfg, corruption: str | None, severity: int,
                 max_images: int, batch_size: int = 4):
    """One setting's tile-level mAP -> (mAP, results, dataset): the val
    dataset (test mode) with Corrupt(corruption, severity) at index 1 of
    its pipeline (none for the clean baseline)."""
    from orientedreppoints_tpu_torch.apis import (build_dataset,
                                                  evaluate_results,
                                                  run_inference)

    pipeline = [dict(s) for s in cfg["data"]["val"]["pipeline"]]
    if corruption is not None and severity > 0:
        pipeline.insert(1, dict(type="Corrupt", corruption=corruption,
                                severity=severity))
    ds = build_dataset({**cfg["data"]["val"], "pipeline": pipeline,
                        "test_mode": True})
    canvas = tuple(cfg.get("tpu", {}).get("canvas_buckets",
                                          [(1344, 1344)])[-1])
    results = run_inference(model, ds, cfg["test_cfg"], canvas=canvas,
                            batch_size=batch_size, max_images=max_images,
                            num_fg=len(ds.CLASSES))
    mAP, _ = evaluate_results(results, ds)
    return float(mAP), results, ds


def summary(P: float, per_setting: dict, max_images: int) -> dict:
    """JAX's artifact: P, mPC (the mean of the rounded settings), rPC."""
    mPC = float(np.mean(list(per_setting.values()))) if per_setting else 0.0
    return {
        "metric": "robustness_mPC",
        "P": round(P, 4),
        "mPC": round(mPC, 4),
        "rPC": round(mPC / P, 4) if P > 0 else 0.0,
        "per_setting": per_setting,
        "max_images": max_images,
    }


def main(argv=None):
    args = parse_args(argv)
    unknown = set(args.corruptions) - set(CORRUPTIONS)
    if unknown:
        raise SystemExit(f"unknown corruptions: {sorted(unknown)}")
    if any(s < 1 for s in args.severities):
        raise SystemExit("severities must be >= 1 (0 is the clean baseline)")
    from orientedreppoints_tpu_torch.apis import init_detector, resolve_device
    from orientedreppoints_tpu_torch.host import load_config
    from orientedreppoints_tpu_torch.utils.checkpoint import load_weights

    cfg = load_config(args.config)
    if args.data_root:
        for split in ("val", "test"):
            if split in cfg["data"]:
                cfg["data"][split]["ann_file"] = osp.join(
                    args.data_root, "val_split", "test.json")
                cfg["data"][split]["img_prefix"] = osp.join(
                    args.data_root, "val_split", "images/")
    model, _ = init_detector(
        cfg, device=resolve_device(args.device),
        compute_dtype=cfg.get("tpu", {}).get("compute_dtype", "bfloat16"))
    if args.checkpoint:
        load_weights(model, args.checkpoint)

    t0 = time.perf_counter()
    P = eval_setting(model, cfg, None, 0, args.max_images,
                     args.batch_size)[0]
    print(f"clean baseline P: mAP {P:.4f}", flush=True)
    per_setting = {}
    for corr in args.corruptions:
        for sev in args.severities:
            m = eval_setting(model, cfg, corr, sev, args.max_images,
                             args.batch_size)[0]
            per_setting[f"{corr}@{sev}"] = round(m, 4)
            print(f"{corr} severity {sev}: mAP {m:.4f}", flush=True)
    out = summary(P, per_setting, args.max_images)
    print(json.dumps(out), flush=True)
    print(f"scored {1 + len(per_setting)} settings in "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Detection quality of the PyTorch port on synthetic DOTA scenes, scored
by the DOTA devkit's own workflow (counterpart of tools/synth_benchmark.py
without training and TTA):

  render val scenes -> ImgSplit tiles -> COCO-poly json -> DotaDataset +
  the config's test pipeline -> run_inference -> Task1 txt ->
  merge_by_poly (cross-tile polygon NMS) -> eval_dota_task1 + eval_maoe.

The val scenes are those of tools/synth_benchmark.py (seed + 10000,
prefix V), written as .npy images.  Prints one JSON line and writes
work_dir/synth_eval.json; exits 1 when mAP <= 0.6, as the JAX tool does.
The work dir defaults to work_dirs/synth_dota_torch under the current
directory.

    python3 tools/synth_benchmark_torch.py [--work_dir DIR] \\
        [--state_dict weights.pt] [--skip_gen] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import torch  # noqa: E402


def parse_args():
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Training is not ported yet: there is no --train. The "
               "weights come from --state_dict, or are random from --seed "
               "(which scores mAP near 0).")
    p.add_argument("--config", default="configs/dota/synth_r18_512.py")
    p.add_argument("--work_dir", default="work_dirs/synth_dota_torch")
    p.add_argument("--val_scenes", type=int, default=12)
    p.add_argument("--scene_size", type=int, default=768)
    p.add_argument("--n_objects", type=int, default=24)
    p.add_argument("--subsize", type=int, default=512)
    p.add_argument("--gap", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--state_dict",
                   help="torch.save'd state dict of the config's model, "
                        "loaded strictly; without it the weights are random "
                        "from --seed")
    p.add_argument("--skip_gen", action="store_true",
                   help="reuse the scenes and tiles already in --work_dir")
    p.add_argument("--device", default="cuda")
    return p.parse_args()


def generate(args):
    """Render the val scenes and cut them into tiles with their json;
    returns the scene names."""
    from orientedreppoints_tpu_torch.data.synth import generate_synth_dota
    from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
    from orientedreppoints_tpu_torch.devkit.img_split import ImgSplit

    wd = args.work_dir
    t0 = time.perf_counter()
    val_names = generate_synth_dota(
        osp.join(wd, "val_raw"), args.val_scenes, size=args.scene_size,
        n_objects=args.n_objects, seed=args.seed + 10_000, prefix="V")
    t1 = time.perf_counter()
    ImgSplit(osp.join(wd, "val_raw"), osp.join(wd, "val_split"),
             gap=args.gap, subsize=args.subsize).splitdata()
    # an annotated json for the val tiles, so that apis.evaluate_results
    # can score them too; the reported numbers come from labelTxt
    dota2coco_train(osp.join(wd, "val_split"),
                    osp.join(wd, "val_split", "test.json"))
    print(f"generated {len(val_names)} scenes in {t1 - t0:.1f}s, split in "
          f"{time.perf_counter() - t1:.1f}s", flush=True)
    return val_names


def evaluate(args, cfg, model, val_names):
    """Infer the val tiles, merge them into scenes and score them ->
    (mAP, {class: ap}, mAOE, {class: aoe}, mAOE_mod90, {class: aoe})."""
    from orientedreppoints_tpu_torch.apis import build_dataset, run_inference
    from orientedreppoints_tpu_torch.data.synth import SYNTH_CLASS_SPECS
    from orientedreppoints_tpu_torch.devkit.dota_utils import DOTA10_CLASSES
    from orientedreppoints_tpu_torch.devkit.evaluation import (
        eval_dota_task1, eval_maoe)
    from orientedreppoints_tpu_torch.devkit.result_merge import (
        merge_by_poly, write_task1_results)

    wd = args.work_dir
    canvas = tuple(cfg.get("tpu", {}).get("canvas_buckets",
                                          [(512, 512)])[-1])
    val_ds = build_dataset({**cfg["data"]["test"], "test_mode": True})
    print(f"inference over {len(val_ds)} val tiles ...", flush=True)
    t0 = time.perf_counter()
    results = run_inference(model, val_ds, cfg["test_cfg"], canvas=canvas,
                            num_fg=len(val_ds.CLASSES))
    print(f"inference done in {time.perf_counter() - t0:.1f}s", flush=True)

    raw = osp.join(wd, "task1_raw")
    merged = osp.join(wd, "task1_merged")
    write_task1_results(results, DOTA10_CLASSES, raw)
    merge_by_poly(raw, merged)
    detpath = osp.join(merged, "Task1_{:s}.txt")
    annopath = osp.join(wd, "val_raw", "labelTxt", "{:s}.txt")
    classnames = list(SYNTH_CLASS_SPECS)
    mAP, aps = eval_dota_task1(detpath, annopath, val_names,
                               classnames=classnames, use_07_metric=False)
    # ovthresh 0.7: the reference's mAOE main(); mod90 folds the
    # convention's near-square 90-degree flips out
    return (mAP, aps) + eval_maoe(detpath, annopath, val_names,
                                  classnames=classnames, ovthresh=0.7,
                                  return_mod90=True)


def main():
    args = parse_args()
    os.makedirs(args.work_dir, exist_ok=True)

    from orientedreppoints_tpu_torch.apis import init_detector
    from orientedreppoints_tpu_torch.host import load_config

    cfg = load_config(args.config)
    for split in ("val", "test"):
        cfg["data"][split]["ann_file"] = osp.join(
            args.work_dir, "val_split", "test.json")
        cfg["data"][split]["img_prefix"] = osp.join(
            args.work_dir, "val_split", "images/")

    if args.skip_gen:
        val_names = sorted(
            osp.splitext(f)[0]
            for f in os.listdir(osp.join(args.work_dir, "val_raw", "images")))
    else:
        val_names = generate(args)

    sd = (torch.load(args.state_dict, map_location="cpu", weights_only=True)
          if args.state_dict else None)
    model, _ = init_detector(
        cfg, state_dict=sd, device=args.device, seed=args.seed,
        compute_dtype=cfg.get("tpu", {}).get("compute_dtype", "bfloat16"))
    mAP, aps, mAOE, aoes, mAOE_mod90, aoes_mod90 = evaluate(args, cfg, model,
                                                            val_names)
    out = {
        "metric": "synth_dota_mAP",
        "mAP": round(mAP, 4),
        "mAOE_deg": round(mAOE, 2),
        "per_class_ap": {k: round(v, 4) for k, v in aps.items()},
        "per_class_aoe": {k: round(v, 2) for k, v in aoes.items()},
        "mAOE_mod90_deg": round(mAOE_mod90, 2),
        "per_class_aoe_mod90": {k: round(v, 2) for k, v in aoes_mod90.items()},
        "weights": args.state_dict or f"random, seed {args.seed}",
        "device": (torch.cuda.get_device_name(0)
                   if torch.device(args.device).type == "cuda" else "cpu"),
    }
    print(json.dumps(out), flush=True)
    with open(osp.join(args.work_dir, "synth_eval.json"), "w") as f:
        json.dump(out, f, indent=2)
    return 0 if mAP > 0.6 else 1


if __name__ == "__main__":
    sys.exit(main())

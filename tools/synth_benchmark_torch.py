#!/usr/bin/env python
"""Detection quality of the PyTorch port on synthetic DOTA scenes, trained
and scored by the DOTA devkit's own workflow (counterpart of
tools/synth_benchmark.py without TTA):

  render scenes -> ImgSplit tiles -> COCO-poly json -> [--train: the
  config's train pipeline, loader and SGD or AdamW step, a checkpoint every
  --ckpt_interval epochs] -> DotaDataset + the test pipeline ->
  run_inference -> Task1 txt -> merge_by_poly (cross-tile polygon NMS) ->
  eval_dota_task1 + eval_maoe.

The scenes are those of tools/synth_benchmark.py: train seed --seed,
prefix T; val seed --seed + 10000, prefix V; written as .npy images.
Prints one JSON line and writes work_dir/synth_eval.json; exits 1 when
mAP <= 0.6, as the JAX tool does.  The work dir defaults to
work_dirs/synth_dota_torch under the current directory.

    python3 tools/synth_benchmark_torch.py --train [--epochs N] \\
        [--stop_epoch N] [--resume --skip_gen] [--device cuda]
    python3 tools/synth_benchmark_torch.py [--state_dict weights.pt]
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Without --train the weights come from --state_dict, or are "
               "random from --seed (which scores mAP near 0).  With --train "
               "a run that stops before the last epoch (--stop_epoch) saves "
               "a checkpoint and exits 3; run again with --resume --skip_gen "
               "to go on.  Not ported: TTA scoring (--flip_tta, --ms_tta), "
               "the --hard and --hrsc scenes, and the host-RSS re-exec "
               "(--rss_limit_gb, ROADMAP Queue 1 item 9).")
    p.add_argument("--config", default="configs/dota/synth_r18_512.py")
    p.add_argument("--work_dir", default="work_dirs/synth_dota_torch")
    p.add_argument("--train", action="store_true",
                   help="render the train scenes and train the config's "
                        "model before scoring it")
    p.add_argument("--train_scenes", type=int, default=40)
    p.add_argument("--val_scenes", type=int, default=12)
    p.add_argument("--scene_size", type=int, default=768)
    p.add_argument("--n_objects", type=int, default=24)
    p.add_argument("--subsize", type=int, default=512)
    p.add_argument("--gap", type=int, default=256)
    p.add_argument("--seed", type=int, default=0,
                   help="scenes, initial weights, the loader's draws and the "
                   "DropPath masks")
    p.add_argument("--epochs", type=int, help="override total_epochs")
    p.add_argument("--max_steps", type=int,
                   help="stop training after this many steps in all")
    p.add_argument("--resume", action="store_true",
                   help="resume training from work_dir/ckpts")
    p.add_argument("--ckpt_interval", type=int, default=10,
                   help="checkpoint every N epochs (and at the end)")
    p.add_argument("--stop_epoch", type=int, default=0,
                   help="train at most up to this epoch in this process, "
                        "checkpoint and exit 3 without scoring")
    p.add_argument("--log_interval", type=int, default=50)
    p.add_argument("--state_dict",
                   help="torch.save'd state dict of the config's model, "
                        "loaded strictly (without --train)")
    p.add_argument("--skip_gen", action="store_true",
                   help="reuse the scenes and tiles already in --work_dir")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def compute_dtype(cfg) -> str:
    return cfg.get("tpu", {}).get("compute_dtype", "bfloat16")


def generate(args):
    """Render the (train and) val scenes and cut them into tiles with their
    jsons; returns the val scene names."""
    from orientedreppoints_tpu_torch.data.synth import generate_synth_dota
    from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
    from orientedreppoints_tpu_torch.devkit.img_split import ImgSplit

    wd = args.work_dir
    t0 = time.perf_counter()
    splits = [("val", args.val_scenes, args.seed + 10_000, "V", "test.json")]
    if args.train:
        splits.insert(0, ("train", args.train_scenes, args.seed, "T",
                          "train.json"))
    for split, n, seed, prefix, json_name in splits:
        names = generate_synth_dota(
            osp.join(wd, f"{split}_raw"), n, size=args.scene_size,
            n_objects=args.n_objects, seed=seed, prefix=prefix)
        ImgSplit(osp.join(wd, f"{split}_raw"), osp.join(wd, f"{split}_split"),
                 gap=args.gap, subsize=args.subsize).splitdata()
        # annotated jsons for both: the val one lets apis.evaluate_results
        # score the tiles too; the reported numbers come from labelTxt
        dota2coco_train(osp.join(wd, f"{split}_split"),
                        osp.join(wd, f"{split}_split", json_name))
    print(f"generated and split {[s[0] for s in splits]} scenes in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return names


def train(args, cfg, device):
    """Train the config's model on the train tiles -> (model, summary)."""
    from orientedreppoints_tpu_torch.apis import (build_dataloader,
                                                  build_dataset,
                                                  build_img_norm,
                                                  build_trainer,
                                                  init_detector,
                                                  train_epochs)
    from orientedreppoints_tpu_torch.utils import checkpoint

    model, _ = init_detector(cfg, device=device, seed=args.seed,
                             compute_dtype=compute_dtype(cfg))
    dataset = build_dataset(cfg["data"]["train"],
                            device_normalize=build_img_norm(cfg) is not None)
    loader = build_dataloader(dataset, cfg, seed=args.seed)
    iters_per_epoch = max(len(loader), 1)
    total_epochs = args.epochs or cfg["total_epochs"]
    optimizer, scheduler, step = build_trainer(model, cfg, iters_per_epoch,
                                               seed=args.seed)
    ckpt_dir = osp.join(args.work_dir, "ckpts")
    with open(args.config) as f:
        meta = dict(config=f.read(), classes=list(dataset.CLASSES))
    start_epoch, it = 0, 0
    if args.resume:
        it, saved = checkpoint.load_checkpoint(ckpt_dir, model, optimizer,
                                               scheduler)
        start_epoch = saved["epoch"]
        print(f"resumed at epoch {start_epoch}, step {it}", flush=True)
    end_epoch = (min(args.stop_epoch, total_epochs) if args.stop_epoch
                 else total_epochs)
    print(f"train: {len(dataset)} tiles, {iters_per_epoch} iters/epoch, "
          f"epochs {start_epoch}..{end_epoch} of {total_epochs}", flush=True)
    run = train_epochs(model, loader, step, optimizer, scheduler, ckpt_dir,
                       end_epoch, start_epoch=start_epoch, it=it,
                       max_iters=args.max_steps,
                       ckpt_interval=args.ckpt_interval, meta=meta,
                       log=lambda line: print(line, flush=True),
                       log_interval=args.log_interval)
    ms = np.asarray(run["step_s"]) * 1e3
    waits, wall = run["wait_s"], run["wall_s"]
    summary = dict(
        epochs=[start_epoch, run["epoch"]], steps=len(ms), wall_s=wall,
        step_ms_median=float(np.median(ms)) if len(ms) else None,
        step_ms_p10_p90=([float(np.percentile(ms, 10)),
                          float(np.percentile(ms, 90))] if len(ms) else None),
        loader_wait_ms_median=(float(np.median(waits)) * 1e3 if waits
                               else None),
        loader_wait_share=sum(waits) / wall if wall > 0 else None)
    print(f"training done: {json.dumps(summary)}", flush=True)
    if end_epoch < total_epochs:
        print("chunk complete; run again with --resume --skip_gen to go on",
              flush=True)
        sys.exit(3)
    return model, summary


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


def main(argv=None):
    args = parse_args(argv)
    if args.train and args.state_dict:
        raise SystemExit("--state_dict and --train exclude each other")
    from orientedreppoints_tpu_torch.apis import init_detector, resolve_device
    from orientedreppoints_tpu_torch.host import load_config

    device = resolve_device(args.device)
    os.makedirs(args.work_dir, exist_ok=True)
    cfg = load_config(args.config)
    for split, folder, name in (("train", "train_split", "train.json"),
                                ("val", "val_split", "test.json"),
                                ("test", "val_split", "test.json")):
        cfg["data"][split]["ann_file"] = osp.join(args.work_dir, folder, name)
        cfg["data"][split]["img_prefix"] = osp.join(args.work_dir, folder,
                                                    "images/")

    t0 = time.perf_counter()
    if args.skip_gen:
        val_names = sorted(
            osp.splitext(f)[0]
            for f in os.listdir(osp.join(args.work_dir, "val_raw", "images")))
    else:
        val_names = generate(args)

    summary = None
    if args.train:
        model, summary = train(args, cfg, device)
        weights = f"trained here, epochs {summary['epochs']}"
    else:
        sd = (torch.load(args.state_dict, map_location="cpu",
                         weights_only=True) if args.state_dict else None)
        model, _ = init_detector(cfg, state_dict=sd, device=device,
                                 seed=args.seed,
                                 compute_dtype=compute_dtype(cfg))
        weights = args.state_dict or f"random, seed {args.seed}"
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
        "weights": weights,
        "train": summary,
        "wall_s": time.perf_counter() - t0,
        "device": (torch.cuda.get_device_name(0) if device.type == "cuda"
                   else "cpu"),
    }
    print(json.dumps(out), flush=True)
    with open(osp.join(args.work_dir, "synth_eval.json"), "w") as f:
        json.dump(out, f, indent=2)
    return 0 if mAP > 0.6 else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Detection quality of the PyTorch port on synthetic DOTA scenes, trained
and scored by the DOTA devkit's own workflow (counterpart of
tools/synth_benchmark.py):

  render scenes -> ImgSplit tiles -> COCO-poly json -> [--train: the
  config's train pipeline (the *_hard_aug configs: mosaic x mixup, HSV
  and rotation), loader and SGD or AdamW step, a checkpoint every
  --ckpt_interval epochs] -> DotaDataset + the test pipeline ->
  run_inference -> Task1 txt -> merge_by_poly (cross-tile polygon NMS) ->
  eval_dota_task1 + eval_maoe [--hrsc: + eval_hrsc2016] [--flip_tta /
  --ms_tta: the same again through run_inference_tta, into *_tta folders].

The scenes are those of tools/synth_benchmark.py: train seed --seed,
prefix T; val seed --seed + 10000, prefix V; written as .npy images (the
port's tiles; the PNG route of real DOTA input is devkit/prepare.py);
--hard: the 15-class benchmark with clutter, --hrsc: ship-only scenes.
Prints one JSON line with the JAX tool's keys and writes
work_dir/synth_eval.json; exits 1 when mAP <= 0.6, as the JAX tool does.
The work dir defaults to work_dirs/synth_dota_torch under the current
directory.

    python3 tools/synth_benchmark_torch.py --train [--epochs N] \\
        [--stop_epoch N] [--resume --skip_gen] [--device cuda]
    python3 tools/synth_benchmark_torch.py [--state_dict weights.pt]
    python3 tools/synth_benchmark_torch.py --skip_train --skip_gen
    python3 tools/synth_benchmark_torch.py \\
        --config configs/dota/synth_r18_512_hard.py --hard --train \\
        --flip_tta --ms_tta 0.5,1.0,1.5
    python3 tools/synth_benchmark_torch.py \\
        --config configs/dota/synth_r50_512_hard_aug.py --hard --train \\
        --flip_tta --ms_tta 0.5,1.0,1.5
    python3 tools/synth_benchmark_torch.py --hrsc --train
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
               "to go on.  With --train, --rss_limit_gb re-executes the "
               "process with --resume --skip_gen at an epoch boundary "
               "where its host RSS has passed the limit (after saving "
               "the epoch), so a long run stays one command.  "
               "--skip_train scores the latest checkpoint of "
               "work_dir/ckpts without training.")
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
    p.add_argument("--hard", action="store_true",
                   help="the 15-class confusable benchmark (clutter, noise, "
                        "dense packing, a brightness ramp) instead of the "
                        "easy 6-class one")
    p.add_argument("--hrsc", action="store_true",
                   help="ship-only scenes; also scores the merged "
                        "detections with the HRSC2016 evaluator "
                        "(devkit/hrsc.py eval_hrsc2016, VOC-07)")
    p.add_argument("--flip_tta", action="store_true",
                   help="also score a flip-TTA pass of the same weights "
                        "(apis.run_inference_tta) and report the delta")
    p.add_argument("--ms_tta",
                   help="comma-separated relative scales of a multi-scale "
                        "(x flip with --flip_tta) TTA pass, e.g. "
                        "'0.5,1.0,1.5'")
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
    p.add_argument("--skip_train", action="store_true",
                   help="score the latest checkpoint of work_dir/ckpts "
                        "instead of training")
    p.add_argument("--rss_limit_gb", type=float, default=60.0,
                   help="at an epoch boundary with the host RSS past this "
                        "many GB, save the epoch and re-exec with --resume "
                        "--skip_gen (utils/chunked.py); <= 0 disables")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def compute_dtype(cfg) -> str:
    return cfg.get("tpu", {}).get("compute_dtype", "bfloat16")


def generate(args):
    """Render the (train and) val scenes and cut them into tiles with their
    jsons; returns the val scene names."""
    from orientedreppoints_tpu_torch.data.synth import (SYNTH_CLASS_SPECS,
                                                        generate_synth_dota)
    from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
    from orientedreppoints_tpu_torch.devkit.img_split import ImgSplit

    wd = args.work_dir
    t0 = time.perf_counter()
    # ship-only scenes: the easy (or hard) scenes' draws with one class
    specs = {"ship": SYNTH_CLASS_SPECS["ship"]} if args.hrsc else None
    splits = [("val", args.val_scenes, args.seed + 10_000, "V", "test.json")]
    if args.train:
        splits.insert(0, ("train", args.train_scenes, args.seed, "T",
                          "train.json"))
    for split, n, seed, prefix, json_name in splits:
        names = generate_synth_dota(
            osp.join(wd, f"{split}_raw"), n, size=args.scene_size,
            n_objects=args.n_objects, seed=seed, prefix=prefix,
            hard=args.hard, specs=specs)
        ImgSplit(osp.join(wd, f"{split}_raw"), osp.join(wd, f"{split}_split"),
                 gap=args.gap, subsize=args.subsize, ext=".npy",
                 num_process=1).splitdata()
        # annotated jsons for both: the val one lets apis.evaluate_results
        # score the tiles too; the reported numbers come from labelTxt
        dota2coco_train(osp.join(wd, f"{split}_split"),
                        osp.join(wd, f"{split}_split", json_name),
                        ext=".npy")
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
    from orientedreppoints_tpu_torch import ops
    from orientedreppoints_tpu_torch.ops import _ext
    from orientedreppoints_tpu_torch.utils import checkpoint, chunked

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

    def log(line):
        print(f"{line} (rss {chunked.current_rss_gb():.1f}G)", flush=True)

    def epoch_done(reached, it):
        if reached >= end_epoch or (args.max_steps and it >= args.max_steps):
            return

        def save():  # train_epochs saves only every ckpt_interval epochs
            if reached % args.ckpt_interval:
                checkpoint.save_checkpoint(ckpt_dir, reached, model,
                                           optimizer, scheduler, it, meta)

        chunked.maybe_reexec(
            args.rss_limit_gb, save,
            lambda argv: chunked.argv_with_flags(
                argv, ensure=["--resume", "--skip_gen"]))

    run = train_epochs(model, loader, step, optimizer, scheduler, ckpt_dir,
                       end_epoch, start_epoch=start_epoch, it=it,
                       max_iters=args.max_steps,
                       ckpt_interval=args.ckpt_interval, meta=meta, log=log,
                       log_interval=args.log_interval, on_epoch=epoch_done)
    ms = np.asarray(run["step_s"]) * 1e3
    waits, wall = run["wait_s"], run["wall_s"]
    summary = dict(
        epochs=[start_epoch, run["epoch"]], steps=len(ms), wall_s=wall,
        step_ms_median=float(np.median(ms)) if len(ms) else None,
        step_ms_p10_p90=([float(np.percentile(ms, 10)),
                          float(np.percentile(ms, 90))] if len(ms) else None),
        loader_wait_ms_median=(float(np.median(waits)) * 1e3 if waits
                               else None),
        loader_wait_share=sum(waits) / wall if wall > 0 else None,
        # 0 when a re-executed process found the kernels built
        kernel_build_s=_ext.build_seconds, launches=ops.launch_counts())
    print(f"training done: {json.dumps(summary)}", flush=True)
    if end_epoch < total_epochs:
        print("chunk complete; run again with --resume --skip_gen to go on",
              flush=True)
        sys.exit(3)
    return model, summary


def class_names(args) -> list:
    """The classes scored: ship (--hrsc), the 15 hard ones or the 6 easy
    ones."""
    from orientedreppoints_tpu_torch.data.synth import (
        SYNTH_CLASS_SPECS, SYNTH_HARD_CLASS_SPECS)

    if args.hrsc:
        return ["ship"]
    return list(SYNTH_HARD_CLASS_SPECS if args.hard else SYNTH_CLASS_SPECS)


def evaluate(args, cfg, model, val_names, tta_augs=None, suffix=""):
    """Infer the val tiles (through run_inference_tta with tta_augs), merge
    them into scenes and score them -> (mAP, {class: ap}, mAOE,
    {class: aoe}, extra: mAOE_mod90_deg, per_class_aoe_mod90 and, with
    --hrsc, hrsc_ap07)."""
    from orientedreppoints_tpu_torch.apis import (build_dataset,
                                                  infer_devices,
                                                  run_inference,
                                                  run_inference_tta)
    from orientedreppoints_tpu_torch.devkit.dota_utils import DOTA10_CLASSES
    from orientedreppoints_tpu_torch.parallel.infer import round_up_batch
    from orientedreppoints_tpu_torch.devkit.evaluation import (
        eval_dota_task1, eval_maoe)
    from orientedreppoints_tpu_torch.devkit.hrsc import eval_hrsc2016
    from orientedreppoints_tpu_torch.devkit.result_merge import (
        merge_by_poly, write_task1_results)

    wd = args.work_dir
    canvas = tuple(cfg.get("tpu", {}).get("canvas_buckets",
                                          [(512, 512)])[-1])
    val_ds = build_dataset({**cfg["data"]["test"], "test_mode": True})
    devices = infer_devices("all", next(model.parameters()).device)
    print(f"inference over {len(val_ds)} val tiles (tta={tta_augs}) on "
          f"{len(devices) if devices else 1} device(s), batch "
          f"{round_up_batch(2 if tta_augs else 4, devices)} ...", flush=True)
    t0 = time.perf_counter()
    if tta_augs is not None:
        results = run_inference_tta(model, val_ds, cfg["test_cfg"], tta_augs,
                                    canvas=canvas,
                                    num_fg=len(val_ds.CLASSES))
    else:
        results = run_inference(model, val_ds, cfg["test_cfg"],
                                canvas=canvas, num_fg=len(val_ds.CLASSES))
    print(f"inference done in {time.perf_counter() - t0:.1f}s", flush=True)

    raw = osp.join(wd, "task1_raw" + suffix)
    merged = osp.join(wd, "task1_merged" + suffix)
    write_task1_results(results, DOTA10_CLASSES, raw)
    merge_by_poly(raw, merged, num_process=1)
    detpath = osp.join(merged, "Task1_{:s}.txt")
    annopath = osp.join(wd, "val_raw", "labelTxt", "{:s}.txt")
    classnames = class_names(args)
    mAP, aps = eval_dota_task1(detpath, annopath, val_names,
                               classnames=classnames, use_07_metric=False)
    # ovthresh 0.7: the reference's mAOE main(); mod90 folds the
    # convention's near-square 90-degree flips out
    mAOE, aoes, mAOE_mod90, aoes_mod90 = eval_maoe(
        detpath, annopath, val_names, classnames=classnames, ovthresh=0.7,
        return_mod90=True)
    extra = {}
    if args.hrsc:
        # the same merged detections through the HRSC2016 evaluator
        extra["hrsc_ap07"] = round(float(eval_hrsc2016(
            detpath, annopath, val_names, use_07_metric=True)), 4)
    extra["mAOE_mod90_deg"] = round(mAOE_mod90, 2)
    extra["per_class_aoe_mod90"] = {k: round(v, 2)
                                    for k, v in aoes_mod90.items()}
    return mAP, aps, mAOE, aoes, extra


def main(argv=None):
    args = parse_args(argv)
    if args.train and args.state_dict:
        raise SystemExit("--state_dict and --train exclude each other")
    if args.skip_train and (args.train or args.state_dict):
        raise SystemExit("--skip_train scores the work dir's checkpoint: "
                         "not with --train or --state_dict")
    from orientedreppoints_tpu_torch.apis import (init_detector,
                                                  parse_tta_spec,
                                                  resolve_device)
    from orientedreppoints_tpu_torch.host import load_config
    from orientedreppoints_tpu_torch.utils import checkpoint

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
    elif args.skip_train:
        ckpt = checkpoint.latest_checkpoint(osp.join(args.work_dir, "ckpts"))
        if ckpt is None:
            raise SystemExit(f"--skip_train: no checkpoint in "
                             f"{osp.join(args.work_dir, 'ckpts')}")
        model, _ = init_detector(cfg, device=device, seed=args.seed,
                                 compute_dtype=compute_dtype(cfg))
        epoch = checkpoint.load_eval_variables(ckpt, model)["epoch"]
        weights = f"{ckpt}, epoch {epoch}"
    else:
        sd = (torch.load(args.state_dict, map_location="cpu",
                         weights_only=True) if args.state_dict else None)
        model, _ = init_detector(cfg, state_dict=sd, device=device,
                                 seed=args.seed,
                                 compute_dtype=compute_dtype(cfg))
        weights = args.state_dict or f"random, seed {args.seed}"
    mAP, aps, mAOE, aoes, extra = evaluate(args, cfg, model, val_names)
    out = {
        "metric": ("synth_hrsc_mAP" if args.hrsc
                   else "synth_dota_hard_mAP" if args.hard
                   else "synth_dota_mAP"),
        "mAP": round(mAP, 4),
        "mAOE_deg": round(mAOE, 2),
        "per_class_ap": {k: round(v, 4) for k, v in aps.items()},
        "per_class_aoe": {k: round(v, 2) for k, v in aoes.items()},
        **extra,
    }
    tta_augs = parse_tta_spec(args.ms_tta, args.flip_tta)
    if tta_augs is not None:
        # the same weights through the TTA path, scored the same way
        mAP_t, aps_t, mAOE_t, _, extra_t = evaluate(
            args, cfg, model, val_names, tta_augs=tta_augs, suffix="_tta")
        out["tta"] = {
            "augs": [list(a) for a in tta_augs],
            "mAP": round(mAP_t, 4),
            "mAOE_deg": round(mAOE_t, 2),
            "per_class_ap": {k: round(v, 4) for k, v in aps_t.items()},
            "mAOE_mod90_deg": extra_t["mAOE_mod90_deg"],
        }
        if args.hrsc:
            out["tta"]["hrsc_ap07"] = extra_t["hrsc_ap07"]
        out["tta_mAP_delta"] = round(mAP_t - mAP, 4)
    out.update(
        weights=weights, train=summary, wall_s=time.perf_counter() - t0,
        device=(torch.cuda.get_device_name(0) if device.type == "cuda"
                else "cpu"))
    print(json.dumps(out), flush=True)
    with open(osp.join(args.work_dir, "synth_eval.json"), "w") as f:
        json.dump(out, f, indent=2)
    return 0 if mAP > 0.6 else 1


if __name__ == "__main__":
    sys.exit(main())

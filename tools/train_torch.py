#!/usr/bin/env python
"""Train an oriented detector with the PyTorch port on one device, or
data-parallel with one process a card (counterpart of tools/train.py).

    python3 tools/train_torch.py CONFIG [--work_dir DIR] [--seed 0] \\
        [--resume_from DIR_OR_FILE | --load_from FILE] [--total_epochs N] \\
        [--max_iters N] [--validate [--val_max_images N]] \\
        [--pretrained_backbone resnet50.pth] [--device cuda]

The config's train data (DotaDataset over the tiles of
devkit/prepare.py, PNG, BMP or .npy read through data/image_io; the train
pipeline, whose mosaic and mixup take their extra tiles from the
dataset; the loader of its `tpu` section), its SGD or AdamW recipe and LR
schedule (epochs counted in the loader's batches), and a checkpoint
work_dir/ckpts/epoch_N.pt after every epoch.  --resume_from restores the
model, optimizer, scheduler and step and goes on from the saved epoch;
--load_from takes only the weights.  --pretrained_backbone overwrites a
ResNet / ResNeXt backbone from a torchvision .pth before training
(utils/checkpoint.load_pretrained_backbone).  --validate scores the val split
after every epoch (apis.run_inference + apis.evaluate_results).  Logs go
to stdout and work_dir/train.log.  --rss_limit_gb (default 60): at an
epoch boundary with epochs left and the host's resident set past the
limit, the process re-executes itself with --resume_from work_dir/ckpts
(utils/chunked.py), so a run whose host memory grows stays one command.

Data-parallel: with ORP_COORDINATOR_ADDRESS set (tools/dist_train_torch.sh
and tools/slurm_train_torch.sh set it, with ORP_NUM_PROCESSES,
ORP_PROCESS_ID and ORP_LOCAL_RANK), each process joins the group
(parallel/dist.py: NCCL on the cards, gloo with --device cpu), takes the card cuda:{ORP_LOCAL_RANK} and its share
of every global batch (the config's tpu.global_batch_size), and the step
is the one-process step of that global batch.  Rank 0 alone logs, writes
the checkpoints and runs --validate on its own card; every rank resumes
from the same file.  A group does not re-execute: --rss_limit_gb is off there,
and refused when given.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np  # noqa: E402

RSS_LIMIT_GB = 60.0  # tools/train.py's default


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--work_dir")
    p.add_argument("--resume_from",
                   help="a checkpoint file, or a directory: its latest")
    p.add_argument("--load_from", help="a checkpoint file: weights only")
    p.add_argument("--pretrained_backbone",
                   help="a torchvision ResNet / ResNeXt .pth for the "
                   "backbone, of the config's depth")
    p.add_argument("--seed", type=int, default=0,
                   help="initial weights, the loader's draws and the "
                   "DropPath masks")
    p.add_argument("--total_epochs", type=int)
    p.add_argument("--max_iters", type=int,
                   help="stop after this many iterations in all")
    p.add_argument("--log_interval", type=int, default=50)
    p.add_argument("--validate", action="store_true",
                   help="score the val split after every epoch")
    p.add_argument("--val_max_images", type=int, default=500)
    p.add_argument("--rss_limit_gb", type=float,
                   help="at an epoch boundary with the host RSS past this "
                   "many GB, checkpoint and re-exec with --resume_from "
                   f"(default {RSS_LIMIT_GB:g}; <= 0 disables; off, and "
                   "refused, in a data-parallel group)")
    p.add_argument("--device", default="cuda",
                   help="cuda, cuda:N or cpu; a data-parallel process "
                   "takes cuda:{ORP_LOCAL_RANK}")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from orientedreppoints_tpu_torch.apis import (build_dataloader,
                                                  build_dataset,
                                                  build_img_norm,
                                                  build_trainer,
                                                  evaluate_results,
                                                  init_detector,
                                                  resolve_device,
                                                  run_inference,
                                                  train_epochs)
    from orientedreppoints_tpu_torch.host import load_config
    from orientedreppoints_tpu_torch.parallel import dist
    from orientedreppoints_tpu_torch.utils import checkpoint, chunked

    device = resolve_device(args.device)
    if device.type == "cuda" and os.environ.get("ORP_COORDINATOR_ADDRESS"):
        device = resolve_device(f"cuda:{dist.local_rank()}")
    group = dist.init_from_env(device)
    rank = dist.rank(group)
    rss_limit_gb = RSS_LIMIT_GB if args.rss_limit_gb is None \
        else args.rss_limit_gb
    if group is not None:
        # one rank re-executing alone would leave the others waiting
        if args.rss_limit_gb is not None and args.rss_limit_gb > 0:
            dist.destroy(group)
            raise SystemExit("--rss_limit_gb re-executes one process: a "
                             "data-parallel group cannot use it")
        rss_limit_gb = 0.0
    cfg = load_config(args.config)
    work_dir = args.work_dir or cfg.get("work_dir", "work_dirs/default")
    os.makedirs(work_dir, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO if rank == 0 else logging.WARNING,
        format="%(asctime)s %(levelname)s %(message)s",
        handlers=[logging.StreamHandler(sys.stdout)] + (
            [logging.FileHandler(osp.join(work_dir, "train.log"))]
            if rank == 0 else []),
        force=True)
    log = logging.getLogger("train")
    if group is not None:
        log.info("data-parallel: %d processes, %s backend",
                 dist.world_size(group), "nccl" if device.type == "cuda"
                 else "gloo")

    tpu = cfg.get("tpu", {})
    model, _ = init_detector(cfg, device=device, seed=args.seed,
                             compute_dtype=tpu.get("compute_dtype",
                                                   "bfloat16"))
    if args.pretrained_backbone:
        checkpoint.load_pretrained_backbone(
            model, args.pretrained_backbone,
            cfg["model"]["backbone"].get("depth", 50))
        log.info("loaded pretrained backbone from %s",
                 args.pretrained_backbone)
    dataset = build_dataset(cfg["data"]["train"],
                            device_normalize=build_img_norm(cfg) is not None)
    loader = build_dataloader(dataset, cfg, seed=args.seed, group=group)
    iters_per_epoch = max(len(loader), 1)
    total_epochs = args.total_epochs or cfg["total_epochs"]
    log.info("dataset: %d imgs, %d iters/epoch, device %s", len(dataset),
             iters_per_epoch, device)
    optimizer, scheduler, step = build_trainer(model, cfg, iters_per_epoch,
                                               seed=args.seed, group=group)
    if args.load_from:
        checkpoint.load_eval_variables(args.load_from, model)
        log.info("loaded weights from %s", args.load_from)
    start_epoch, it = 0, 0
    if args.resume_from:
        it, meta = checkpoint.load_checkpoint(args.resume_from, model,
                                              optimizer, scheduler)
        start_epoch = meta["epoch"]
        log.info("resumed from %s at epoch %d, iter %d", args.resume_from,
                 start_epoch, it)
    with open(args.config) as f:
        meta = dict(config=f.read(), classes=list(dataset.CLASSES))
    canvas = tuple(tpu.get("canvas_buckets", [(1344, 1344)])[-1])
    ckpt_dir = osp.join(work_dir, "ckpts")

    def epoch_done(reached, it):
        log.info("epoch %d done at iter %d", reached - 1, it)
        if args.validate:
            validate(reached)
        if reached < total_epochs and not (args.max_iters
                                           and it >= args.max_iters):
            # the epoch's checkpoint is saved: nothing more to save
            chunked.maybe_reexec(
                rss_limit_gb, lambda: None,
                lambda argv: chunked.argv_with_flags(
                    argv, ensure_kv={"--resume_from": ckpt_dir}),
                log=log.info)

    def validate(reached):
        if rank == 0:  # on its own card: the others are the ranks'
            val_ds = build_dataset({**cfg["data"]["val"], "test_mode": True})
            results = run_inference(
                model, val_ds, cfg["test_cfg"], canvas=canvas,
                max_images=args.val_max_images, num_fg=len(val_ds.CLASSES),
                devices="all" if group is None else None)
            mAP, aps = evaluate_results(results, val_ds)
            log.info("epoch %d val mAP %.4f %s", reached - 1, mAP,
                     json.dumps({k: round(v, 3) for k, v in aps.items()
                                 if not np.isnan(v)}))
        dist.barrier(group)

    try:
        it = train_epochs(model, loader, step, optimizer, scheduler,
                          ckpt_dir, total_epochs,
                          start_epoch=start_epoch, it=it,
                          max_iters=args.max_iters, meta=meta, log=log.info,
                          log_interval=args.log_interval,
                          on_epoch=epoch_done, group=group)["it"]
    finally:
        dist.destroy(group)
    log.info("training finished at iter %d", it)
    return 0


if __name__ == "__main__":
    sys.exit(main())

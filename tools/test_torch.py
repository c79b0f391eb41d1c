#!/usr/bin/env python
"""Run the PyTorch port's detector over a config's test split and write
DOTA-format results (counterpart of tools/test.py).

    python3 tools/test_torch.py CONFIG [--checkpoint FILE_OR_DIR] \\
        [--out results.npz] [--format_task1 DIR [--merge_dir DIR]] \\
        [--eval] [--flip_tta] [--ms_tta 0.5,1.0,1.5] [--batch_size 4] \\
        [--max_images N] [--device cuda]

The config's data.test (test_mode: every tile, labelled or not) through
its test pipeline, on the canvas of its last `tpu.canvas_buckets` entry,
in the config's compute dtype: apis.run_inference, or with --flip_tta /
--ms_tta apis.run_inference_tta.  --checkpoint takes a checkpoint of
tools/train_torch.py (a file, or a directory: its latest) or a state dict
written by tools/export_torch_state_dict.py; without it the weights are
random (seed 0).  --out writes the per-class arrays as a .npz with keys
'name|class', --format_task1 one Task1 file per class, --merge_dir those
merged across tiles (devkit/result_merge.merge_by_poly), --eval the
tile-level mAP against the dataset's annotations.  On a host with two
cards or more every batch is sharded over all of them, as tools/test.py
does over its mesh, its size rounded up to a multiple of their count
(tools/dist_test_torch.sh; parallel/infer.py).
"""

from __future__ import annotations

import argparse
import logging
import os.path as osp
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--checkpoint",
                   help="a port checkpoint (file or directory) or an "
                   "exported state dict")
    p.add_argument("--out", help="output .npz path for raw results")
    p.add_argument("--format_task1", help="dir for per-class Task1 txts")
    p.add_argument("--merge_dir", help="dir for cross-tile merged txts")
    p.add_argument("--max_images", type=int)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--eval", action="store_true",
                   help="tile-level oriented mAP vs dataset annotations")
    p.add_argument("--flip_tta", action="store_true",
                   help="horizontal-flip TTA with merged rnms")
    p.add_argument("--ms_tta",
                   help="comma-separated relative test scales, e.g. "
                   "'0.5,1.0,1.5'; with --flip_tta every scale is flipped "
                   "too")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_weights(model, path: str) -> None:
    """A checkpoint of tools/train_torch.py (file or directory) or a bare
    state dict into model, strictly (utils/checkpoint.load_weights)."""
    from orientedreppoints_tpu_torch.utils import checkpoint

    checkpoint.load_weights(model, path)


def log_sharding(apis, model, batch_size: int, log) -> None:
    """Say over how many cards a batch shards and the batch it rounds
    to (run_inference's default devices)."""
    from orientedreppoints_tpu_torch.parallel.infer import round_up_batch

    devices = apis.infer_devices("all", next(model.parameters()).device)
    if devices is not None:
        log.info("data-parallel inference over %d devices", len(devices))
        bs = round_up_batch(batch_size, devices)
        if bs != batch_size:
            log.info("batch_size %d -> %d (multiple of %d devices)",
                     batch_size, bs, len(devices))


def infer(args, log):
    """The model and dataset of args.config -> (results, dataset,
    seconds of the inference pass, whose results reached the host)."""
    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch.host import load_config

    cfg = load_config(args.config)
    tpu = cfg.get("tpu", {})
    model, _ = apis.init_detector(
        cfg, compute_dtype=tpu.get("compute_dtype", "bfloat16"),
        device=apis.resolve_device(args.device))
    if args.checkpoint:
        load_weights(model, args.checkpoint)
        log.info("loaded weights from %s", args.checkpoint)
    dataset = apis.build_dataset({**cfg["data"]["test"], "test_mode": True})
    canvas = tuple(tpu.get("canvas_buckets", [(1344, 1344)])[-1])
    log_sharding(apis, model, args.batch_size, log)
    kw = dict(canvas=canvas, batch_size=args.batch_size,
              max_images=args.max_images, num_fg=len(dataset.CLASSES))
    tta_augs = apis.parse_tta_spec(args.ms_tta, args.flip_tta)
    t0 = time.perf_counter()
    if tta_augs is None:
        results = apis.run_inference(model, dataset, cfg["test_cfg"], **kw)
    else:
        log.info("TTA augs: %s", tta_augs)
        results = apis.run_inference_tta(model, dataset, cfg["test_cfg"],
                                         tta_augs, **kw)
    dt = time.perf_counter() - t0
    log.info("%d imgs in %.1fs (%.2f img/s)", len(results), dt,
             len(results) / max(dt, 1e-9))
    return results, dataset, dt


def emit_outputs(args, results, dataset, log):
    """--out, --eval, --format_task1 and --merge_dir."""
    from orientedreppoints_tpu_torch.apis import evaluate_results
    from orientedreppoints_tpu_torch.devkit.result_merge import (
        merge_by_poly, write_task1_results)

    if args.out:
        np.savez_compressed(args.out, **{
            f"{k}|{ci}": arr for k, per in results.items()
            for ci, arr in enumerate(per)})
        log.info("wrote %s", args.out)
    if args.eval:
        mAP, aps = evaluate_results(results, dataset)
        log.info("tile-level mAP %.4f", mAP)
        for k, v in aps.items():
            if not np.isnan(v):
                log.info("  %s: %.4f", k, v)
    if args.format_task1:
        write_task1_results(results, dataset.CLASSES, args.format_task1)
        log.info("wrote Task1 txts to %s", args.format_task1)
        if args.merge_dir:
            merge_by_poly(args.format_task1, args.merge_dir)
            log.info("merged cross-tile results to %s", args.merge_dir)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    log = logging.getLogger("test")
    results, dataset, _ = infer(args, log)
    emit_outputs(args, results, dataset, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())

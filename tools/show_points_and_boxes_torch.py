#!/usr/bin/env python
"""Draw the learned RepPoints and the decoded oriented boxes of the port's
detector on a config's images (counterpart of
tools/show_points_and_boxes.py), without cv2.

    python3 tools/show_points_and_boxes_torch.py CONFIG \\
        [--checkpoint FILE_OR_DIR] [--split test] \\
        [--output-dir work_dirs/show_points] [--num 10] [--score-thr 0.3] \\
        [--device cuda]

The first --num images of data[split] (test_mode) one at a time on the
canvas of the config's last tpu.canvas_buckets entry, in the config's
compute dtype (tpu.compute_dtype, bfloat16 by default), through the model
and decode_detections(..., with_reppoints=True) with the config's
test_cfg.  For each detection scoring at least --score-thr, in its
class's palette colour: the min-area-rect polygon (thickness 2) and the 9
points as filled circles of radius 2, both cv2's bit for bit, and the
score label (inside cv2's text box, in the port's own glyphs;
utils/visualize.draw_dets).
Each image is written as <file name>.png through data/image_io.
--checkpoint takes a checkpoint of tools/train_torch.py (a file or a
directory), or a state dict (tools/publish_model_torch.py's .pth,
tools/export_torch_state_dict.py's file); without it the weights are
random (seed 0).  The model runs on the card unless --device says
otherwise.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np  # noqa: E402

def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--checkpoint")
    p.add_argument("--split", default="test")
    p.add_argument("--output-dir", default="work_dirs/show_points")
    p.add_argument("--num", type=int, default=10)
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch.data import image_io
    from orientedreppoints_tpu_torch.host import load_config
    from orientedreppoints_tpu_torch.models.detector import decode_detections
    from orientedreppoints_tpu_torch.utils.checkpoint import load_weights
    from orientedreppoints_tpu_torch.utils.visualize import (draw_dets,
                                                             undo_normalize)

    cfg = load_config(args.config)
    tpu = cfg.get("tpu", {})
    model, _ = apis.init_detector(
        cfg, compute_dtype=tpu.get("compute_dtype", "bfloat16"),
        device=apis.resolve_device(args.device))
    if args.checkpoint:
        load_weights(model, args.checkpoint)
    dev = next(model.parameters()).device
    ds = apis.build_dataset({**cfg["data"][args.split], "test_mode": True})
    canvas = tuple(tpu.get("canvas_buckets", [(1344, 1344)])[-1])
    tc = cfg["test_cfg"]
    os.makedirs(args.output_dir, exist_ok=True)
    for i in range(min(args.num, len(ds))):
        s = ds[i]
        img = np.asarray(s["img"])
        cimg = np.zeros(canvas + (3,), np.float32)
        cimg[:img.shape[0], :img.shape[1]] = img
        with torch.inference_mode():
            outs = model(torch.from_numpy(cimg[None]).to(dev))
            dets, labels, valid = (t.cpu().numpy() for t in decode_detections(
                outs, nms_pre=tc["nms_pre"], score_thr=tc["score_thr"],
                iou_thr=tc["nms"]["iou_thr"], max_per_img=tc["max_per_img"],
                with_reppoints=True))
        vis = undo_normalize(img, cfg["img_norm_cfg"])
        draw_dets(vis, dets[0], labels[0], valid[0], args.score_thr)
        out = osp.join(args.output_dir,
                       osp.splitext(s["img_info"]["file_name"])[0] + ".png")
        image_io.imwrite(out, vis)
        print("wrote", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

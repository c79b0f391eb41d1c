#!/usr/bin/env python
"""Write a config's pipeline output as images with their gt polygons drawn
(counterpart of tools/browse_dataset.py), without cv2.

    python3 tools/browse_dataset_torch.py CONFIG [--split train] \\
        [--output-dir work_dirs/browse] [--num 10] [--seed 0]

Each sample of data[split] through apis.build_dataset's pipeline, a
train pipeline's draws taken from one np.random.RandomState(seed) (the
JAX tool draws from np.random: seeded alike, the same samples); samples a
step drops are skipped.  Normalize is undone as the JAX tool undoes it,
each gt polygon drawn in green at thickness 2 (cv2's bit for bit) with its
label in red (inside cv2's text box, in the port's own glyphs;
utils/visualize.draw_gts), and the image written as NNNNN.png (its index
in the dataset) through data/image_io.  Runs on the host only.
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
    p.add_argument("--split", default="train")
    p.add_argument("--output-dir", default="work_dirs/browse")
    p.add_argument("--num", type=int, default=10)
    p.add_argument("--seed", type=int, default=0,
                   help="the train pipeline's draws")
    args = p.parse_args(argv)

    from orientedreppoints_tpu_torch import apis
    from orientedreppoints_tpu_torch.data import image_io
    from orientedreppoints_tpu_torch.host import load_config
    from orientedreppoints_tpu_torch.utils.visualize import (draw_gts,
                                                             undo_normalize)

    cfg = load_config(args.config)
    ds = apis.build_dataset(cfg["data"][args.split])
    rng = np.random.RandomState(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    n = 0
    for i in range(len(ds)):
        if n >= args.num:
            break
        s = ds.prepare(i, rng)
        if s is None:
            continue
        img = undo_normalize(np.asarray(s["img"]), cfg["img_norm_cfg"])
        draw_gts(img, s.get("gt_bboxes", []), s.get("gt_labels", []))
        image_io.imwrite(osp.join(args.output_dir, f"{i:05d}.png"), img)
        n += 1
    print(f"wrote {n} images to {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

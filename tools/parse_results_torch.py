#!/usr/bin/env python
"""Convert the raw results of tools/test_torch.py --out (a .npz with keys
'<img>|<class_idx>') into per-class DOTA Task1 txts, and optionally merge
them across tiles (counterpart of tools/parse_results.py).

    python3 tools/parse_results_torch.py RESULTS.npz OUT_DIR \\
        [--merge_dir DIR] [--classes plane ship ...]
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np  # noqa: E402

from orientedreppoints_tpu_torch.devkit.dota_utils import (  # noqa: E402
    DOTA10_CLASSES)
from orientedreppoints_tpu_torch.devkit.result_merge import (  # noqa: E402
    merge_by_poly, write_task1_results)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("npz", help="results .npz (keys '<img>|<class_idx>')")
    p.add_argument("out_dir", help="dir for per-class Task1 txts")
    p.add_argument("--merge_dir", help="optional cross-tile merged output")
    p.add_argument("--classes", nargs="+", default=list(DOTA10_CLASSES))
    args = p.parse_args(argv)

    nc = len(args.classes)
    results: dict[str, list] = {}
    with np.load(args.npz) as data:
        for key in data.files:
            img, ci = key.rsplit("|", 1)
            results.setdefault(img, [np.zeros((0, 9))] * nc)[int(ci)] = \
                data[key]
    write_task1_results(results, args.classes, args.out_dir)
    print(f"wrote Task1 txts for {len(results)} tiles to {args.out_dir}")
    if args.merge_dir:
        merge_by_poly(args.out_dir, args.merge_dir)
        print("merged to", args.merge_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())

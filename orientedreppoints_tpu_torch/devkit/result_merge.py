"""Per-tile detections back to whole scenes, with cross-tile polygon NMS
(counterpart of devkit/result_merge.py, after
DOTA_devkit/ResultMerge_multi_process.py):

  * per-class Task1_<cls>.txt lines 'tilename score x0 y0 ... x3 y3';
  * tile names 'name__rate__left___up' (:182-203), polygons mapped back
    as (x + left) / rate (:173-180);
  * per scene, greedy polygon NMS at 0.1 (py_cpu_nms_poly_fast :60-121);
  * the class files merged in parallel (:225-231): merge_by_poly maps
    merge_single over them in a pool of `num_process` spawned workers
    (a fork of a process that has started CUDA is unsafe), the largest
    file first.  The workers import numpy and this package's devkit, not
    torch; spawn re-imports the caller's __main__ in each of them, so a
    caller that imports torch at module level pays that import a worker.
    The polygon IoUs go through devkit/native.py's host library, built
    (if need be) in the caller before the pool starts.
"""

from __future__ import annotations

import multiprocessing
import os
import os.path as osp
from functools import partial

import numpy as np

from . import dota_utils as util
from . import native
from .polygon import poly_nms

NMS_THRESH = 0.1


def merge_single(dstpath: str, nms_thresh: float, fullname: str):
    """Merge one per-class Task1 file of tile detections into dstpath."""
    name = util.basename_noext(fullname)
    dstname = osp.join(dstpath, name + ".txt")
    nameboxdict: dict[str, list] = {}
    with open(fullname) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 10:
                continue
            oriname, rate, left, up = util.parse_tile_name(parts[0])
            score = float(parts[1])
            poly = np.array([float(v) for v in parts[2:10]], np.float64)
            orig = np.empty(9, np.float64)
            orig[0:8:2] = (poly[0::2] + left) / rate
            orig[1:8:2] = (poly[1::2] + up) / rate
            orig[8] = score
            nameboxdict.setdefault(oriname, []).append(orig)
    with open(dstname, "w") as f:
        for imgname, dets in nameboxdict.items():
            dets = np.stack(dets)
            for i in poly_nms(dets, nms_thresh):
                d = dets[i]
                coords = " ".join(str(v) for v in d[:8])
                f.write(f"{imgname} {d[8]} {coords}\n")


def merge_by_poly(srcpath: str, dstpath: str, nms_thresh: float = NMS_THRESH,
                  num_process: int = 16):
    """Merge every per-class file under srcpath into dstpath: in this
    process with one worker or fewer, else in a spawn pool of
    min(num_process, files) workers.  The files are the same either way."""
    os.makedirs(dstpath, exist_ok=True)
    native.lib()  # built once here, loaded by each worker
    files = util.list_files(srcpath, ".txt")
    workers = min(num_process, len(files) or 1)
    if workers <= 1:
        for fn in files:
            merge_single(dstpath, nms_thresh, fn)
        return
    # the largest first: the pool's time is that of its longest worker
    files.sort(key=osp.getsize, reverse=True)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        pool.map(partial(merge_single, dstpath, nms_thresh), files,
                 chunksize=1)


def write_task1_results(results_per_image, class_names, out_dir: str):
    """Per-class Task1 files from {image name: [per-class (k, 9 or 27)
    arrays]} (rbbox2result's layout: the poly and score are the last 9
    columns).  Values print as the arrays hold them: float32 from
    rbbox2result."""
    os.makedirs(out_dir, exist_ok=True)
    handles = {c: open(osp.join(out_dir, f"Task1_{c}.txt"), "w")
               for c in class_names}
    try:
        for img_name, per_class in results_per_image.items():
            for ci, dets in enumerate(per_class):
                dets = np.asarray(dets)
                if dets.size == 0:
                    continue
                for d in dets.reshape(len(dets), -1):
                    poly, score = d[-9:-1], d[-1]
                    coords = " ".join(f"{v}" for v in poly)
                    handles[class_names[ci]].write(
                        f"{img_name} {score} {coords}\n")
    finally:
        for h in handles.values():
            h.close()

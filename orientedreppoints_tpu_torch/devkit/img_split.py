"""Tile large DOTA scenes into fixed-size patches (counterpart of
devkit/img_split.py, after DOTA_devkit/ImgSplit_multi_process.py):

  * a sliding window of subsize with stride subsize - gap, the last
    window snapped to the image edge (SplitSingle :226-268);
  * gt polygons clipped to each tile: kept verbatim (floored) when fully
    inside; else the clip, a 5-gon reduced by merging its shortest edge
    (GetPoly4FromPoly5 :134-158), larger polygons dropped, vertices
    re-ordered to best fit the original (:19-37), coordinates floored and
    clamped to [1, subsize];
  * a clipped instance keeping inter / area <= thresh (0.7) becomes
    difficult '2' (savepatches :160-225);
  * a scene resized by `rate` first (the multi-scale prep's 0.5 / 1.5):
    cv2's uint8 INTER_CUBIC, host.resize_cubic_uint8, with the polygons
    scaled by the rate;
  * tiles 'name__rate__left___up', zero-padded to subsize (padding);
  * SplitOnlyImage: the test split's images alone.

Images are read and written by data/image_io (PNG by default, ext; BMP
and .npy too).  num_process > 1 splits the scenes in a spawn pool whose
workers import only the port, each with one torch thread; the files are
those of one process.
"""

from __future__ import annotations

import multiprocessing
import os
import os.path as osp
from functools import partial

import numpy as np
import torch

from ..data import image_io
from ..host import resize_cubic_uint8
from . import dota_utils as util
from .polygon import clip_polygon, orient_ccw, polygon_area


def reduce_poly5_to_poly4(poly: np.ndarray) -> np.ndarray:
    """Merge the end points of a 5-gon's shortest edge into their midpoint,
    keeping the traversal order from vertex 0 (GetPoly4FromPoly5)."""
    p = np.asarray(poly, np.float64).reshape(5, 2)
    edges = np.linalg.norm(np.roll(p, -1, axis=0) - p, axis=1)
    s = int(np.argmin(edges))
    merged = (p[s] + p[(s + 1) % 5]) / 2.0
    out = []
    for i in range(5):
        if i == s:
            out.append(merged)
        elif i != (s + 1) % 5:
            out.append(p[i])
    return np.asarray(out).reshape(4, 2)


def best_point_order(poly: np.ndarray, ref_poly: np.ndarray) -> np.ndarray:
    """The cyclic shift of poly nearest ref_poly (summed squared distance)."""
    p = np.asarray(poly, np.float64).reshape(4, 2)
    r = np.asarray(ref_poly, np.float64).reshape(4, 2)
    shifts = [np.roll(p, -k, axis=0) for k in range(4)]
    d = [float(np.sum((s - r) ** 2)) for s in shifts]
    return shifts[int(np.argmin(d))]


class ImgSplit:
    """Split basepath/{images,labelTxt} into outpath/{images,labelTxt}
    (images only with images_only)."""

    def __init__(self, basepath: str, outpath: str, gap: int = 512,
                 subsize: int = 1024, thresh: float = 0.7,
                 choosebestpoint: bool = True, ext: str = ".png",
                 padding: bool = True, num_process: int = 8,
                 images_only: bool = False):
        self.basepath = basepath
        self.outpath = outpath
        self.gap = gap
        self.subsize = subsize
        self.slide = subsize - gap
        self.thresh = thresh
        self.choosebestpoint = choosebestpoint
        self.ext = ext
        self.padding = padding
        self.num_process = num_process
        self.images_only = images_only
        self.imagepath = osp.join(basepath, "images")
        self.labelpath = osp.join(basepath, "labelTxt")
        self.outimagepath = osp.join(outpath, "images")
        self.outlabelpath = osp.join(outpath, "labelTxt")
        os.makedirs(self.outimagepath, exist_ok=True)
        if not images_only:
            os.makedirs(self.outlabelpath, exist_ok=True)

    def _clip_objects(self, objects, left, up, right, down):
        """Clip gt polygons to the tile window -> tile-frame objects."""
        out = []
        for obj in objects:
            poly = np.asarray(obj["poly"], np.float64).reshape(4, 2)
            area = polygon_area(poly)
            if area <= 0:
                continue
            inter = clip_polygon(orient_ccw(poly), (left, up, right, down))
            half_iou = polygon_area(inter) / area
            if half_iou <= 0:
                continue
            if half_iou >= 1.0 - 1e-9:
                tile_poly = np.floor(poly - [left, up])  # the int cast
                out.append(dict(poly=tile_poly.reshape(-1), name=obj["name"],
                                difficult=obj["difficult"]))
                continue
            if len(inter) < 4:
                continue
            if len(inter) == 5:
                inter = reduce_poly5_to_poly4(inter)
            elif len(inter) > 5:
                continue  # the reference drops >5-gons
            if self.choosebestpoint:
                inter = best_point_order(inter, poly)
            tile_poly = np.clip(np.floor(inter - [left, up]), 1, self.subsize)
            difficult = obj["difficult"] if half_iou > self.thresh else "2"
            out.append(dict(poly=tile_poly.reshape(-1), name=obj["name"],
                            difficult=difficult))
        return out

    def split_single(self, name: str, rate: float = 1.0):
        """Cut one scene (images/<name><ext>, labelTxt/<name>.txt) resized
        by rate; a missing image is skipped (cv2.imread's None), an
        unreadable one raises."""
        path = osp.join(self.imagepath, name + self.ext)
        if not osp.exists(path):
            return
        img = image_io.imread(path)
        objects = []
        if not self.images_only:
            objects = util.parse_dota_poly(osp.join(self.labelpath,
                                                    name + ".txt"))
            for o in objects:
                o["poly"] = np.asarray(o["poly"], np.float64) * rate
        if rate != 1.0:
            img = resize_cubic_uint8(img, rate)
        h, w = img.shape[:2]
        base = f"{name}__{rate}__"
        left = 0
        while left < w:
            if left + self.subsize >= w:
                left = max(w - self.subsize, 0)
            up = 0
            while up < h:
                if up + self.subsize >= h:
                    up = max(h - self.subsize, 0)
                right = min(left + self.subsize, w - 1)
                down = min(up + self.subsize, h - 1)
                self._save_patch(img, objects, f"{base}{left}___{up}", left,
                                 up, right, down)
                if up + self.subsize >= h:
                    break
                up += self.slide
            if left + self.subsize >= w:
                break
            left += self.slide

    def _save_patch(self, img, objects, subname, left, up, right, down):
        if not self.images_only:
            tile_objs = self._clip_objects(objects, left, up, right, down)
            util.write_dota_poly(osp.join(self.outlabelpath,
                                          subname + ".txt"), tile_objs)
        sub = img[up:up + self.subsize, left:left + self.subsize]
        if self.padding:
            canvas = np.zeros((self.subsize, self.subsize, 3),
                              dtype=img.dtype)
            canvas[:sub.shape[0], :sub.shape[1]] = sub
            sub = canvas
        image_io.imwrite(osp.join(self.outimagepath, subname + self.ext),
                         sub)

    def splitdata(self, rate: float = 1.0):
        """Split every scene under basepath/images at rate."""
        names = [util.basename_noext(p)
                 for p in util.list_files(self.imagepath, self.ext)
                 if util.basename_noext(p) != "Thumbs"]
        workers = min(self.num_process, len(names))
        if workers <= 1:
            for n in names:
                self.split_single(n, rate)
            return
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers, initializer=torch.set_num_threads,
                      initargs=(1,)) as pool:
            pool.map(partial(_split_worker, self, rate), names)


def _split_worker(split: ImgSplit, rate: float, name: str):
    split.split_single(name, rate)


class SplitOnlyImage(ImgSplit):
    """Image-only tiling of the test split
    (SplitOnlyImage_multi_process.py)."""

    def __init__(self, basepath: str, outpath: str, **kw):
        kw["images_only"] = True
        super().__init__(basepath, outpath, **kw)

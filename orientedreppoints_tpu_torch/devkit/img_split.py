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
  * tiles 'name__rate__left___up', zero-padded to subsize.

Images are .npy arrays (BGR uint8) in and out.  Only rate 1.0 is ported:
other rates resize the scene with cv2's bicubic uint8 resize first.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

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
    """Split basepath/{images,labelTxt} into outpath/{images,labelTxt}, one
    scene after another in this process."""

    def __init__(self, basepath: str, outpath: str, gap: int = 512,
                 subsize: int = 1024, thresh: float = 0.7):
        self.basepath = basepath
        self.outpath = outpath
        self.gap = gap
        self.subsize = subsize
        self.slide = subsize - gap
        self.thresh = thresh
        self.ext = ".npy"
        self.imagepath = osp.join(basepath, "images")
        self.labelpath = osp.join(basepath, "labelTxt")
        self.outimagepath = osp.join(outpath, "images")
        self.outlabelpath = osp.join(outpath, "labelTxt")
        os.makedirs(self.outimagepath, exist_ok=True)
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
            inter = best_point_order(inter, poly)
            tile_poly = np.clip(np.floor(inter - [left, up]), 1, self.subsize)
            difficult = obj["difficult"] if half_iou > self.thresh else "2"
            out.append(dict(poly=tile_poly.reshape(-1), name=obj["name"],
                            difficult=difficult))
        return out

    def split_single(self, name: str, rate: float = 1.0):
        """Cut one scene (images/<name>.npy, labelTxt/<name>.txt)."""
        if rate != 1.0:
            raise NotImplementedError(
                f"ImgSplit at rate {rate}: only rate 1.0 is ported (other "
                "rates resize the scene with cv2's bicubic first)")
        path = osp.join(self.imagepath, name + self.ext)
        if not osp.exists(path):
            return
        img = np.load(path)
        objects = util.parse_dota_poly(osp.join(self.labelpath,
                                                name + ".txt"))
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
        tile_objs = self._clip_objects(objects, left, up, right, down)
        util.write_dota_poly(osp.join(self.outlabelpath, subname + ".txt"),
                             tile_objs)
        sub = img[up:up + self.subsize, left:left + self.subsize]
        canvas = np.zeros((self.subsize, self.subsize, 3), dtype=img.dtype)
        canvas[:sub.shape[0], :sub.shape[1]] = sub
        np.save(osp.join(self.outimagepath, subname + self.ext), canvas)

    def splitdata(self, rate: float = 1.0):
        """Split every scene under basepath/images."""
        for p in util.list_files(self.imagepath, self.ext):
            if util.basename_noext(p) != "Thumbs":
                self.split_single(util.basename_noext(p), rate)

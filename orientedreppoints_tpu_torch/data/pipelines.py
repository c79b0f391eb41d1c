"""The train and test pipelines on a results dict (counterpart of
data/pipelines.py's LoadImageFromFile, LoadAnnotations, CorrectBox,
RotateResize, RotateRandomFlip, Normalize, Pad, FilterEmpty and
build_pipeline, after mmdet/datasets/pipelines/{loading,transforms}.py),
in numpy on the host.

Images are .npy arrays (BGR uint8).  RotateResize resizes through
host.imrescale / host.resize_uint8, cv2's uint8 INTER_LINEAR in the
port's own arithmetic; CorrectBox snaps each gt to cv2's minAreaRect
corners through data/rect.py.

Random draws: the JAX transforms draw from the global np.random.  Here
the pipeline is called as pipeline(results, rng) with an explicit
np.random.RandomState (the loader's, seeded per epoch), and each step
makes the same RandomState calls in the same order (RotateResize's scale,
then RotateRandomFlip's rand() and choice()), so equal seeds give equal
samples.  A step that must draw raises without an rng.
"""

from __future__ import annotations

import os.path as osp
from typing import Sequence

import numpy as np
import torch

from .. import host
from . import rect

PIPELINES = {}


def register(cls):
    PIPELINES[cls.__name__] = cls
    return cls


def build_pipeline(cfgs: Sequence[dict]):
    """A callable (results, rng=None) -> results from mmdet-style
    {'type': ...} dicts; a step that returns None ends the pipeline with
    None.  Steps with ``draws`` set are handed the rng."""
    steps = []
    for cfg in cfgs:
        cfg = dict(cfg)
        t = cfg.pop("type")
        if t not in PIPELINES:
            raise NotImplementedError(f"pipeline step {t} is not ported")
        steps.append(PIPELINES[t](**cfg))

    def run(results, rng: np.random.RandomState | None = None):
        for s in steps:
            results = (s(results, rng) if getattr(s, "draws", False)
                       else s(results))
            if results is None:
                return None
        return results

    return run


def _need(rng, step: str):
    if rng is None:
        raise ValueError(f"{step} draws at random: call the pipeline with "
                         "an np.random.RandomState")
    return rng


@register
class LoadImageFromFile:
    """Load img_prefix/file_name, a .npy BGR image, as mmcv.imread would
    give it; start the list of box fields."""

    def __call__(self, results):
        path = osp.join(results.get("img_prefix", ""),
                        results["img_info"]["file_name"])
        if not path.endswith(".npy"):
            raise ValueError(f"{path}: the port reads images as .npy "
                             "arrays (BGR uint8) only")
        if not osp.exists(path):
            raise FileNotFoundError(path)
        img = np.load(path)
        results["filename"] = path
        results["img"] = img
        results["img_shape"] = img.shape
        results["ori_shape"] = img.shape
        results["bbox_fields"] = []
        return results


@register
class LoadAnnotations:
    """gt_bboxes (n, 8) float32 polygons and gt_labels int64 from
    ann_info."""

    def __init__(self, with_bbox: bool = True):
        self.with_bbox = with_bbox

    def __call__(self, results):
        ann = results["ann_info"]
        if self.with_bbox:
            results["gt_bboxes"] = ann["bboxes"].astype(np.float32).reshape(
                -1, 8)
            results["gt_labels"] = ann["labels"].astype(np.int64)
            results["bbox_fields"].append("gt_bboxes")
        return results


@register
class CorrectBox:
    """Each gt polygon, cast to int64, becomes the corners of its
    minimum-area rectangle (cv2.minAreaRect + boxPoints, data/rect.py);
    with refine_rbbox the corners are rolled so that corner 0 is the last
    of those nearest the original first point."""

    def __init__(self, correct_rbbox: bool = True,
                 refine_rbbox: bool = False):
        self.correct_rbbox = correct_rbbox
        self.refine_rbbox = refine_rbbox

    def correct_one(self, poly8: np.ndarray) -> np.ndarray:
        pts = poly8.astype(np.int64).reshape(4, 2)
        corners = rect.box_points(rect.min_area_rect(pts))
        if not self.refine_rbbox:
            return corners.reshape(-1)
        d = np.linalg.norm(corners - pts[0], axis=1)
        i = int(np.where(d <= d.min())[0][-1])
        return np.roll(corners, -i, axis=0).reshape(-1)

    def __call__(self, results):
        if self.correct_rbbox and len(results["gt_bboxes"]):
            results["gt_bboxes"] = np.stack(
                [self.correct_one(p) for p in results["gt_bboxes"]]
            ).astype(np.float32)
        return results


@register
class RotateResize:
    """Resize to a (long, short) scale drawn from img_scale (one scale,
    'range': a long and a short edge by randint, 'value': one of the
    scales, or ratio_range: the first scale times a uniform ratio).
    keep_ratio fits the image inside it (host.imrescale, a float
    scale_factor); otherwise the image becomes exactly (w, h) with a
    per-coordinate scale_factor.  Every bbox field is scaled, and clamped
    to the image when clamp_rbbox."""

    draws = True

    def __init__(self, img_scale=None, multiscale_mode: str = "range",
                 ratio_range=None, keep_ratio: bool = True,
                 clamp_rbbox: bool = True):
        if multiscale_mode not in ("range", "value"):
            raise ValueError(f"multiscale_mode {multiscale_mode!r}")
        self.img_scale = ([tuple(s) for s in img_scale]
                          if isinstance(img_scale, list)
                          else [tuple(img_scale)])
        self.multiscale_mode = multiscale_mode
        self.ratio_range = ratio_range
        self.keep_ratio = keep_ratio
        self.clamp_rbbox = clamp_rbbox

    def random_scale(self, rng):
        if self.ratio_range is not None:
            lo, hi = self.ratio_range
            r = _need(rng, "RotateResize").random_sample() * (hi - lo) + lo
            return int(self.img_scale[0][0] * r), int(self.img_scale[0][1] * r)
        if len(self.img_scale) == 1:
            return self.img_scale[0]
        rng = _need(rng, "RotateResize")
        if self.multiscale_mode == "range":
            longs = [max(s) for s in self.img_scale]
            shorts = [min(s) for s in self.img_scale]
            return (rng.randint(min(longs), max(longs) + 1),
                    rng.randint(min(shorts), max(shorts) + 1))
        return self.img_scale[rng.randint(len(self.img_scale))]

    def __call__(self, results, rng=None):
        if results["img"].dtype != np.uint8:
            raise TypeError("RotateResize takes the loaded uint8 image: "
                            "put it before Normalize")
        scale = results.get("scale") or self.random_scale(rng)
        img = torch.from_numpy(results["img"])
        if self.keep_ratio:
            img, scale_factor = host.imrescale(img, scale)
        else:
            h, w = img.shape[:2]
            if (scale[1], scale[0]) != (h, w):
                img = host.resize_uint8(img, (scale[1], scale[0]))
            scale_factor = np.array([scale[0] / w, scale[1] / h] * 4,
                                    np.float32)
        img = img.numpy()
        results["img"] = img
        results["img_shape"] = img.shape
        results["pad_shape"] = img.shape
        results["scale_factor"] = scale_factor
        for key in results.get("bbox_fields", []):
            b = results[key] * scale_factor
            if self.clamp_rbbox and len(b):
                b[:, 0::2] = np.clip(b[:, 0::2], 0, img.shape[1] - 1)
                b[:, 1::2] = np.clip(b[:, 1::2], 0, img.shape[0] - 1)
            results[key] = b
        return results


@register
class RotateRandomFlip:
    """Flip with probability flip_ratio in a direction drawn from
    `direction`; both are drawn for every sample (unless the results fix
    them), flipped or not.  Boxes follow the `dim - x - 1` convention."""

    draws = True

    def __init__(self, flip_ratio=0.0, direction=("horizontal",)):
        self.flip_ratio = flip_ratio or 0.0
        self.direction = list(direction)

    def __call__(self, results, rng=None):
        if "flip" not in results:
            results["flip"] = bool(
                _need(rng, "RotateRandomFlip").rand() < self.flip_ratio)
        if "flip_direction" not in results:
            results["flip_direction"] = str(
                _need(rng, "RotateRandomFlip").choice(self.direction))
        if results["flip"]:
            horizontal = results["flip_direction"] == "horizontal"
            img = results["img"]
            results["img"] = (img[:, ::-1] if horizontal else img[::-1]).copy()
            h, w = results["img_shape"][:2]
            for key in results.get("bbox_fields", []):
                b = results[key].copy()
                if horizontal:
                    b[..., 0::2] = w - results[key][..., 0::2] - 1
                else:
                    b[..., 1::2] = h - results[key][..., 1::2] - 1
                results[key] = b
        return results


@register
class Normalize:
    """(img - mean) / std in float32, BGR -> RGB first when to_rgb.  With
    device=True only img_norm_cfg is recorded: the uint8 image goes
    through collation and parallel/train.device_normalize does the same
    arithmetic on the card."""

    def __init__(self, mean, std, to_rgb: bool = True, device: bool = False):
        self.norm = host.Normalize(mean, std, to_rgb)
        self.device = device

    def __call__(self, results):
        results["img_norm_cfg"] = dict(mean=self.norm.mean.numpy(),
                                       std=self.norm.std.numpy(),
                                       to_rgb=self.norm.to_rgb)
        if not self.device:
            results["img"] = self.norm(
                torch.from_numpy(results["img"])).numpy()
        return results


@register
class Pad:
    """Zero-pad to `size` (h, w), or up to a multiple of size_divisor."""

    def __init__(self, size=None, size_divisor: int | None = None):
        self.size = size
        self.size_divisor = size_divisor

    def __call__(self, results):
        img = results["img"]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th = int(np.ceil(img.shape[0] / d)) * d
            tw = int(np.ceil(img.shape[1] / d)) * d
        out = np.zeros((th, tw) + img.shape[2:], dtype=img.dtype)
        out[:img.shape[0], :img.shape[1]] = img
        results["img"] = out
        results["pad_shape"] = out.shape
        return results


@register
class FilterEmpty:
    """Drop a sample without gts (the pipeline returns None)."""

    def __call__(self, results):
        if len(results.get("gt_bboxes", [])) == 0:
            return None
        return results

"""The test pipeline on a results dict (counterpart of data/pipelines.py's
LoadImageFromFile, RotateResize, Normalize, Pad and build_pipeline, after
mmdet/datasets/pipelines/{loading,transforms}.py), in numpy on the host.

Images are .npy arrays (BGR uint8).  RotateResize rescales through
host.imrescale, cv2's uint8 INTER_LINEAR in the port's own arithmetic.
The training transforms (LoadAnnotations, CorrectBox, RotateRandomFlip,
the random scales of RotateResize) are not ported yet.
"""

from __future__ import annotations

import os.path as osp
from typing import Sequence

import numpy as np
import torch

from .. import host

PIPELINES = {}


def register(cls):
    PIPELINES[cls.__name__] = cls
    return cls


def build_pipeline(cfgs: Sequence[dict]):
    """A callable over the results dict from mmdet-style {'type': ...}
    dicts; a step that returns None ends the pipeline with None."""
    steps = []
    for cfg in cfgs:
        cfg = dict(cfg)
        t = cfg.pop("type")
        if t not in PIPELINES:
            raise NotImplementedError(f"pipeline step {t} is not ported")
        steps.append(PIPELINES[t](**cfg))

    def run(results):
        for s in steps:
            results = s(results)
            if results is None:
                return None
        return results

    return run


@register
class LoadImageFromFile:
    """Load img_prefix/file_name, a .npy BGR image, as mmcv.imread would
    give it."""

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
        return results


@register
class RotateResize:
    """Keep-ratio rescale of the image to one (long, short) scale.  No
    ported step adds a bbox field, so none is scaled here yet."""

    def __init__(self, img_scale=None, multiscale_mode: str = "range",
                 ratio_range=None, keep_ratio: bool = True):
        scales = ([tuple(s) for s in img_scale]
                  if isinstance(img_scale, list) else [tuple(img_scale)])
        if len(scales) != 1 or ratio_range is not None or not keep_ratio:
            raise NotImplementedError(
                "RotateResize: only one keep-ratio scale (the test "
                "pipeline's) is ported")
        self.img_scale = scales[0]

    def __call__(self, results):
        img, factor = host.imrescale(torch.from_numpy(results["img"]),
                                     self.img_scale)
        img = img.numpy()
        results["img"] = img
        results["img_shape"] = img.shape
        results["pad_shape"] = img.shape
        results["scale_factor"] = factor
        return results


@register
class Normalize:
    """(img - mean) / std in float32, BGR -> RGB first when to_rgb."""

    def __init__(self, mean, std, to_rgb: bool = True):
        self.norm = host.Normalize(mean, std, to_rgb)

    def __call__(self, results):
        results["img_norm_cfg"] = dict(mean=self.norm.mean.numpy(),
                                       std=self.norm.std.numpy(),
                                       to_rgb=self.norm.to_rgb)
        results["img"] = self.norm(torch.from_numpy(results["img"])).numpy()
        return results


@register
class Pad:
    """Zero-pad up to a multiple of size_divisor."""

    def __init__(self, size_divisor: int):
        self.size_divisor = size_divisor

    def __call__(self, results):
        img = results["img"]
        d = self.size_divisor
        th = int(np.ceil(img.shape[0] / d)) * d
        tw = int(np.ceil(img.shape[1] / d)) * d
        out = np.zeros((th, tw) + img.shape[2:], dtype=img.dtype)
        out[:img.shape[0], :img.shape[1]] = img
        results["img"] = out
        results["pad_shape"] = out.shape
        return results

"""The train and test pipelines on a results dict (counterpart of
data/pipelines.py, after mmdet/datasets/pipelines/{loading,transforms}.py
and the reference's poly_transforms.py), in numpy and CPU tensors on the
host: LoadImageFromFile (with its decoded-image cache), Corrupt (the
robustness benchmark's image corruptions, data/corruptions.py),
LoadAnnotations, CorrectBox, RotateResize, RotateRandomFlip, Normalize,
Pad, FilterEmpty, the hard-aug transforms HSVAugment, PolyRandomRotate,
RandomRotate, PolyMosaic, PolyMosaic9 and MixUp with MultiSamplePipeline,
and the debug stage PolyImgPlot.

Images are read by data/image_io (PNG, BMP or .npy, BGR uint8, as
cv2.imread gives them).  RotateResize resizes through
host.imrescale / host.resize_uint8, cv2's uint8 INTER_LINEAR in the
port's own arithmetic; CorrectBox snaps each gt to cv2's minAreaRect
corners through data/rect.py; the rotations and the mosaics' affine crop
warp through data/warp.py and HSVAugment converts through data/color.py,
both cv2 5.0's arithmetic rebuilt.

Random draws: the JAX transforms draw from the global np.random.  Here
the pipeline is called as pipeline(results, rng) with an explicit
np.random.RandomState (the loader's, seeded per epoch), and each step
makes the same RandomState calls in the same order as its JAX
counterpart, the draws whose value goes unused included (PolyMosaic's
perspective and shear at 0, a fusion group that passes through), so
equal seeds give equal samples.  A step that must draw raises without an
rng.  Corrupt does not take the loader's rng: as in JAX, it seeds its own
RandomState from the image's file name.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Sequence

import numpy as np
import torch

from .. import host
from ..core.rbox import poly2rbox, rbox2poly
from . import color, corruptions, image_io, rect, synth, warp

PIPELINES = {}


def register(cls):
    PIPELINES[cls.__name__] = cls
    return cls


class Compose:
    """Steps in turn as one callable (results, rng=None); a step that
    returns None ends it with None.  Steps with ``draws`` set are handed
    the rng."""

    def __init__(self, steps):
        self.steps = list(steps)

    def __call__(self, results, rng: np.random.RandomState | None = None):
        for s in self.steps:
            results = (s(results, rng) if getattr(s, "draws", False)
                       else s(results))
            if results is None:
                return None
        return results


def build_pipeline(cfgs: Sequence[dict]):
    """A Compose, (results, rng=None) -> results, from mmdet-style
    {'type': ...} dicts.  With fusion steps (PolyMosaic, PolyMosaic9,
    MixUp: NUM_SAMPLES > 1), which must be contiguous, a
    MultiSamplePipeline, called as (results, rng, getter)."""
    steps = []
    for cfg in cfgs:
        cfg = dict(cfg)
        t = cfg.pop("type")
        if t not in PIPELINES:
            raise NotImplementedError(f"pipeline step {t} is not ported")
        steps.append(PIPELINES[t](**cfg))
    fusion = [i for i, s in enumerate(steps)
              if getattr(s, "NUM_SAMPLES", 1) > 1]
    if not fusion:
        return Compose(steps)
    first, last = fusion[0], fusion[-1]
    if fusion != list(range(first, last + 1)):
        raise ValueError("fusion steps (PolyMosaic / PolyMosaic9 / MixUp) "
                         "must be contiguous in the pipeline")
    return MultiSamplePipeline(pre=Compose(steps[:first]),
                               fusions=steps[first:last + 1],
                               post=Compose(steps[last + 1:]))


def _need(rng, step: str):
    if rng is None:
        raise ValueError(f"{step} draws at random: call the pipeline with "
                         "an np.random.RandomState")
    return rng


CACHE_MAX_ITEMS = 4096  # images LoadImageFromFile(cache=True) keeps


@register
class LoadImageFromFile:
    """Load img_prefix/file_name (.png, .bmp or .npy) through
    image_io.imread, BGR uint8 as mmcv.imread gives it (float32 with
    to_float32); start the list of box fields.  A file that is missing
    raises FileNotFoundError, one that image_io does not read
    ImageReadError (cv2.imread's None, which the JAX step turns into
    FileNotFoundError).  cache keeps up to CACHE_MAX_ITEMS decoded images
    by path (the first ones read) and hands out copies, as later steps
    write into the image."""

    def __init__(self, to_float32: bool = False, cache: bool = False):
        self.to_float32 = to_float32
        self.cache = {} if cache else None

    def read(self, path: str) -> np.ndarray:
        if self.cache is not None and path in self.cache:
            return self.cache[path].copy()
        img = image_io.imread(path)
        if self.cache is not None and len(self.cache) < CACHE_MAX_ITEMS:
            self.cache[path] = img.copy()
        return img

    def __call__(self, results):
        path = osp.join(results.get("img_prefix", ""),
                        results["img_info"]["file_name"])
        img = self.read(path)
        if self.to_float32:
            img = img.astype(np.float32)
        results["filename"] = path
        results["img"] = img
        results["img_shape"] = img.shape
        results["ori_shape"] = img.shape
        results["bbox_fields"] = []
        return results


@register
class Corrupt:
    """An image corruption right after the load (the robustness
    benchmark; tools/test_robustness_torch.py inserts it at index 1 of the
    test pipeline).  Severity 0 or less passes the results through;
    otherwise results["img"] (as uint8) goes through
    corruptions.corrupt with RandomState((hash(filename) ^ seed) &
    0x7FFFFFFF), so one image always gets the same corruption in one
    process.  Python salts hash(str) per process: runs repeat only under
    a fixed PYTHONHASHSEED."""

    def __init__(self, corruption: str, severity: int = 1, seed: int = 0):
        if corruption not in corruptions.CORRUPTIONS:
            raise ValueError(f"unknown corruption {corruption!r}; one of "
                             f"{sorted(corruptions.CORRUPTIONS)}")
        self.corruption = corruption
        self.severity = severity
        self.seed = seed

    def __call__(self, results):
        if self.severity <= 0:
            return results
        rng = np.random.RandomState(
            (hash(results.get("filename", "")) ^ self.seed) & 0x7FFFFFFF)
        results["img"] = corruptions.corrupt(
            results["img"].astype(np.uint8), self.corruption, self.severity,
            rng=rng)
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
    of those nearest the original first point.  The corrected gts of each
    distinct tile are kept (a dataset's worth of small arrays): mosaic x
    mixup corrects 8 tiles a sample, and the hull and calipers are Python
    that the loader's thread runs under the GIL beside the step."""

    def __init__(self, correct_rbbox: bool = True,
                 refine_rbbox: bool = False):
        self.correct_rbbox = correct_rbbox
        self.refine_rbbox = refine_rbbox
        self.corrected = {}

    def correct_one(self, poly8: np.ndarray) -> np.ndarray:
        pts = poly8.astype(np.int64).reshape(4, 2)
        corners = rect.box_points(rect.min_area_rect(pts))
        if not self.refine_rbbox:
            return corners.reshape(-1)
        d = np.linalg.norm(corners - pts[0], axis=1)
        i = int(np.where(d <= d.min())[0][-1])
        return np.roll(corners, -i, axis=0).reshape(-1)

    def __call__(self, results):
        polys = results["gt_bboxes"]
        if self.correct_rbbox and len(polys):
            key = (polys.dtype.str, polys.shape, polys.tobytes())
            if key not in self.corrected:
                self.corrected[key] = np.stack(
                    [self.correct_one(p) for p in polys]).astype(np.float32)
            results["gt_bboxes"] = self.corrected[key].copy()
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


@register
class HSVAugment:
    """Hue, saturation and value scaled by gains drawn in 1 +/- (hgain,
    sgain, vgain): cv2's uint8 BGR -> HSV, a lookup table a channel (hue
    mod 180, the others clipped to 255, each truncated to uint8), HSV ->
    BGR (data/color.py)."""

    draws = True

    def __init__(self, hgain=0.015, sgain=0.7, vgain=0.4):
        self.gains = (hgain, sgain, vgain)

    def __call__(self, results, rng=None):
        img = results["img"]
        r = (_need(rng, "HSVAugment").uniform(-1, 1, 3)
             * np.array(self.gains) + 1)
        x = np.arange(0, 256, dtype=np.int16)
        luts = (((x * r[0]) % 180).astype(img.dtype),
                np.clip(x * r[1], 0, 255).astype(img.dtype),
                np.clip(x * r[2], 0, 255).astype(img.dtype))
        results["img"] = color.hsv_to_bgr(
            color.apply_lut(color.bgr_to_hsv(img), luts))
        return results


def _rotation(results, angle: float, auto_bound: bool):
    """Warp the image by angle degrees about its centre (auto_bound: onto
    the canvas that holds the whole rotated image) -> (the 2 x 3 matrix,
    bound_w, bound_h); img and img_shape are updated."""
    h, w = results["img_shape"][:2]
    center = (w / 2.0, h / 2.0)
    if auto_bound:
        rad = np.deg2rad(angle)
        abs_cos, abs_sin = abs(np.cos(rad)), abs(np.sin(rad))
        bound_w = int(np.rint(h * abs_sin + w * abs_cos))
        bound_h = int(np.rint(h * abs_cos + w * abs_sin))
    else:
        bound_w, bound_h = w, h
    rm = warp.get_rotation_matrix_2d(center, angle, 1.0)
    if auto_bound:
        rm[0, 2] += bound_w / 2.0 - center[0]
        rm[1, 2] += bound_h / 2.0 - center[1]
    results["img"] = warp.warp_affine(results["img"], rm, (bound_w, bound_h))
    results["img_shape"] = (bound_h, bound_w) + results["img"].shape[2:]
    return rm, bound_w, bound_h


@register
class PolyRandomRotate:
    """With probability rotate_ratio, rotation by an angle drawn in
    +/- angles_range degrees (else by 0: the image is still warped and
    the gts renormalized); each gt polygon is moved, becomes a rotated box
    (poly2rbox) kept when its centre lies inside the image and both sides
    exceed 5 px, and a polygon again (rbox2poly).  A sample that loses
    every gt is dropped (None)."""

    draws = True

    def __init__(self, rotate_ratio=0.5, angles_range=180, auto_bound=False):
        self.rotate_ratio = rotate_ratio
        self.angles_range = angles_range
        self.auto_bound = auto_bound

    def __call__(self, results, rng=None):
        rng = _need(rng, "PolyRandomRotate")
        if rng.rand() < self.rotate_ratio:
            angle = float(rng.uniform(-self.angles_range, self.angles_range))
            results["rotate"] = True
        else:
            angle = 0.0
            results["rotate"] = False
        results["rotate_angle"] = angle
        rm, bound_w, bound_h = _rotation(results, angle, self.auto_bound)
        polys = results.get("gt_bboxes", np.zeros((0, 8), np.float32))
        labels = results.get("gt_labels", np.zeros((0,), np.int64))
        if len(polys):
            pts = polys.reshape(-1, 2) @ rm[:, :2].T + rm[:, 2]
            rboxes = poly2rbox(pts.reshape(-1, 8))
            keep = ((rboxes[:, 0] > 0) & (rboxes[:, 0] < bound_w)
                    & (rboxes[:, 1] > 0) & (rboxes[:, 1] < bound_h)
                    & (rboxes[:, 2] > 5) & (rboxes[:, 3] > 5))
            rboxes, labels = rboxes[keep], labels[keep]
            if len(rboxes) == 0:
                return None
            results["gt_bboxes"] = rbox2poly(rboxes).astype(np.float32)
            results["gt_labels"] = labels
        return results


@register
class RandomRotate:
    """With probability rate, rotation by an angle drawn from `angles`
    (degrees); gts are moved and kept when their corners' mean lies inside
    the image (no size filter).  A sample that loses every gt is dropped
    (None)."""

    draws = True

    def __init__(self, rate=0.5, angles=(30, 60, 90, 120, 150),
                 auto_bound=False):
        self.rate = rate
        self.angles = list(angles)
        self.auto_bound = auto_bound

    def __call__(self, results, rng=None):
        rng = _need(rng, "RandomRotate")
        if rng.rand() >= self.rate:
            results["rotate"] = False
            return results
        angle = float(rng.choice(self.angles))
        results["rotate"] = True
        results["rotate_angle"] = angle
        rm, bound_w, bound_h = _rotation(results, angle, self.auto_bound)
        polys = results.get("gt_bboxes", np.zeros((0, 8), np.float32))
        labels = results.get("gt_labels", np.zeros((0,), np.int64))
        if len(polys):
            pts = polys.reshape(-1, 2) @ rm[:, :2].T + rm[:, 2]
            polys = pts.reshape(-1, 8).astype(np.float32)
            cx = polys[:, 0::2].mean(1)
            cy = polys[:, 1::2].mean(1)
            keep = (cx > 0) & (cx < bound_w) & (cy > 0) & (cy < bound_h)
            results["gt_bboxes"] = polys[keep]
            results["gt_labels"] = labels[keep]
            if keep.sum() == 0:
                return None
        return results


def _gts(r):
    return (r.get("gt_bboxes", np.zeros((0, 8), np.float32)).copy(),
            r.get("gt_labels", np.zeros((0,), np.int64)))


def _concat(polys_all, labels_all):
    return ((np.concatenate(polys_all) if polys_all
             else np.zeros((0, 8), np.float32)),
            (np.concatenate(labels_all) if labels_all
             else np.zeros((0,), np.int64)))


def _fused(results, canvas, polys, labels):
    out = dict(results[0])
    out["img"] = canvas
    out["img_shape"] = canvas.shape
    out["gt_bboxes"] = polys
    out["gt_labels"] = labels
    return out


@register
class PolyMosaic:
    """A fusion step over 4 samples (the reference's
    Poly_Mosaic_RandomPerspective): with probability mosaic_ratio, the
    4 images tile a 2s x 2s canvas (grey 114) around a centre drawn in
    [s/2, 3s/2), their gts offset; with ifcrop, a random affine (rotation
    `degrees`, scale 1 +/- `scale`, shear, translation around the centre,
    and a perspective term when `perspective`) maps it onto s x s; gts
    whose box centre leaves the canvas or whose sides are 5 px or less
    are dropped, and a mosaic without gts is dropped (None).  Otherwise
    the group's first sample passes through."""

    NUM_SAMPLES = 4
    draws = True

    def __init__(self, degrees=0, translate=0, scale=0, shear=0,
                 perspective=0.0, ifcrop=True, mosaic_ratio=0.5):
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.perspective = perspective
        self.ifcrop = ifcrop
        self.mosaic_ratio = mosaic_ratio

    def mosaic4(self, results_4, rng):
        s = max(max(r["img"].shape[:2]) for r in results_4)
        canvas = np.full((2 * s, 2 * s, 3), 114, results_4[0]["img"].dtype)
        yc = int(rng.uniform(s * 0.5, s * 1.5))
        xc = int(rng.uniform(s * 0.5, s * 1.5))
        polys_all, labels_all = [], []
        for i, r in enumerate(results_4):
            img = r["img"]
            h, w = img.shape[:2]
            if i == 0:  # top-left: the image's bottom-right corner at (xc, yc)
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
            elif i == 1:  # top-right
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
                x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), x2a - x1a, h
            elif i == 2:  # bottom-left
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(yc + h, 2 * s)
                x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, y2a - y1a
            else:  # bottom-right
                x1a, y1a = xc, yc
                x2a, y2a = min(xc + w, 2 * s), min(yc + h, 2 * s)
                x1b, y1b, x2b, y2b = 0, 0, x2a - x1a, y2a - y1a
            canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            polys, labels = _gts(r)
            if len(polys):
                polys[:, 0::2] += x1a - x1b
                polys[:, 1::2] += y1a - y1b
                polys_all.append(polys)
                labels_all.append(labels)
        return (canvas, *_concat(polys_all, labels_all), s)

    def random_perspective(self, img, polys, labels, out_size, rng):
        """The yolo-style random affine (or perspective) crop onto
        out_size x out_size; every draw is made, zero ranges included."""
        h, w = img.shape[:2]
        c = np.eye(3)
        c[0, 2] = -w / 2
        c[1, 2] = -h / 2
        p = np.eye(3)
        p[2, 0] = rng.uniform(-self.perspective, self.perspective)
        p[2, 1] = rng.uniform(-self.perspective, self.perspective)
        r = np.eye(3)
        ang = rng.uniform(-self.degrees, self.degrees)
        sc = rng.uniform(1 - self.scale, 1 + self.scale)
        r[:2] = warp.get_rotation_matrix_2d((0, 0), ang, sc)
        sh = np.eye(3)
        sh[0, 1] = np.tan(np.deg2rad(rng.uniform(-self.shear, self.shear)))
        sh[1, 0] = np.tan(np.deg2rad(rng.uniform(-self.shear, self.shear)))
        t = np.eye(3)
        t[0, 2] = rng.uniform(0.5 - self.translate,
                              0.5 + self.translate) * out_size
        t[1, 2] = rng.uniform(0.5 - self.translate,
                              0.5 + self.translate) * out_size
        m = t @ sh @ r @ p @ c
        if self.perspective:
            img = warp.warp_perspective(img, m, (out_size, out_size), 114)
        else:
            img = warp.warp_affine(img, m[:2], (out_size, out_size), 114)
        if len(polys):
            pts = polys.reshape(-1, 2)
            pts = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ m.T
            pts = (pts[:, :2] / pts[:, 2:3] if self.perspective
                   else pts[:, :2])
            polys = pts.reshape(-1, 8).astype(np.float32)
        return img, polys, labels

    @staticmethod
    def filter(polys, labels, h, w):
        """Keep the gts whose box centre lies inside (w, h) and whose
        sides exceed 5 px, as polygons again."""
        if not len(polys):
            return polys, labels
        rb = poly2rbox(polys)
        keep = ((rb[:, 0] > 0) & (rb[:, 0] < w) & (rb[:, 1] > 0)
                & (rb[:, 1] < h) & (rb[:, 2] > 5) & (rb[:, 3] > 5))
        rb, labels = rb[keep], labels[keep]
        return (rbox2poly(rb).astype(np.float32) if len(rb)
                else np.zeros((0, 8), np.float32)), labels

    def crop_and_filter(self, results, canvas, polys, labels, s, rng):
        if self.ifcrop:
            canvas, polys, labels = self.random_perspective(
                canvas, polys, labels, s, rng)
            h = w = s
        else:
            h, w = canvas.shape[:2]
        polys, labels = self.filter(polys, labels, h, w)
        if len(polys) == 0:
            return None
        return _fused(results, canvas, polys, labels)

    def __call__(self, results, rng=None):
        if not isinstance(results, list):
            return results
        rng = _need(rng, "PolyMosaic")
        if rng.rand() >= self.mosaic_ratio:
            return results[0]
        canvas, polys, labels, s = self.mosaic4(results[:4], rng)
        return self.crop_and_filter(results, canvas, polys, labels, s, rng)


@register
class PolyMosaic9(PolyMosaic):
    """PolyMosaic over 9 samples: they tile a 3s x 3s canvas on a 3 x 3
    grid (the first at the centre, each anchored toward it), a 2s x 2s
    window is cut at an offset drawn in [0, s), then PolyMosaic's crop
    and filter.  A group short of 9 passes its first sample through."""

    NUM_SAMPLES = 9
    # grid cells: the centre first, then the 8 neighbours
    CELLS = [(1, 1), (0, 0), (0, 1), (0, 2), (1, 0), (1, 2), (2, 0),
             (2, 1), (2, 2)]

    def mosaic9(self, results_9, rng):
        s = max(max(r["img"].shape[:2]) for r in results_9)
        canvas = np.full((3 * s, 3 * s, 3), 114, results_9[0]["img"].dtype)
        polys_all, labels_all = [], []
        for (gy, gx), r in zip(self.CELLS, results_9):
            img = r["img"]
            h, w = (min(d, s) for d in img.shape[:2])
            y0 = gy * s + (s - h if gy == 0 else 0)
            x0 = gx * s + (s - w if gx == 0 else 0)
            canvas[y0:y0 + h, x0:x0 + w] = img[:h, :w]
            polys, labels = _gts(r)
            if len(polys):
                polys[:, 0::2] += x0
                polys[:, 1::2] += y0
                polys_all.append(polys)
                labels_all.append(labels)
        polys, labels = _concat(polys_all, labels_all)
        yc = int(rng.uniform(0, s))
        xc = int(rng.uniform(0, s))
        canvas = canvas[yc:yc + 2 * s, xc:xc + 2 * s]
        if len(polys):
            polys[:, 0::2] -= xc
            polys[:, 1::2] -= yc
        return canvas, polys, labels, s

    def __call__(self, results, rng=None):
        if not isinstance(results, list):
            return results
        rng = _need(rng, "PolyMosaic9")
        if rng.rand() >= self.mosaic_ratio or len(results) < 9:
            return results[0]
        canvas, polys, labels, s = self.mosaic9(results[:9], rng)
        return self.crop_and_filter(results, canvas, polys, labels, s, rng)


@register
class MixUp:
    """A fusion step over 2 samples: with probability mixup_ratio, img =
    r img1 + (1 - r) img2 in float32 (both zero-padded to the larger
    size), r ~ Beta(8, 8), cast back to the first image's dtype
    (truncating), the gts of both kept.  Otherwise, or for a group of
    one, the first sample passes through."""

    NUM_SAMPLES = 2
    draws = True

    def __init__(self, mixup_ratio=0.5):
        self.mixup_ratio = mixup_ratio

    def __call__(self, results, rng=None):
        if not isinstance(results, list):
            return results
        rng = _need(rng, "MixUp")
        if rng.rand() >= self.mixup_ratio or len(results) < 2:
            return results[0]
        r1, r2 = results[0], results[1]
        h = max(r1["img"].shape[0], r2["img"].shape[0])
        w = max(r1["img"].shape[1], r2["img"].shape[1])

        def pad(img):
            out = np.zeros((h, w) + img.shape[2:], img.dtype)
            out[:img.shape[0], :img.shape[1]] = img
            return out

        r = rng.beta(8.0, 8.0)
        img = (pad(r1["img"]).astype(np.float32) * r
               + pad(r2["img"]).astype(np.float32) * (1 - r))
        out = dict(r1)
        out["img"] = img.astype(r1["img"].dtype)
        out["img_shape"] = img.shape
        out["gt_bboxes"] = np.concatenate([r1["gt_bboxes"], r2["gt_bboxes"]])
        out["gt_labels"] = np.concatenate([r1["gt_labels"], r2["gt_labels"]])
        return out


@register
class PolyImgPlot:
    """Debug stage: draw the gt polygons on a copy of the image (its uint8
    cast) and write img_save_path/sample_NNNNN.png, for the first max_imgs
    samples; the results pass through.  Each polygon rounded half to even,
    closed, thickness 2, in its label's colour (cv2.polylines through
    synth.polylines, the file through image_io.imwrite)."""

    COLORS = [
        (54, 67, 244), (99, 30, 233), (176, 39, 156), (183, 58, 103),
        (181, 81, 63), (243, 150, 33), (212, 188, 0), (136, 150, 0),
        (80, 175, 76), (74, 195, 139), (57, 220, 205), (59, 235, 255),
        (0, 152, 255), (34, 87, 255), (72, 85, 121), (180, 180, 180),
    ]

    def __init__(self, img_save_path: str = "work_dirs/pipeline_vis",
                 max_imgs: int = 100):
        self.save_path = img_save_path
        self.max_imgs = max_imgs
        self.count = 0

    def __call__(self, results):
        if results is None or self.count >= self.max_imgs:
            return results
        os.makedirs(self.save_path, exist_ok=True)
        img = np.asarray(results["img"]).astype(np.uint8)
        polys = np.asarray(results.get("gt_bboxes",
                                       np.zeros((0, 8), np.float32)))
        labels = np.asarray(results.get("gt_labels",
                                        np.zeros(len(polys), np.int64)))
        for poly, lab in zip(polys, labels):
            synth.polylines(img, np.round(poly).astype(np.int32).reshape(4, 2),
                            self.COLORS[int(lab) % len(self.COLORS)], 2)
        image_io.imwrite(osp.join(self.save_path,
                                  f"sample_{self.count:05d}.png"), img)
        self.count += 1
        return results


class MultiSamplePipeline:
    """A pipeline with fusion steps: `pre` runs on each sample, each
    fusion step takes groups of its NUM_SAMPLES results of the step
    before (so [PolyMosaic, MixUp] mixes two 4-image mosaics), `post`
    runs on the first fused result.

    Called as pipeline(results, rng, getter): getter() returns the raw
    results of another sample, drawn at random (DotaDataset passes one
    that draws from rng).  Samples that `pre` drops are replaced, up to
    5 tries a needed sample; a short supply leaves partial groups, which
    the fusion steps pass through; fused results that are None are
    dropped."""

    def __init__(self, pre, fusions, post):
        self.pre = pre
        self.fusions = fusions
        self.post = post
        self.num_samples = int(np.prod([f.NUM_SAMPLES for f in fusions]))

    def materialize(self, results, rng, getter, need: int) -> list:
        out = []
        r0 = self.pre(results, rng)
        if r0 is not None:
            out.append(r0)
        tries = 0
        while len(out) < need and tries < need * 5:
            r = self.pre(getter(), rng)
            if r is not None:
                out.append(r)
            tries += 1
        return out

    def __call__(self, results, rng=None, getter=None):
        if getter is None:
            raise TypeError("MultiSamplePipeline needs a sample getter: use "
                            "it through a dataset (DotaDataset.prepare "
                            "passes one)")
        samples = self.materialize(results, rng, getter, self.num_samples)
        if not samples:
            return None
        for f in self.fusions:
            n = f.NUM_SAMPLES
            groups = [samples[i:i + n] for i in range(0, len(samples), n)]
            samples = [r for r in (f(g, rng) for g in groups)
                       if r is not None]
            if not samples:
                return None
        return self.post(samples[0], rng)

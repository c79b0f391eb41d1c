"""The port's training data path against the JAX package's, on the CPU:
CorrectBox's cv2-free min-area rect, every train transform and whole
train pipelines, the grouped sampler, collate and the prefetching loader.

The JAX side renders three 384^2 train scenes with cv2 (PNG) and the port
reads the same pixels as .npy; both cut them into 256^2 tiles (12 tiles,
~130 gts).  The JAX transforms draw from the global np.random, the port's
from an explicit RandomState: the tests seed the first with the seed the
second is built from, and every comparison is exact (images byte for
byte, polygons, labels, flips and scale factors equal).
"""

import os
import threading

import cv2
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.data import loader as loader_ref
from orientedreppoints_tpu.data import pipelines as pipelines_ref
from orientedreppoints_tpu.data import synth as synth_ref
from orientedreppoints_tpu.devkit import dota_utils as util_ref
from orientedreppoints_tpu.devkit.dota2coco import \
    dota2coco_train as dota2coco_ref
from orientedreppoints_tpu.devkit.img_split import ImgSplit as ImgSplitRef
from orientedreppoints_tpu.utils import builder
from orientedreppoints_tpu_torch import apis
from orientedreppoints_tpu_torch.data import loader, rect
from orientedreppoints_tpu_torch.data.pipelines import (CorrectBox,
                                                        build_pipeline)
from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
from orientedreppoints_tpu_torch.devkit.img_split import ImgSplit
from orientedreppoints_tpu_torch.host import load_config


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SYNTH = "configs/dota/synth_r18_512.py"
R50 = "configs/dota/orientedreppoints_r50_demo.py"
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)


def rotated_rect(rng, n, angles=None, w_range=(1, 120), h_range=(1, 120),
                 square=False):
    cx, cy = rng.uniform(0, 500, (2, n))
    w = rng.uniform(*w_range, n)
    h = w if square else rng.uniform(*h_range, n)
    a = (rng.uniform(0, np.pi, n) if angles is None
         else rng.choice(angles, n))
    c, s = np.cos(a), np.sin(a)
    corners = np.stack([np.stack([-w, -h], 1), np.stack([w, -h], 1),
                        np.stack([w, h], 1), np.stack([-w, h], 1)], 1) / 2
    x = corners[..., 0] * c[:, None] - corners[..., 1] * s[:, None]
    y = corners[..., 0] * s[:, None] + corners[..., 1] * c[:, None]
    return np.stack([x + cx[:, None], y + cy[:, None]], -1).reshape(n, 8)


def quads(kind, n=700, seed=0):
    """Seeded polygons (n, 8) of one kind, float32 as gts are."""
    rng = np.random.default_rng(seed)
    if kind == "rect_any_angle":
        p = rotated_rect(rng, n)
    elif kind == "rect_0_45_90":
        p = rotated_rect(rng, n, angles=[0, np.pi / 4, np.pi / 2,
                                         3 * np.pi / 4, np.pi])
    elif kind == "squares":
        p = rotated_rect(rng, n, square=True)
    elif kind == "thin":  # a side of 0.3-3 px, the other up to 200
        p = rotated_rect(rng, n, w_range=(0.3, 3), h_range=(10, 200))
    elif kind == "collinear":  # on a line, integer or nearly
        start = rng.uniform(0, 400, (n, 1, 2))
        step = rng.integers(-20, 21, (n, 1, 2))
        p = (start + rng.integers(0, 5, (n, 4, 1)) * step
             + rng.normal(0, 0.2, (n, 4, 2))).reshape(n, 8)
    elif kind == "repeated":  # 1-3 distinct points, each repeated
        pts = rng.uniform(0, 400, (n, 3, 2))
        pick = rng.integers(0, rng.integers(1, 4, (n, 1)), (n, 4))
        p = np.take_along_axis(pts, pick[..., None], 1).reshape(n, 8)
    elif kind == "single_point":
        p = np.repeat(rng.uniform(-3, 400, (n, 1, 2)), 4, 1).reshape(n, 8)
    elif kind == "random_quads":  # any order, convex or not, tiny or not
        scale = rng.choice([2.0, 8.0, 60.0], (n, 1))
        p = rng.uniform(0, 1, (n, 8)) * scale + rng.uniform(-5, 400, (n, 1))
    return p.astype(np.float32)


QUAD_KINDS = ["rect_any_angle", "rect_0_45_90", "squares", "thin",
              "collinear", "repeated", "single_point", "random_quads"]


def correct_both(polys, refine):
    ref = pipelines_ref.CorrectBox(refine_rbbox=refine)
    got = CorrectBox(refine_rbbox=refine)
    return (np.stack([ref._correct_one(p) for p in polys]),
            np.stack([got.correct_one(p) for p in polys]))


@pytest.mark.parametrize("kind", QUAD_KINDS)
def test_correct_box_matches_cv2(kind):
    """5,600 seeded quads (700 a kind): the port's hull, min-area rect and
    CorrectBox corners (refined or not) equal cv2's bit for bit, corner
    order included."""
    polys = quads(kind, seed=QUAD_KINDS.index(kind))
    for refine in (False, True):
        want, got = correct_both(polys, refine)
        assert want.dtype == got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    n_hull = {1: 0, 2: 0, 3: 0, 4: 0}
    for p in polys:
        pts = p.astype(np.int64).reshape(4, 2)
        hull = cv2.convexHull(pts.astype(np.float32)).reshape(-1, 2)
        np.testing.assert_array_equal(
            pts[rect.convex_hull(pts)].astype(np.float32), hull)
        n_hull[len(hull)] += 1
        (cx, cy), (w, h), a = cv2.minAreaRect(pts.astype(np.float32))
        assert rect.min_area_rect(pts) == ((cx, cy), (w, h), a)
        assert -90 <= a < 0
    if kind == "single_point":
        assert n_hull[1] == len(polys)
    if kind in ("collinear", "repeated"):  # the 1- and 2-point branches
        assert n_hull[2] > 50 and n_hull[1] + n_hull[2] < len(polys)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Three 384^2 train scenes (JAX: PNG; port: the same pixels as .npy)
    cut into 256^2 tiles at gap 128, with both packages' jsons."""
    root = tmp_path_factory.mktemp("train_scenes")
    synth_ref.generate_synth_dota(str(root / "ref_raw"), 3, size=384,
                                  seed=0, prefix="T")
    for sub in ("images", "labelTxt"):
        os.makedirs(root / "port_raw" / sub)
    for p in util_ref.list_files(str(root / "ref_raw" / "images"), ".png"):
        n = util_ref.basename_noext(p)
        np.save(root / "port_raw" / "images" / f"{n}.npy", cv2.imread(p))
        (root / "port_raw" / "labelTxt" / f"{n}.txt").write_bytes(
            (root / "ref_raw" / "labelTxt" / f"{n}.txt").read_bytes())
    ImgSplitRef(str(root / "ref_raw"), str(root / "ref"), gap=128,
                subsize=256, num_process=1).splitdata()
    ImgSplit(str(root / "port_raw"), str(root / "port"), gap=128,
             subsize=256, ext=".npy", num_process=1).splitdata()
    dota2coco_ref(str(root / "ref"), str(root / "ref.json"))
    dota2coco_train(str(root / "port"), str(root / "port.json"), ext=".npy")
    return root


def datasets(split, pipeline, device_normalize=False):
    """The port's and the JAX package's DotaDataset over the split."""
    dcfg = dict(type="DotaDataset", pipeline=pipeline)
    got = apis.build_dataset(dict(dcfg, ann_file=str(split / "port.json"),
                                  img_prefix=str(split / "port" / "images")),
                             device_normalize=device_normalize)
    ref = builder.build_dataset(dict(dcfg, ann_file=str(split / "ref.json"),
                                     img_prefix=str(split / "ref" / "images")),
                                device_normalize=device_normalize)
    assert len(got) == len(ref) == 12
    return got, ref


def test_rendered_gts_correct_like_cv2(split):
    """Every gt of the rendered train tiles, as LoadAnnotations gives it."""
    got, _ = datasets(split, [])
    polys = np.concatenate([a["bboxes"] for a in got.anns])
    assert len(polys) > 100
    for refine in (False, True):
        want, out = correct_both(polys, refine)
        np.testing.assert_array_equal(out, want)


def assert_same_results(got, want, where):
    skip = {"filename", "img_info", "img_prefix"}
    assert set(got) - skip == set(want) - skip, where
    for k in sorted(set(want) - skip):
        a, b = got[k], want[k]
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, (where, k)
            np.testing.assert_array_equal(a, b, err_msg=f"{where}: {k}")
        elif isinstance(b, dict):
            assert a.keys() == b.keys(), (where, k)
            for kk in b:
                np.testing.assert_array_equal(a[kk], b[kk])
        else:
            assert type(a) is type(b) and a == b, (where, k, a, b)


def train_pipeline(path):
    return load_config(path)["train_pipeline"]


PIPELINES = {
    # the configs' train pipelines (R-50: 'range' scales, no clamp)
    "synth_r18_512": (train_pipeline(SYNTH), False),
    "synth_r18_512_device_norm": (train_pipeline(SYNTH), True),
    "r50_demo_device_norm": (train_pipeline(R50), True),
    # the other options: 'value' scales, keep_ratio=False, both flip
    # directions, Pad(size), FilterEmpty; ratio_range
    "value_no_keep_ratio": ([
        dict(type="LoadImageFromFile"),
        dict(type="LoadAnnotations", with_bbox=True),
        dict(type="CorrectBox", correct_rbbox=True, refine_rbbox=False),
        dict(type="RotateResize", img_scale=[(300, 200), (400, 250)],
             multiscale_mode="value", keep_ratio=False),
        dict(type="RotateRandomFlip", flip_ratio=0.7,
             direction=["horizontal", "vertical"]),
        dict(type="Normalize", **NORM),
        dict(type="Pad", size=(416, 416)),
        dict(type="FilterEmpty"),
    ], False),
    "ratio_range_vertical": ([
        dict(type="LoadImageFromFile"),
        dict(type="LoadAnnotations", with_bbox=True),
        dict(type="CorrectBox", correct_rbbox=True, refine_rbbox=True),
        dict(type="RotateResize", img_scale=(256, 256),
             ratio_range=(0.5, 1.5), keep_ratio=True),
        dict(type="RotateRandomFlip", flip_ratio=1.0,
             direction=["vertical"]),
        dict(type="Normalize", **NORM, device=True),
        dict(type="Pad", size_divisor=32),
    ], False),
}


@pytest.mark.parametrize("name", list(PIPELINES))
def test_train_pipeline_matches_jax_step_by_step(split, name):
    """Every tile through each transform in turn, the results dicts equal
    after every step (JAX: global np.random seeded; port: the same seed in
    a RandomState); then the whole pipeline through both datasets."""
    steps, device_normalize = PIPELINES[name]
    got_ds, ref_ds = datasets(split, steps, device_normalize)
    if device_normalize:
        steps = [dict(s, device=True) if s["type"] == "Normalize" else s
                 for s in steps]
    ours = [build_pipeline([s]) for s in steps]
    theirs = [pipelines_ref.build_pipeline([s]) for s in steps]
    flips = set()
    for i in range(len(got_ds)):
        seed = 100 + i
        rng = np.random.RandomState(seed)
        np.random.seed(seed)
        a, b = got_ds.get_raw(i), ref_ds.get_raw(i)
        for cfg, ours_step, theirs_step in zip(steps, ours, theirs):
            a, b = ours_step(a, rng), theirs_step(b)
            assert_same_results(a, b, f"tile {i} after {cfg['type']}")
        flips.add((a["flip"], a["flip_direction"]))
        np.random.seed(seed)
        assert_same_results(got_ds.prepare(i, np.random.RandomState(seed)),
                            ref_ds[i], f"tile {i}: whole pipeline")
    if name == "value_no_keep_ratio":
        assert {f for f, _ in flips} == {False, True}
        assert {d for _, d in flips} == {"horizontal", "vertical"}


def test_random_steps_refuse_to_draw_without_rng(split):
    got_ds, _ = datasets(split, train_pipeline(R50))
    with pytest.raises(ValueError, match="RandomState"):
        got_ds[0]


@pytest.mark.parametrize("flags, batch_size, seed", [
    ([0] * 12, 4, 0), ([0] * 12, 5, 3), ([0, 1] * 7 + [1], 4, 1),
    ([1, 0, 0, 1, 1, 1, 0], 2, 7)])
def test_grouped_batch_sampler_matches(flags, batch_size, seed):
    got = loader.GroupedBatchSampler(np.array(flags), batch_size, seed)
    ref = loader_ref.GroupedBatchSampler(np.array(flags), batch_size, seed)
    assert len(got) == len(ref)
    for a, b in zip(list(got), list(ref)):  # two epochs of one sampler
        np.testing.assert_array_equal(a, b)
    assert [x.tolist() for x in got] == [x.tolist() for x in ref]


def test_pick_canvas_and_collate_match():
    rng = np.random.default_rng(0)
    buckets = [(256, 256), (384, 512), (512, 512)]
    for h, w in [(10, 10), (256, 257), (300, 500), (600, 10)]:
        assert loader.pick_canvas(h, w, buckets) == \
            loader_ref.pick_canvas(h, w, buckets)
    for dtype in (np.uint8, np.float32):
        samples = [dict(img=(rng.random((h, w, 3)) * 255).astype(dtype),
                        img_shape=(h, w, 3),
                        gt_bboxes=rng.random((n, 8)).astype(np.float32),
                        gt_labels=rng.integers(1, 16, n))
                   for h, w, n in [(200, 256, 3), (256, 300, 9), (64, 64, 0)]]
        samples[2].pop("gt_bboxes")
        got = loader.collate(samples, (256, 256), 8)
        ref = loader_ref.collate(samples, (256, 256), 8)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k])


def test_loader_two_epochs_match_jax(split):
    """synth_r18_512's pipeline with device normalization (uint8
    canvases), batch 4 at canvas 512 and max_gt 64: every batch of two
    epochs equals the JAX DataLoader's, the JAX worker's global np.random
    seeded as the port's aug_rng is for each epoch."""
    got_ds, ref_ds = datasets(split, train_pipeline(SYNTH), True)
    kw = dict(batch_size=4, canvas_buckets=[(512, 512)], max_gt=64, seed=5)
    ours = loader.DataLoader(got_ds, **kw)
    theirs = loader_ref.DataLoader(ref_ds, **kw)
    assert len(ours) == len(theirs) == 3
    for epoch in range(2):
        np.random.set_state(loader.aug_rng(5, epoch).get_state())
        ref_batches = list(theirs)
        got_batches = list(ours)
        assert len(got_batches) == len(ref_batches) == 3
        for a, b in zip(got_batches, ref_batches):
            assert a.keys() == b.keys()
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert got_batches[0]["images"].dtype == np.uint8
        assert got_batches[0]["gt_valid"].sum() > 0
    assert ours.epoch == theirs.epoch == 2


class Failing:
    """A dataset whose item `bad` raises."""

    def __init__(self, n=10, bad=5):
        self.flag = np.zeros(n, np.uint8)
        self.bad = bad

    def __len__(self):
        return len(self.flag)

    def prepare(self, i, rng):
        if i == self.bad:
            raise KeyError(f"item {i}")
        return dict(img=np.full((8, 8, 3), i, np.uint8), img_shape=(8, 8, 3),
                    gt_bboxes=np.zeros((1, 8), np.float32),
                    gt_labels=np.ones(1, np.int64))


def loader_threads():
    return [t for t in threading.enumerate() if t.name == "DataLoader"]


def test_loader_reraises_a_worker_error():
    dl = loader.DataLoader(Failing(), batch_size=2, canvas_buckets=[(8, 8)],
                           max_gt=2)
    with pytest.raises(KeyError, match="item 5"):
        for _ in dl:
            pass
    assert not loader_threads()


def test_loader_early_break_joins_the_worker():
    dl = loader.DataLoader(Failing(bad=-1), batch_size=2,
                           canvas_buckets=[(8, 8)], max_gt=2)
    first = next(iter(dl))  # the generator is dropped at once
    assert first["images"].shape == (2, 8, 8, 3)
    for b in dl:  # epoch 1, left after its first batch
        break
    assert dl.epoch == 2
    assert not loader_threads()
    # an epoch's batches depend on (seed, epoch) only
    fresh = loader.DataLoader(Failing(bad=-1), batch_size=2,
                              canvas_buckets=[(8, 8)], max_gt=2)
    fresh.epoch = 1
    np.testing.assert_array_equal(next(iter(fresh))["images"], b["images"])

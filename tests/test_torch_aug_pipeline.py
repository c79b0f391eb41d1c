"""The port's hard-aug transforms against the JAX package's, on the CPU:
HSVAugment, PolyRandomRotate, RandomRotate, PolyMosaic, PolyMosaic9 and
MixUp one by one, the image cache, then whole train pipelines with
MultiSamplePipeline through both packages' DotaDataset and DataLoader.

The port renders three 384^2 hard train scenes (.npy); the JAX side reads
PNGs that cv2.imwrite wrote of the same pixels; both cut them into 256^2
tiles (12 tiles).  The JAX transforms draw from the global np.random, the
port's from an explicit RandomState: each comparison seeds the first with
the second's state.  data/warp.py and data/color.py equal cv2 bit for bit
(tests/test_torch_aug.py), so every comparison is exact: images byte for
byte, polygons (float32), labels and every other key equal.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.core import rbox as rbox_ref
from orientedreppoints_tpu.data import loader as loader_ref
from orientedreppoints_tpu.data import pipelines as pipelines_ref
from orientedreppoints_tpu.devkit.dota2coco import \
    dota2coco_train as dota2coco_ref
from orientedreppoints_tpu.devkit.img_split import ImgSplit as ImgSplitRef
from orientedreppoints_tpu.utils import builder
from orientedreppoints_tpu_torch import apis
from orientedreppoints_tpu_torch.core import rbox
from orientedreppoints_tpu_torch.data import loader, pipelines
from orientedreppoints_tpu_torch.data.synth import generate_synth_dota
from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
from orientedreppoints_tpu_torch.devkit.img_split import ImgSplit
from orientedreppoints_tpu_torch.host import load_config


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite runs files side by side in worker
    processes, and torch's default pool oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


HARD_AUG = "configs/dota/synth_r18_512_hard_aug.py"
PRE = [dict(type="LoadImageFromFile"),
       dict(type="LoadAnnotations", with_bbox=True),
       dict(type="CorrectBox", correct_rbbox=True, refine_rbbox=True)]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """Three 384^2 hard train scenes (port: .npy; JAX: PNGs of the same
    pixels) cut into 256^2 tiles at gap 128, with both packages' jsons."""
    root = tmp_path_factory.mktemp("aug_scenes")
    generate_synth_dota(str(root / "port_raw"), 3, size=384, n_objects=24,
                        seed=3, prefix="T", hard=True)
    for sub in ("images", "labelTxt"):
        os.makedirs(root / "ref_raw" / sub)
    for f in sorted(os.listdir(root / "port_raw" / "images")):
        n = f[:-len(".npy")]
        cv2.imwrite(str(root / "ref_raw" / "images" / f"{n}.png"),
                    np.load(root / "port_raw" / "images" / f))
        (root / "ref_raw" / "labelTxt" / f"{n}.txt").write_bytes(
            (root / "port_raw" / "labelTxt" / f"{n}.txt").read_bytes())
    ImgSplit(str(root / "port_raw"), str(root / "port"), gap=128,
             subsize=256, ext=".npy", num_process=1).splitdata()
    ImgSplitRef(str(root / "ref_raw"), str(root / "ref"), gap=128,
                subsize=256, num_process=1).splitdata()
    dota2coco_train(str(root / "port"), str(root / "port.json"), ext=".npy")
    dota2coco_ref(str(root / "ref"), str(root / "ref.json"))
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


def test_poly2rbox_matches_jax():
    """The rotations' and mosaics' gt filter: rotated rectangles in any
    order and degenerate quads, exactly (float32 out)."""
    rng = np.random.default_rng(5)
    polys = rng.uniform(-50, 600, (300, 8))
    w, h = rng.uniform(1, 200, (2, 300))
    t = rng.uniform(-np.pi, np.pi, 300)
    c, s = np.cos(t), np.sin(t)
    x, y = np.stack([(-w, -h), (w, -h), (w, h), (-w, h)], 1) / 2
    rects = np.stack([x * c - y * s, x * s + y * c], -1)  # (4, n, 2)
    rects = rects.transpose(1, 0, 2).reshape(300, 8) + 300
    degenerate = np.repeat(rng.uniform(0, 500, (50, 2)), 4, 0).reshape(50, 8)
    for p in (polys, rects, degenerate, rects.astype(np.float32)):
        np.testing.assert_array_equal(rbox.poly2rbox(p),
                                      rbox_ref.poly2rbox(p))


SKIP = {"filename", "img_info", "img_prefix"}


def assert_same(got, want, where):
    """Two results dicts (or None) equal key for key, arrays by dtype and
    value; paths aside."""
    if want is None or got is None:
        assert got is None and want is None, where
        return
    assert set(got) - SKIP == set(want) - SKIP, where
    for k in sorted(set(want) - SKIP):
        a, b = got[k], want[k]
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, (where, k)
            np.testing.assert_array_equal(a, b, err_msg=f"{where}: {k}")
        elif isinstance(b, dict):
            assert a.keys() == b.keys(), (where, k)
            for kk in b:
                np.testing.assert_array_equal(a[kk], b[kk])
        else:
            assert a == b, (where, k, a, b)


def pre_samples(split):
    """Every tile loaded and corrected, through both packages."""
    got, ref = datasets(split, PRE)
    return ([got.prepare(i) for i in range(len(got))],
            [ref[i] for i in range(len(ref))])


def copy_results(r):
    return {k: (v.copy() if isinstance(v, np.ndarray) else
                list(v) if isinstance(v, list) else v)
            for k, v in r.items()}


SINGLE = {
    "hsv": dict(type="HSVAugment", hgain=0.015, sgain=0.7, vgain=0.4),
    "hsv_wide": dict(type="HSVAugment", hgain=0.5, sgain=0.9, vgain=0.9),
    "rotate": dict(type="PolyRandomRotate", rotate_ratio=0.5,
                   angles_range=180),
    "rotate_always_auto_bound": dict(type="PolyRandomRotate",
                                     rotate_ratio=1.0, angles_range=180,
                                     auto_bound=True),
    "random_rotate": dict(type="RandomRotate", rate=0.7),
    "random_rotate_auto_bound": dict(type="RandomRotate", rate=1.0,
                                     angles=(30, 90, 135, 180),
                                     auto_bound=True),
}


@pytest.mark.parametrize("name", list(SINGLE))
def test_single_sample_transform_matches_jax(split, name):
    """Each tile through the transform at three seeds: the same image,
    polygons, labels and flags (or both None)."""
    ours = pipelines.build_pipeline([SINGLE[name]])
    theirs = pipelines_ref.build_pipeline([SINGLE[name]])
    got, ref = pre_samples(split)
    outcomes = set()
    for i, (a, b) in enumerate(zip(got, ref)):
        for seed in range(3):
            rng = np.random.RandomState(1000 * seed + i)
            np.random.set_state(rng.get_state())
            out_a = ours(copy_results(a), rng)
            out_b = theirs(copy_results(b))
            assert_same(out_a, out_b, f"tile {i} seed {seed}")
            # the same number of draws on both sides
            assert rng.randint(1 << 30) == np.random.randint(1 << 30)
            outcomes.add(None if out_b is None
                         else out_b.get("rotate", "hsv"))
    assert outcomes & {True, "hsv"}, outcomes


FUSION = {
    "mosaic_crop": (dict(type="PolyMosaic", degrees=0, translate=0.1,
                         scale=0.25, shear=0, perspective=0.0, ifcrop=True,
                         mosaic_ratio=1.0), 4),
    "mosaic_rotated_sheared": (dict(type="PolyMosaic", degrees=20,
                                    translate=0.2, scale=0.3, shear=5,
                                    mosaic_ratio=0.8), 4),
    "mosaic_perspective": (dict(type="PolyMosaic", degrees=10,
                                translate=0.1, scale=0.25, shear=2,
                                perspective=0.0005, mosaic_ratio=1.0), 4),
    "mosaic_no_crop": (dict(type="PolyMosaic", ifcrop=False,
                            mosaic_ratio=1.0), 4),
    "mosaic9": (dict(type="PolyMosaic9", translate=0.1, scale=0.25,
                     mosaic_ratio=1.0), 9),
    "mosaic9_short_group": (dict(type="PolyMosaic9", mosaic_ratio=1.0), 5),
    "mixup": (dict(type="MixUp", mixup_ratio=1.0), 2),
    "mixup_half": (dict(type="MixUp", mixup_ratio=0.5), 2),
    "mixup_partial_group": (dict(type="MixUp", mixup_ratio=1.0), 1),
}


@pytest.mark.parametrize("name", list(FUSION))
def test_fusion_transform_matches_jax(split, name):
    """Groups of tiles (at several seeds, rotating through the split)
    fused by both packages: the same output (or both None) and the same
    number of draws."""
    cfg, n = FUSION[name]
    kw = {k: v for k, v in cfg.items() if k != "type"}
    ours = pipelines.PIPELINES[cfg["type"]](**kw)
    theirs = pipelines_ref.PIPELINES[cfg["type"]](**kw)
    got, ref = pre_samples(split)
    kept = 0
    for seed in range(8):
        idx = [(seed * 5 + 3 * k) % len(got) for k in range(n)]
        rng = np.random.RandomState(seed)
        np.random.set_state(rng.get_state())
        out_a = ours([copy_results(got[i]) for i in idx], rng)
        out_b = theirs([copy_results(ref[i]) for i in idx])
        assert_same(out_a, out_b, f"group {idx} seed {seed}")
        assert rng.randint(1 << 30) == np.random.randint(1 << 30)
        kept += out_b is not None
    assert kept > 0


def test_image_cache_hands_out_copies(split, monkeypatch):
    """cache=True: the same pixels as a fresh read, a copy each call, at
    most CACHE_MAX_ITEMS kept; to_float32 (ported) the same pixels in
    float32; CorrectBox's kept corrections likewise."""
    monkeypatch.setattr(pipelines, "CACHE_MAX_ITEMS", 2)
    step = pipelines.LoadImageFromFile(cache=True)
    got, _ = datasets(split, [])
    first = [step(got.get_raw(i))["img"] for i in range(3)]
    assert len(step.cache) == 2
    for i in range(3):
        again = step(got.get_raw(i))["img"]
        np.testing.assert_array_equal(again, first[i])
        again[:] = 0
        np.testing.assert_array_equal(step(got.get_raw(i))["img"], first[i])
    as_float = pipelines.build_pipeline([dict(type="LoadImageFromFile",
                                              to_float32=True, cache=True)])
    for i in range(3):
        img = as_float(got.get_raw(i))["img"]
        assert img.dtype == np.float32
        np.testing.assert_array_equal(img, first[i])
    # CorrectBox keeps each tile's corrected gts, and hands out copies
    load = pipelines.build_pipeline(PRE[:2])
    correct = pipelines.CorrectBox(refine_rbbox=True)
    a = correct(load(got.get_raw(1)))["gt_bboxes"]
    a[:] = -1
    b = correct(load(got.get_raw(1)))["gt_bboxes"]
    np.testing.assert_array_equal(
        b, pipelines.CorrectBox(refine_rbbox=True)(
            load(got.get_raw(1)))["gt_bboxes"])
    assert len(correct.corrected) == 1 and (b != -1).all()


def hard_aug_pipeline():
    return load_config(HARD_AUG)["train_pipeline"]


PIPELINE_CASES = {  # steps, device normalize, seeds a tile
    # the hard-aug recipe: mosaic x mixup, HSV, rotation, resize, flip
    "synth_r18_512_hard_aug": (hard_aug_pipeline(), False, 8),
    "synth_r18_512_hard_aug_device_norm": (hard_aug_pipeline(), True, 2),
    # the Swin-T recipe's HSV + rotation after the resize to ~1333 x 1000
    # (no fusion)
    "swin_tiny_demo": (load_config(
        "configs/dota/orientedreppoints_swin_tiny_demo.py")[
            "train_pipeline"], False, 1),
    # PolyMosaic9 feeding MixUp, a rotation that can drop every gt
    "mosaic9_mixup_rotate": ([
        *PRE,
        dict(type="PolyMosaic9", translate=0.1, scale=0.25,
             mosaic_ratio=0.7),
        dict(type="MixUp", mixup_ratio=0.5),
        dict(type="RandomRotate", rate=0.5, auto_bound=True),
        dict(type="RotateResize", img_scale=(256, 256), keep_ratio=True),
        dict(type="Pad", size_divisor=32),
    ], False, 4),
}


@pytest.mark.parametrize("name", list(PIPELINE_CASES))
def test_whole_pipeline_through_datasets_matches_jax(split, name):
    """Every tile through the whole train pipeline via both packages'
    DotaDataset, the fusion steps' extra samples drawn by the datasets'
    getters: equal at each seed (8 for the hard-aug recipe as the JAX
    configs normalize it), and the RandomState left in the same state."""
    steps, device_normalize, seeds = PIPELINE_CASES[name]
    got_ds, ref_ds = datasets(split, steps, device_normalize)
    fused = isinstance(got_ds.pipeline, pipelines.MultiSamplePipeline)
    assert fused == isinstance(ref_ds.pipeline,
                               pipelines_ref.MultiSamplePipeline)
    nones = 0
    for i in range(len(got_ds)):
        for seed in range(seeds):
            rng = np.random.RandomState(7919 * seed + i)
            np.random.set_state(rng.get_state())
            a, b = got_ds.prepare(i, rng), ref_ds[i]
            assert_same(a, b, f"{name}: tile {i} seed {seed}")
            assert rng.randint(1 << 30) == np.random.randint(1 << 30)
            nones += b is None
    assert nones < len(got_ds) * seeds


def test_multi_sample_pipeline_needs_a_getter_and_an_rng(split):
    got_ds, _ = datasets(split, hard_aug_pipeline())
    with pytest.raises(TypeError, match="getter"):
        got_ds.pipeline(got_ds.get_raw(0), np.random.RandomState(0))
    with pytest.raises(ValueError, match="RandomState"):
        got_ds.prepare(0)
    with pytest.raises(ValueError, match="contiguous"):
        pipelines.build_pipeline([*PRE, dict(type="PolyMosaic"),
                                  dict(type="HSVAugment"),
                                  dict(type="MixUp")])


def test_hard_aug_loader_epochs_match_jax(split):
    """The hard-aug pipeline with device normalization through both
    packages' DataLoader (batch 4, canvas 256, max_gt 64): two epochs of
    equal batches, the JAX worker's np.random seeded as the port's
    aug_rng is for each epoch; and a second port loader from the same
    seed gives the same bytes."""
    got_ds, ref_ds = datasets(split, hard_aug_pipeline(), True)
    kw = dict(batch_size=4, canvas_buckets=[(256, 256)], max_gt=64, seed=5)
    ours, again = loader.DataLoader(got_ds, **kw), loader.DataLoader(
        got_ds, **kw)
    theirs = loader_ref.DataLoader(ref_ds, **kw)
    for epoch in range(2):
        np.random.set_state(loader.aug_rng(5, epoch).get_state())
        ref_batches = list(theirs)
        got_batches, again_batches = list(ours), list(again)
        assert len(got_batches) == len(ref_batches) == 3
        for a, b, c in zip(got_batches, ref_batches, again_batches):
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                np.testing.assert_array_equal(a[k], c[k], err_msg=k)
        assert got_batches[0]["images"].dtype == np.uint8

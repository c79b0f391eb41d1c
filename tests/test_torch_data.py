"""The port's synthetic scenes, tiling, COCO-poly json, DotaDataset and
test pipeline against the JAX package's, on the CPU.

The JAX side renders with cv2 and writes PNGs; the port renders with its
own numpy rebuilds of cv2's drawing and writes .npy.  Polygons, names and
labelTxt are equal exactly (the hard scenes' labelTxt too); pixels as
stated in test_render_scene_pixels.  The split, json
and dataset run on the same images (the JAX PNGs, loaded with cv2 and
saved as .npy for the port) and are compared exactly.
"""

import json
import os
import os.path as osp

import cv2
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.data import synth as synth_ref
from orientedreppoints_tpu.devkit import dota_utils as util_ref
from orientedreppoints_tpu.devkit.dota2coco import \
    dota2coco_train as dota2coco_ref
from orientedreppoints_tpu.devkit.img_split import ImgSplit as ImgSplitRef
from orientedreppoints_tpu.utils import builder
from orientedreppoints_tpu_torch import apis
from orientedreppoints_tpu_torch.data import synth
from orientedreppoints_tpu_torch.data.pipelines import build_pipeline
from orientedreppoints_tpu_torch.devkit import img_split
from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train
from orientedreppoints_tpu_torch.host import resize_cubic, resize_cubic_uint8

# measured over the four scenes below: 11 of 786,432 pixels differ, each
# by one grey level, all of them cv2's IPP bicubic (with IPP off the
# scenes are equal bit for bit); the bound leaves room for other seeds


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MIN_SAME_PIXELS = 0.9999
IPP_PIXELS = 11
SCENES = [(0, 256), (1, 256), (2, 256), (10000, 768)]
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)


def test_draw_primitives_match_cv2():
    """The fill, the outline and the bicubic against cv2 on seeded
    shapes, bit for bit (tests/test_torch_synth.py holds every drawing
    primitive against cv2 off the image too)."""
    rng = np.random.default_rng(0)
    for t in range(300):
        if t % 3:
            c = rng.uniform(20, 108, 2)
            pts = synth._rot_rect_poly(c[0], c[1], *rng.uniform(4, 80, 2),
                                       rng.uniform(0, np.pi))
            pts = np.round(np.clip(pts, 2, 125)).astype(np.int32)
        else:  # any quad, convex or not
            pts = rng.integers(2, 126, (4, 2)).astype(np.int32)
        want = np.zeros((128, 128, 3), np.float32)
        got = want.copy()
        cv2.fillPoly(want, [pts], (1.5, 2.5, 3.5))
        synth.fill_poly(got, pts, (1.5, 2.5, 3.5))
        np.testing.assert_array_equal(got, want)
        outline = np.zeros((128, 128, 3), np.float32)
        synth.polylines(outline, pts, (1.0, 1.0, 1.0))
        want = np.zeros((128, 128, 3), np.float32)
        cv2.polylines(want, [pts], True, (1.0, 1.0, 1.0), 1)
        np.testing.assert_array_equal(outline, want)
    base = rng.random((25, 1)).astype(np.float32)
    np.testing.assert_array_equal(  # one column: no sum order to differ
        resize_cubic(base[:, :, None], (768, 1))[:, 0, 0],
        cv2.resize(base, (1, 768), interpolation=cv2.INTER_CUBIC)[:, 0])
    base = rng.random((25, 25, 3)).astype(np.float32)
    ipp = cv2.ipp.useIPP()
    try:  # OpenCV's own loops, which resize_cubic follows bit for bit
        cv2.ipp.setUseIPP(False)
        want = cv2.resize(base, (768, 768), interpolation=cv2.INTER_CUBIC)
    finally:
        cv2.ipp.setUseIPP(ipp)
    np.testing.assert_array_equal(resize_cubic(base, (768, 768)), want)


def scene_pair(seed, size):
    a, objs_a = synth_ref.render_scene(np.random.RandomState(seed), size=size)
    b, objs_b = synth.render_scene(np.random.RandomState(seed), size=size)
    return a, objs_a, b, objs_b


@pytest.mark.parametrize("seed, size", SCENES)
def test_render_scene_objects_equal(seed, size):
    _, objs_a, img, objs_b = scene_pair(seed, size)
    assert img.shape == (size, size, 3) and img.dtype == np.uint8
    assert len(objs_a) == len(objs_b) >= 10
    for a, b in zip(objs_a, objs_b):
        assert a["name"] == b["name"] and a["difficult"] == b["difficult"]
        np.testing.assert_array_equal(a["poly"], b["poly"])


def test_render_scene_pixels():
    """At most IPP_PIXELS pixels differ, each by one grey level, and none
    with cv2's IPP off."""
    same = total = 0
    ipp = cv2.ipp.useIPP()
    for seed, size in SCENES:
        a, objs, b, _ = scene_pair(seed, size)
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(-1)
        assert diff.max() <= 1
        same += int((diff == 0).sum())
        total += diff.size
        try:
            cv2.ipp.setUseIPP(False)
            a, _, b, _ = scene_pair(seed, size)
        finally:
            cv2.ipp.setUseIPP(ipp)
        np.testing.assert_array_equal(a, b)
    assert same / total >= MIN_SAME_PIXELS, same / total
    assert total - same <= IPP_PIXELS, total - same


def test_generate_synth_dota_files(tmp_path):
    names_ref = synth_ref.generate_synth_dota(str(tmp_path / "ref"), 3,
                                              size=256, seed=5, prefix="V")
    names = synth.generate_synth_dota(str(tmp_path / "port"), 3, size=256,
                                      seed=5, prefix="V")
    assert names == names_ref == ["V0000", "V0001", "V0002"]
    for n in names:
        lab = (tmp_path / "port" / "labelTxt" / f"{n}.txt").read_bytes()
        assert lab == (tmp_path / "ref" / "labelTxt" / f"{n}.txt").read_bytes()
        img = np.load(tmp_path / "port" / "images" / f"{n}.npy")
        ref = cv2.imread(str(tmp_path / "ref" / "images" / f"{n}.png"))
        assert img.shape == ref.shape and img.dtype == ref.dtype
        assert (img != ref).any(-1).mean() < 1 - MIN_SAME_PIXELS
    # the hard scenes (HARD_RENDER_KWARGS): the same labels byte for byte
    names_ref = synth_ref.generate_synth_dota(str(tmp_path / "hard_ref"), 2,
                                              size=256, seed=7, prefix="H",
                                              hard=True)
    names = synth.generate_synth_dota(str(tmp_path / "hard"), 2, size=256,
                                      seed=7, prefix="H", hard=True)
    assert names == names_ref
    for n in names:
        lab = (tmp_path / "hard" / "labelTxt" / f"{n}.txt").read_bytes()
        assert lab == (tmp_path / "hard_ref" / "labelTxt"
                       / f"{n}.txt").read_bytes()
        assert lab.count(b"\n") >= 10


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The JAX package's scenes (PNG) and the same pixels as .npy: three
    256^2 scenes and one 768^2."""
    root = tmp_path_factory.mktemp("scenes")
    for seed, size in ((0, 256), (10000, 768)):
        synth_ref.generate_synth_dota(str(root / "ref"), 3 if size == 256
                                      else 1, size=size, seed=seed,
                                      prefix=f"S{size}_")
    os.makedirs(root / "port" / "images")
    os.makedirs(root / "port" / "labelTxt")
    for p in util_ref.list_files(str(root / "ref" / "images"), ".png"):
        n = util_ref.basename_noext(p)
        np.save(root / "port" / "images" / f"{n}.npy", cv2.imread(p))
        (root / "port" / "labelTxt" / f"{n}.txt").write_bytes(
            (root / "ref" / "labelTxt" / f"{n}.txt").read_bytes())
    return root


@pytest.fixture(scope="module", params=[(512, 256), (200, 100)],
                ids=["tiles512", "tiles200"])
def split(scenes, request):
    subsize, gap = request.param
    out = scenes / f"split{subsize}"
    ImgSplitRef(str(scenes / "ref"), str(out / "ref"), gap=gap,
                subsize=subsize, num_process=1).splitdata()
    img_split.ImgSplit(str(scenes / "port"), str(out / "port"), gap=gap,
                       subsize=subsize, ext=".npy", num_process=1).splitdata()
    dota2coco_ref(str(out / "ref"), str(out / "ref.json"))
    dota2coco_train(str(out / "port"), str(out / "port.json"), ext=".npy")
    return out, subsize


def test_img_split_tiles_and_labels_equal(split):
    out, subsize = split
    pngs = util_ref.list_files(str(out / "ref" / "images"), ".png")
    npys = util_ref.list_files(str(out / "port" / "images"), ".npy")
    assert [util_ref.basename_noext(p) for p in pngs] == \
        [util_ref.basename_noext(p) for p in npys]
    # 256^2 scenes: one padded 512 tile, or 2 x 2 of 200; the 768^2 one
    # 2 x 2 of 512, or 7 x 7 of 200
    assert len(npys) == (3 + 4 if subsize == 512 else 3 * 4 + 49)
    for png, npy in zip(pngs, npys):
        tile = np.load(npy)
        assert tile.shape == (subsize, subsize, 3)
        np.testing.assert_array_equal(tile, cv2.imread(png))
    labels = util_ref.list_files(str(out / "ref" / "labelTxt"), ".txt")
    assert len(labels) == len(pngs)
    difficult2 = 0
    for lab in labels:
        got = (out / "port" / "labelTxt" / osp.basename(lab)).read_bytes()
        assert got == open(lab, "rb").read()
        difficult2 += got.count(b" 2\n")
    assert difficult2 > 0  # clipped instances were relabelled


def test_img_split_refuses_other_rates(scenes, tmp_path):
    """Rates other than 1 are ported (tests/test_torch_image_io.py holds
    them against JAX): a scene at rate 0.5 gives the tiles of its cubic
    resize.  Split scenes are read through image_io, which refuses other
    extensions."""
    s = img_split.ImgSplit(str(scenes / "port"), str(tmp_path), gap=100,
                           subsize=200, ext=".npy", num_process=1)
    s.split_single("S256_0000", 0.5)
    tile = np.load(tmp_path / "images" / "S256_0000__0.5__0___0.npy")
    half = resize_cubic_uint8(np.load(scenes / "port" / "images"
                                      / "S256_0000.npy"), 0.5)
    np.testing.assert_array_equal(tile[:128, :128], half)
    assert not tile[128:].any() and not tile[:, 128:].any()
    (tmp_path / "jpg" / "images").mkdir(parents=True)
    (tmp_path / "jpg" / "images" / "a.jpg").write_bytes(b"")
    with pytest.raises(ValueError, match=".jpg"):
        img_split.ImgSplit(str(tmp_path / "jpg"), str(tmp_path / "o"),
                           ext=".jpg", num_process=1).splitdata()


def test_dota2coco_json_equal(split):
    out, _ = split
    got = json.loads((out / "port.json").read_text())
    ref = json.loads((out / "ref.json").read_text())
    assert len(got["images"]) == len(ref["images"]) > 0
    for a, b in zip(got["images"], ref["images"]):
        assert a.pop("file_name") == b.pop("file_name")[:-4] + ".npy"
    assert got == ref
    assert len(got["annotations"]) > 20


def test_reduce_poly5_and_best_point_order_match():
    from orientedreppoints_tpu.devkit import img_split as split_ref

    rng = np.random.default_rng(1)
    for _ in range(50):
        p5 = rng.uniform(0, 100, (5, 2))
        np.testing.assert_array_equal(img_split.reduce_poly5_to_poly4(p5),
                                      split_ref.reduce_poly5_to_poly4(p5))
        p4, r4 = rng.uniform(0, 100, (4, 2)), rng.uniform(0, 100, (4, 2))
        np.testing.assert_array_equal(img_split.best_point_order(p4, r4),
                                      split_ref.best_point_order(p4, r4))


def pipeline(scale):
    return [dict(type="LoadImageFromFile"),
            dict(type="RotateResize", img_scale=scale, keep_ratio=True),
            dict(type="Normalize", **NORM),
            dict(type="Pad", size_divisor=32)]


@pytest.mark.parametrize("scale", [(512, 512), (300, 300)],
                         ids=["scale512", "scale300"])
def test_dota_dataset_and_test_pipeline_equal(split, scale):
    """anns, img_infos and each item's normalized image and scale factor;
    512^2 tiles at scale 512 do not resize, the others do (up or down)."""
    out, subsize = split
    ds = apis.build_dataset(dict(
        type="DotaDataset", ann_file=str(out / "port.json"),
        img_prefix=str(out / "port" / "images"), pipeline=pipeline(scale),
        test_mode=True))
    ref = builder.build_dataset(dict(
        type="DotaDataset", ann_file=str(out / "ref.json"),
        img_prefix=str(out / "ref" / "images"), pipeline=pipeline(scale),
        test_mode=True))
    assert len(ds) == len(ref) > 0
    assert ds.CLASSES == ref.CLASSES
    np.testing.assert_array_equal(ds.flag, ref.flag)
    for a, b in zip(ds.img_infos, ref.img_infos):
        assert dict(a, file_name=None) == dict(b, file_name=None)
    for a, b in zip(ds.anns, ref.anns):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    resized = 0
    for i in range(len(ds)):
        got, want = ds[i], ref[i]
        assert got["scale_factor"] == want["scale_factor"]
        assert got["img_shape"] == want["img_shape"]
        assert got["img"].dtype == want["img"].dtype == np.float32
        np.testing.assert_array_equal(got["img"], want["img"])
        resized += got["scale_factor"] != 1.0
    assert resized == (0 if subsize == scale[0] else len(ds))


def test_train_filter_and_refusals(split, tmp_path):
    """Outside test_mode tiles without annotations are dropped, as in the
    JAX dataset; JPEGs and the untranslated transforms are refused."""
    out, _ = split
    from orientedreppoints_tpu.data.dota import DotaDataset as DotaRef
    from orientedreppoints_tpu_torch.data.dota import DotaDataset

    got, ref = DotaDataset(str(out / "port.json")), DotaRef(
        str(out / "ref.json"))
    assert len(got) == len(ref)
    assert [i["id"] for i in got.img_infos] == [i["id"] for i in ref.img_infos]
    load = build_pipeline([dict(type="LoadImageFromFile")])
    with pytest.raises(ValueError, match=".npy"):
        load(dict(img_info=dict(file_name="a.jpg"), img_prefix=""))
    # every JAX step is ported (Corrupt last); mmdet's test-time wrapper
    # is in neither package
    with pytest.raises(NotImplementedError, match="MultiScaleFlipAug"):
        build_pipeline([dict(type="MultiScaleFlipAug")])
    with pytest.raises(ValueError, match="multiscale_mode"):
        build_pipeline([dict(type="RotateResize",
                             img_scale=[(512, 512), (768, 768)],
                             multiscale_mode="ranges")])

"""The port's image corruptions (data/corruptions.py, data/filter.py, the
float32 warp of data/warp.py, the Corrupt stage) against the JAX
package's cv2-based ones and against cv2 5.0 itself, on the CPU.

Every comparison is exact but one: a filter2D kernel of 130 taps or more
(motion_blur at severity 4 and 5: 13^2 and 17^2) takes cv2's DFT path,
whose float32 rounding the port's direct sum does not copy.  There, at
most DFT_SHARE of the values may differ, each by one grey level (seen:
8-17 of 786,432 on 512^2 images).  chip_smoke.py's 27 digests are
recomputed here from the JAX package's live output.
"""

import hashlib
import importlib.util
import os

import cv2
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.data import corruptions as ref
from orientedreppoints_tpu.devkit.dota2coco import dota2coco_train as \
    dota2coco_ref
from orientedreppoints_tpu.utils import builder
from orientedreppoints_tpu_torch import apis
from orientedreppoints_tpu_torch.data import corruptions, warp
from orientedreppoints_tpu_torch.data import filter as cvf
from orientedreppoints_tpu_torch.data.pipelines import build_pipeline
from orientedreppoints_tpu_torch.devkit.dota2coco import dota2coco_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = [(c, s) for c in corruptions.CORRUPTIONS for s in (1, 3, 5)]
DFT_SHARE = 5e-5  # of the values, one grey level each (cv2's DFT path)
DFT_TAPS = 130  # cv2's filter2D of uint8 goes by DFT from kw * kh taps on


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite runs files side by side in worker
    processes, and torch's default pool oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def textured(h, w, seed):
    """A cv2 bicubic blow-up of a coarse random grid under noise."""
    rng = np.random.RandomState(seed)
    coarse = rng.randint(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.uint8)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(img.astype(np.int64) + rng.randint(-20, 21, img.shape),
                   0, 255).astype(np.uint8)


def motion_kernel(c, angle):
    k = np.zeros((c, c), np.float32)
    k[c // 2] = 1.0 / c
    m = cv2.getRotationMatrix2D((c / 2 - 0.5, c / 2 - 0.5), angle, 1)
    return cv2.warpAffine(k, m, (c, c))


def assert_within_dft_bound(got, want):
    diff = np.abs(got.astype(np.int64) - want)
    assert diff.max() <= 1
    assert (diff != 0).sum() <= DFT_SHARE * diff.size, (diff != 0).sum()


@pytest.mark.parametrize("ksize", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                                   (3, 5), (6, 4), (10, 7)])
def test_structuring_element_ellipse(ksize):
    size = ksize if isinstance(ksize, tuple) else (ksize, ksize)
    np.testing.assert_array_equal(
        cvf.get_structuring_element_ellipse(ksize),
        cv2.getStructuringElement(cv2.MORPH_ELLIPSE, size))


@pytest.mark.parametrize("c", [3, 4, 6, 8, 10])
def test_filter2d_defocus_kernels(c):
    """defocus_blur's normalized ellipses (even sizes: the anchor off
    centre) on an odd-sized image: bit for bit."""
    k = cvf.get_structuring_element_ellipse(c).astype(np.float32)
    k /= k.sum()
    img = textured(67, 91, seed=c)
    np.testing.assert_array_equal(cvf.filter2d(img, k),
                                  cv2.filter2D(img, -1, k))


@pytest.mark.parametrize("c", [5, 7, 9, 13, 17])
def test_filter2d_motion_kernels(c):
    """motion_blur's rotated lines: bit for bit below cv2's DFT threshold
    (5, 7, 9), within DFT_SHARE above it (13, 17); also a one-channel
    image."""
    k = motion_kernel(c, 23.7)
    k /= k.sum()
    for img in (textured(256, 256, seed=c), textured(73, 55, seed=c)[..., 0]):
        got, want = cvf.filter2d(img, k), cv2.filter2D(img, -1, k)
        if c * c < DFT_TAPS:
            np.testing.assert_array_equal(got, want)
        else:
            assert_within_dft_bound(got, want)


@pytest.mark.parametrize("c", [5, 7, 9, 13, 17])
def test_warp_affine_float_kernel(c):
    """cv2.warpAffine of motion_blur's float32 one-channel kernel at 40
    seeded angles: bit for bit (the fused lerps of data/warp.py)."""
    for ang in np.random.RandomState(c).uniform(-45, 45, 40):
        k = np.zeros((c, c), np.float32)
        k[c // 2] = 1.0 / c
        m = warp.get_rotation_matrix_2d((c / 2 - 0.5, c / 2 - 0.5), ang, 1)
        got = warp.warp_affine(k, m, (c, c))
        want = cv2.warpAffine(k, m, (c, c))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("size", [(512, 512), (389, 517), (37, 10), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pixelate_resizes(size):
    """INTER_AREA at pixelate's scales (0.5 on an even size takes the 2x
    fast path) and INTER_NEAREST back: bit for bit."""
    h, w = size
    img = textured(max(h, 8), max(w, 8), seed=h)[:h, :w]
    for c in (0.9, 0.8, 0.7, 0.6, 0.5):
        dsize = (max(int(w * c), 1), max(int(h * c), 1))
        small = cvf.resize_area(img, dsize)
        np.testing.assert_array_equal(
            small, cv2.resize(img, dsize, interpolation=cv2.INTER_AREA))
        np.testing.assert_array_equal(
            cvf.resize_nearest(small, (w, h)),
            cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST))


def test_pixelate_resizes_small_sizes():
    """Every size up to 12 x 12 at pixelate's scales: the generic table,
    the 2x fast path and the other integer scales (e.g. 3 x 6 -> 1 x 3)."""
    rng = np.random.RandomState(4)
    for h in range(1, 13):
        for w in range(1, 13):
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for c in (0.9, 0.8, 0.7, 0.6, 0.5):
                dsize = (max(int(w * c), 1), max(int(h * c), 1))
                np.testing.assert_array_equal(
                    cvf.resize_area(img, dsize),
                    cv2.resize(img, dsize, interpolation=cv2.INTER_AREA),
                    err_msg=f"{h} x {w} at {c}")


@pytest.mark.parametrize("setting", SETTINGS,
                         ids=[f"{c}@{s}" for c, s in SETTINGS])
def test_corrupt_matches_jax(setting):
    """Each corruption at severities 1, 3, 5 on a 256 x 320 image with
    equal RandomStates: the JAX package's cv2 output exactly (motion_blur
    at 5: within DFT_SHARE), and the RandomState left in the same state."""
    name, sev = setting
    img = textured(256, 320, seed=sev)
    rng_a, rng_b = np.random.RandomState(11), np.random.RandomState(11)
    got = corruptions.corrupt(img, name, sev, rng_a)
    want = ref.corrupt(img, name, sev, rng_b)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    if (name, sev) == ("motion_blur", 5):
        assert_within_dft_bound(got, want)
    else:
        np.testing.assert_array_equal(got, want)
    assert rng_a.randint(1 << 30) == rng_b.randint(1 << 30)


def test_corrupt_draws_from_global_state_without_rng():
    """rng=None draws from the global np.random, as in JAX."""
    img = textured(64, 64, seed=1)
    for name in ("gaussian_noise", "shot_noise", "impulse_noise",
                 "motion_blur"):
        np.random.seed(5)
        want = ref.corrupt(img, name, 3)
        np.random.seed(5)
        np.testing.assert_array_equal(corruptions.corrupt(img, name, 3),
                                      want)


def test_smoke_digests_are_jax_output(smoke):
    """chip_smoke.CORRUPT_DIGESTS: the SHA-256 of the JAX package's
    corruption of the smoke's probe image for every setting, but for the
    DFT-path one, which holds the port's digest and the bound."""
    img = smoke.corruption_probe()
    digests, _ = smoke.corruption_digests(reps=1)
    assert digests == smoke.CORRUPT_DIGESTS
    assert len(digests) == 27
    for key, digest in smoke.CORRUPT_DIGESTS.items():
        name, sev = key.split("@")
        want = ref.corrupt(img, name, int(sev), np.random.RandomState(
            smoke.CORRUPT_RNG_SEED))
        live = hashlib.sha256(np.ascontiguousarray(want)).hexdigest()
        if key in smoke.CORRUPT_DFT_PATH:
            assert live != digest
            assert_within_dft_bound(corruptions.corrupt(
                img, name, int(sev), np.random.RandomState(
                    smoke.CORRUPT_RNG_SEED)), want)
        else:
            assert live == digest, key


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    """Three 128^2 PNG tiles with a labelTxt each, and both packages'
    COCO-poly json of them."""
    root = tmp_path_factory.mktemp("corrupt")
    os.makedirs(root / "images")
    os.makedirs(root / "labelTxt")
    for i in range(3):
        cv2.imwrite(str(root / "images" / f"t{i}.png"),
                    textured(128, 128, seed=20 + i))
        (root / "labelTxt" / f"t{i}.txt").write_text(
            "10 10 60 10 60 40 10 40 plane 0\n")
    dota2coco_ref(str(root), str(root / "ref.json"))
    dota2coco_train(str(root), str(root / "port.json"), ext=".png")
    return root


@pytest.mark.parametrize("name", list(corruptions.CORRUPTIONS))
def test_corrupt_stage_in_dataset_matches_jax(tiles, name):
    """The Corrupt stage right after the load in both packages' datasets:
    the same file names hash to the same per-image RandomState in one
    process, so each item's normalized image is equal."""
    def pipeline(sev):
        return [dict(type="LoadImageFromFile"),
                dict(type="Corrupt", corruption=name, severity=sev),
                dict(type="RotateResize", img_scale=(128, 128)),
                dict(type="Normalize", mean=[123.675, 116.28, 103.53],
                     std=[58.395, 57.12, 57.375], to_rgb=True),
                dict(type="Pad", size_divisor=32)]

    for sev in (0, 3):
        ds = apis.build_dataset(dict(
            type="DotaDataset", ann_file=str(tiles / "port.json"),
            img_prefix=str(tiles / "images"), pipeline=pipeline(sev),
            test_mode=True))
        want = builder.build_dataset(dict(
            type="DotaDataset", ann_file=str(tiles / "ref.json"),
            img_prefix=str(tiles / "images"), pipeline=pipeline(sev),
            test_mode=True))
        assert len(ds) == len(want) == 3
        for i in range(3):
            got, exp = ds[i], want[i]
            assert got["filename"] == exp["filename"]
            np.testing.assert_array_equal(got["img"], exp["img"])
        # the same item twice: the same corruption
        np.testing.assert_array_equal(ds[0]["img"], ds[0]["img"])


def test_corrupt_stage_passes_severity_zero_and_refuses_unknown():
    img = textured(32, 32, seed=2)
    out = build_pipeline([dict(type="Corrupt", corruption="contrast",
                               severity=0)])(dict(img=img, filename="a"))
    assert out["img"] is img
    with pytest.raises(ValueError, match="fog"):
        build_pipeline([dict(type="Corrupt", corruption="fog")])

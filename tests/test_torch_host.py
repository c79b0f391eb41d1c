"""The PyTorch port's host helpers against the JAX package's host code:
config loading, keep-ratio resize, Normalize and rbbox2result."""

import numpy as np
import pytest
import torch

from orientedreppoints_tpu.core.rbox import rbbox2result as rbbox2result_ref
from orientedreppoints_tpu.data.pipelines import Normalize as NormalizeRef
from orientedreppoints_tpu.data.pipelines import RotateResize
from orientedreppoints_tpu.utils.config import Config
from orientedreppoints_tpu_torch import host


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape, scale", [
    *[(shape, scale) for shape in ((200, 260), (130, 97), (64, 64))
      for scale in ((128, 96), (1333, 1024), (100, 50))],
    ((1000, 1000), (500, 500)),  # exact 2x downscale: cv2 takes INTER_AREA
    ((1023, 767), (1333, 1024)),  # the demo config's test scale, upscale
    ((1, 37), (100, 50)),  # one source row: both vertical taps clamp to it
    ((37, 1), (100, 50)),  # one source column
    ((2, 3), (700, 600)),  # every output pixel in a 1-pixel border
])
def test_imrescale_matches_rotate_resize(shape, scale):
    rng = np.random.RandomState(0)
    img = (rng.rand(*shape, 3) * 255).astype(np.uint8)
    ref = RotateResize(img_scale=scale, keep_ratio=True)(
        {"img": img, "img_shape": img.shape, "bbox_fields": []})
    out, factor = host.imrescale(torch.from_numpy(img), scale)
    # size and factor arithmetic, and cv2's fixed-point uint8 taps: exact
    assert tuple(out.shape) == ref["img"].shape
    assert factor == ref["scale_factor"]
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), ref["img"])


def test_normalize_matches():
    rng = np.random.RandomState(1)
    img = (rng.rand(37, 41, 3) * 255).astype(np.uint8)
    mean, std = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]
    for to_rgb in (True, False):
        ref = NormalizeRef(mean, std, to_rgb)({"img": img})["img"]
        out = host.Normalize(mean, std, to_rgb)(torch.from_numpy(img))
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [0, 25])
def test_rbbox2result_matches(n):
    rng = np.random.RandomState(2)
    dets = rng.rand(n, 9).astype(np.float32)
    labels = rng.randint(0, 15, n)
    ref = rbbox2result_ref(dets, labels, 16)
    out = host.rbbox2result(dets, labels, 16)
    assert len(out) == len(ref) == 15
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def test_load_config_matches():
    path = "configs/dota/orientedreppoints_r50_demo.py"
    ref = Config.fromfile(path)
    cfg = host.load_config(path)
    for key in ("model", "test_cfg", "img_norm_cfg", "data", "tpu"):
        assert cfg[key] == ref.get(key)
    assert cfg["model"]["bbox_head"]["num_classes"] == 16

"""The port's JPEG round trip (data/jpeg.py) against cv2 5.0's own
(libjpeg-turbo 3.1), on the CPU.

cv2.imdecode(cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, q])[1],
IMREAD_COLOR) and jpeg.round_trip(img, q) on the same seeded uint8 BGR
images: textured (the jpeg_compression corruption's qualities 80, 65, 58,
50 and 40 at four sizes, two not multiples of 8 or 16), noise and flat
extremes (every quality class, the quantiser's power-of-two and clamped
tables) and the sizes where libjpeg-turbo upsamples chroma by plain
replication (at most 4 columns).  Every comparison is exact.
"""

import cv2
import numpy as np
import pytest

from orientedreppoints_tpu_torch.data import jpeg

SIZES = [(512, 512), (389, 517), (64, 48), (37, 53)]
QUALITIES = [80, 65, 58, 50, 40]


def textured(h, w, seed=0):
    """Smooth colour fields (a bilinear blow-up of a coarse grid) under
    noise: both the flat blocks and the edges a JPEG quantises."""
    rng = np.random.RandomState(seed)
    coarse = rng.randint(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(
        np.float64)
    ys = np.linspace(0, coarse.shape[0] - 1, h)
    xs = np.linspace(0, coarse.shape[1] - 1, w)
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, coarse.shape[0] - 1)
    x1 = np.minimum(x0 + 1, coarse.shape[1] - 1)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    img = ((1 - fy) * ((1 - fx) * coarse[y0][:, x0] + fx * coarse[y0][:, x1])
           + fy * ((1 - fx) * coarse[y1][:, x0] + fx * coarse[y1][:, x1]))
    img += rng.randint(-20, 21, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def cv2_round_trip(img, quality):
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return cv2.imdecode(buf, cv2.IMREAD_COLOR)


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_round_trip_matches_cv2(size, quality):
    img = textured(*size, seed=size[0] + quality)
    got = jpeg.round_trip(img, quality)
    assert got.shape == img.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, cv2_round_trip(img, quality))


@pytest.mark.parametrize("kind", ["noise", "white", "black", "stripes"])
def test_round_trip_extremes_at_every_quality_class(kind):
    """Full-range noise (the IDCT's range limit), flat white and black,
    and 1-px stripes, at qualities 1 (tables clamped to 255), 25, 50, 75
    and 100 (tables of 1: the quantiser's power-of-two branch)."""
    rng = np.random.RandomState(3)
    img = {"noise": rng.randint(0, 256, (45, 61, 3)),
           "white": np.full((45, 61, 3), 255),
           "black": np.zeros((45, 61, 3))}.get(kind)
    if img is None:
        img = np.zeros((45, 61, 3))
        img[:, ::2] = 255
        img[::3, :, 1] = 0
    img = img.astype(np.uint8)
    for quality in (1, 25, 50, 75, 100):
        np.testing.assert_array_equal(jpeg.round_trip(img, quality),
                                      cv2_round_trip(img, quality),
                                      err_msg=f"quality {quality}")


def test_round_trip_small_sizes():
    """Every size up to 19 x 19: partial blocks and MCUs, chroma planes
    of 1 or 2 columns (replicated, not fancy-upsampled) and of 1 row."""
    rng = np.random.RandomState(5)
    for h in range(1, 20):
        for w in range(1, 20):
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            np.testing.assert_array_equal(jpeg.round_trip(img, 80),
                                          cv2_round_trip(img, 80),
                                          err_msg=f"{h} x {w}")


def test_quant_table_and_refusals():
    """jpeg_set_quality's scaling: 50 keeps Annex K, 100 gives ones;
    non-uint8 or non-BGR input is refused."""
    assert jpeg.quant_table(50)[0, 0] == 16
    assert jpeg.quant_table(50, chroma=True)[0, 0] == 17
    assert (jpeg.quant_table(100) == 1).all()
    assert (jpeg.quant_table(1) == 255).all()
    with pytest.raises(TypeError):
        jpeg.round_trip(np.zeros((8, 8, 3), np.float32), 80)
    with pytest.raises(TypeError):
        jpeg.round_trip(np.zeros((8, 8), np.uint8), 80)

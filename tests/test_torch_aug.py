"""data/warp.py and data/color.py against cv2 5.0 on the CPU, bit for bit:
the rotation matrix and both inverses exactly, warpAffine and
warpPerspective (INTER_LINEAR, BORDER_CONSTANT) on seeded uint8 images
and matrices, BGR2HSV on all 2^24 triples and HSV2BGR on all 2^24 (the
11,796,480 with hue < 180 among them), through cv2's vector columns and
its scalar tail; and the emulated fma against exact rational arithmetic.
Each image comparison runs with IPP on and off.
"""

from fractions import Fraction

import cv2
import numpy as np
import pytest
import torch

from orientedreppoints_tpu_torch.data import color, warp


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite runs files side by side in worker
    processes, and torch's default pool oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(params=[True, False], ids=["ipp", "no_ipp"])
def ipp(request):
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(request.param)
    yield request.param
    cv2.ipp.setUseIPP(before)


def test_rotation_matrix_and_inverses_equal_cv2():
    rng = np.random.RandomState(0)
    angles = [0, 90, -90, 180, -180, 45, 30, 1e-9]
    for i in range(400):
        angle = angles[i] if i < len(angles) else rng.uniform(-180, 180)
        center = (rng.uniform(0, 600), rng.uniform(0, 600)) if i % 3 else (
            rng.randint(0, 600) / 2.0, rng.randint(0, 600) / 2.0)
        scale = rng.uniform(0.5, 1.5) if i % 2 else 1.0
        m = warp.get_rotation_matrix_2d(center, angle, scale)
        np.testing.assert_array_equal(
            m, cv2.getRotationMatrix2D(center, angle, scale))
        m[:, 2] += rng.uniform(-50, 50, 2)
        np.testing.assert_array_equal(warp.invert_affine(m),
                                      cv2.invertAffineTransform(m))
        p = np.vstack([m, [rng.uniform(-1e-3, 1e-3),
                           rng.uniform(-1e-3, 1e-3), 1.0]])
        ok, want = cv2.invert(p)
        assert ok
        np.testing.assert_array_equal(warp.invert_perspective(p), want)


def fma_exact(a, b, c):
    """float32 of the exact a * b + c, rounded to nearest even."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    lo = np.float32(float(exact))  # one of the two neighbours
    cands = [lo, np.nextafter(lo, np.float32(-np.inf)),
             np.nextafter(lo, np.float32(np.inf))]
    dist = [abs(Fraction(float(x)) - exact) for x in cands]
    best = min(dist)
    ties = [x for x, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda x: int(np.float32(x).view(np.int32)) & 1)


def test_fma32_rounds_once():
    """Random triples, and triples whose float64 sum is a float32
    midpoint (where rounding twice goes wrong), against Fractions."""
    rng = np.random.RandomState(1)
    a = rng.uniform(-2, 2, 3000).astype(np.float32)
    b = (rng.uniform(-300, 300, 3000)
         * 2.0 ** rng.randint(-30, 4, 3000)).astype(np.float32)
    c = rng.uniform(-300, 300, 3000).astype(np.float32)
    # exact sums just below a float32 midpoint that float64 rounds onto
    # it: c = 2^e (2^24 + 2 (2j + 1)) (odd mantissa), a * b = 2^e (1 -
    # m^2 2^-46); rounding twice goes to c + 2^(e+1), once to c
    n = 1000
    e = 2.0 ** rng.randint(-20, 20, n)
    sign = rng.choice([-1.0, 1.0], n)
    m = rng.randint(1, 100, n)
    c[:n] = sign * e * (2.0 ** 24 + 2 * (2 * rng.randint(0, 1 << 20, n) + 1))
    a[:n] = 1 + m * 2.0 ** -23
    b[:n] = sign * e * (1 - m * 2.0 ** -23)
    got = warp.fma32(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(c)).numpy()
    want = np.array([fma_exact(x, y, z) for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got, want)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive != want).sum() > 0  # the midpoint cases are exercised


def affine_cases():
    """(image, matrix, dsize, border) cases: rotations about the centre
    at 0, +/-90, 180 and random angles, scales 0.75-1.25 with offsets,
    PolyRandomRotate's auto_bound canvases, PolyMosaic's 1024^2 -> 512^2
    affine crop, and output widths with and without a scalar tail."""
    rng = np.random.RandomState(2)
    cases = []
    for i in range(40):
        h, w = rng.randint(3, 300, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        if i % 5 == 0:  # flat regions and hard edges
            img = (img // 85 * 85).astype(np.uint8)
        angle = ([0, 90, -90, 180][i] if i < 4
                 else rng.uniform(-180, 180))
        scale = 1.0 if i < 8 else rng.uniform(0.75, 1.25)
        m = warp.get_rotation_matrix_2d((w / 2.0, h / 2.0), angle, scale)
        dsize = (w, h)
        if i % 4 == 1:  # auto_bound, as PolyRandomRotate computes it
            rad = np.deg2rad(angle)
            bw = int(np.rint(h * abs(np.sin(rad)) + w * abs(np.cos(rad))))
            bh = int(np.rint(h * abs(np.cos(rad)) + w * abs(np.sin(rad))))
            m[0, 2] += bw / 2.0 - w / 2.0
            m[1, 2] += bh / 2.0 - h / 2.0
            dsize = (bw, bh)
        elif i % 4 == 2:
            m[:, 2] += rng.uniform(-40, 40, 2)
            dsize = tuple(rng.randint(1, 320, 2))
        cases.append((img, m, dsize, [0, 114][i % 2]))
    for i in range(3):  # the mosaic's crop of a 1024^2 canvas
        img = rng.randint(0, 256, (1024, 1024, 3)).astype(np.uint8)
        c = np.eye(3)
        c[:2, 2] = -512
        r = np.eye(3)
        r[:2] = warp.get_rotation_matrix_2d((0, 0), 0.0,
                                            rng.uniform(0.75, 1.25))
        t = np.eye(3)
        t[:2, 2] = rng.uniform(0.4, 0.6, 2) * 512
        cases.append((img, (t @ r @ c)[:2], (512, 512), 114))
    return cases


def test_warp_affine_equals_cv2(ipp):
    n = 0
    for img, m, dsize, border in affine_cases():
        want = cv2.warpAffine(img, m, dsize, borderValue=(border,) * 3)
        got = warp.warp_affine(img, m, dsize, border)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        n += want.size
    assert n > 3_000_000


def test_warp_perspective_equals_cv2(ipp):
    """The yolo-style matrices of PolyMosaic with a perspective term."""
    rng = np.random.RandomState(3)
    for i in range(30):
        h, w = rng.randint(8, 300, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        c = np.eye(3)
        c[0, 2], c[1, 2] = -w / 2, -h / 2
        p = np.eye(3)
        p[2, :2] = rng.uniform(-1e-3, 1e-3, 2)
        r = np.eye(3)
        r[:2] = warp.get_rotation_matrix_2d((0, 0), rng.uniform(-30, 30),
                                            rng.uniform(0.75, 1.25))
        t = np.eye(3)
        t[0, 2], t[1, 2] = rng.uniform(0.4, 0.6) * w, rng.uniform(0.4, 0.6) * h
        m = t @ r @ p @ c
        dsize = tuple(rng.randint(1, 320, 2)) if i % 2 else (w, h)
        border = [0, 114][i % 2]
        want = cv2.warpPerspective(img, m, dsize, borderValue=(border,) * 3)
        np.testing.assert_array_equal(
            warp.warp_perspective(img, m, dsize, border), want)


def test_warps_refuse_other_images():
    with pytest.raises(TypeError, match="uint8"):
        warp.warp_affine(np.zeros((4, 4, 3), np.float32), np.eye(2, 3),
                         (4, 4))
    with pytest.raises(TypeError, match="uint8"):
        color.bgr_to_hsv(np.zeros((4, 4), np.uint8))


def all_triples():
    """Every (c0, c1, c2) uint8 triple, c0 slowest, as (2^24, 3)."""
    a = np.arange(256, dtype=np.uint8)
    return np.stack(np.meshgrid(a, a, a, indexing="ij"), -1).reshape(-1, 3)


def test_bgr_to_hsv_equals_cv2_on_every_triple():
    img = all_triples().reshape(4096, 4096, 3)
    np.testing.assert_array_equal(color.bgr_to_hsv(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2HSV))


@pytest.mark.parametrize("width", [4096, 31], ids=["vector", "scalar_tail"])
def test_hsv_to_bgr_equals_cv2_on_every_triple(width):
    """All 2^24 HSV triples in rows of 4096 (cv2's vector loop only) and
    in rows of 31 (its scalar tail only, the last row padded)."""
    triples = all_triples()
    assert (triples[:, 0] < 180).sum() == 11_796_480
    pad = (-len(triples)) % width
    img = np.concatenate([triples, triples[:pad]]).reshape(-1, width, 3)
    np.testing.assert_array_equal(color.hsv_to_bgr(img),
                                  cv2.cvtColor(img, cv2.COLOR_HSV2BGR))


def test_hsv_round_trip_with_luts_equals_cv2():
    """HSVAugment's chain at widths that mix vector and tail columns."""
    rng = np.random.RandomState(4)
    for w in (1, 33, 77, 256, 300):
        img = rng.randint(0, 256, (40, w, 3)).astype(np.uint8)
        x = np.arange(256, dtype=np.int16)
        g = rng.uniform(0.5, 1.5, 3)
        luts = (((x * g[0]) % 180).astype(np.uint8),
                np.clip(x * g[1], 0, 255).astype(np.uint8),
                np.clip(x * g[2], 0, 255).astype(np.uint8))
        hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
        want = cv2.cvtColor(cv2.merge([cv2.LUT(ch, lut) for ch, lut in
                                       zip(cv2.split(hsv), luts)]),
                            cv2.COLOR_HSV2BGR)
        got = color.hsv_to_bgr(color.apply_lut(color.bgr_to_hsv(img), luts))
        np.testing.assert_array_equal(got, want)

"""The PyTorch port's ops against the JAX package's, on the CPU.

JAX runs as its own tests run it: through the XLA fallbacks of its Pallas
wrappers, and at tiny shapes through the Pallas kernels in interpret mode
(ORP_FORCE_PALLAS_INTERPRET=1).  The port runs its plain versions, which
the CUDA kernels are held against on the card (chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.ops import deform_conv as dcn_ref
from orientedreppoints_tpu.ops import geometry as geo_ref
from orientedreppoints_tpu.ops import nms as nms_ref
from orientedreppoints_tpu.ops import pallas_minarearect, pallas_quad_iou
from orientedreppoints_tpu_torch.ops import deform_conv, geometry, nms
from orientedreppoints_tpu_torch.ops import minarearect, quad_iou


def point_sets(rng, n, spread=20.0):
    """n 9-point sets; the first tenth coincident, the next tenth exactly
    collinear."""
    pts = rng.uniform(0, 1344, (n, 1, 2)) + rng.normal(0, spread, (n, 9, 2))
    m = n // 10
    pts[:m] = pts[:m, :1]
    t = rng.integers(-8, 9, (m, 9, 1)).astype(np.float64)
    pts[m:2 * m] = np.round(pts[m:2 * m, :1]) + t * np.array([2.0, 1.0])
    return pts.reshape(n, 18).astype(np.float32)


def rect_corner_err(a, b):
    """Per-row max corner distance, minimised over the cyclic rotations and
    the reversal of b's corner order."""
    a, b = a.reshape(-1, 4, 2), b.reshape(-1, 4, 2)
    errs = [np.abs(a - np.roll(bb, s, 1)).max((1, 2))
            for bb in (b, b[:, ::-1]) for s in range(4)]
    return np.min(errs, 0)


def rect_area(r):
    r = r.reshape(-1, 4, 2).astype(np.float64)
    return (np.linalg.norm(r[:, 1] - r[:, 0], axis=-1)
            * np.linalg.norm(r[:, 2] - r[:, 1], axis=-1))


def assert_same_min_rects(got, ref, tol=1e-3):
    """Rects agree within tol px without regard to corner order, except at
    ties: where two hull edges give boxes of equal area (relative 1e-5,
    TIE_RTOL), the port takes the first edge and JAX the one that rounds
    smaller; both are minimal."""
    err = rect_corner_err(got, ref)
    other = err > tol
    rel = np.abs(rect_area(got) - rect_area(ref)) / np.maximum(
        rect_area(ref), 1e-6)
    assert np.all(rel[other] <= geometry.TIE_RTOL), (err.max(), rel[other])
    assert other.mean() < 0.05, other.mean()
    return int(other.sum())


class TestMinAreaRect:
    def test_plain_vs_xla_fallback(self):
        p = point_sets(np.random.default_rng(0), 600)
        ref = np.asarray(geo_ref.min_area_rect(jnp.asarray(p)))
        got = minarearect.min_area_rect(torch.from_numpy(p)).numpy()
        assert_same_min_rects(got, ref)

    def test_plain_vs_pallas_interpret(self, monkeypatch):
        monkeypatch.setenv("ORP_FORCE_PALLAS_INTERPRET", "1")
        p = point_sets(np.random.default_rng(1), 130)
        ref = np.asarray(pallas_minarearect.min_area_rect_pallas(
            jnp.asarray(p)))
        got = minarearect.min_area_rect(torch.from_numpy(p)).numpy()
        assert_same_min_rects(got, ref)

    def test_degenerate_sets_emit_the_point(self):
        p = np.tile(np.float32([[5.5, -3.0]]), (3, 9)).reshape(3, 18)
        got = minarearect.min_area_rect(torch.from_numpy(p)).numpy()
        np.testing.assert_array_equal(got, np.tile(p[:, :2], (1, 4)))


def class_offset_quads(rng, b, n, classes=15):
    """Score-sorted-like quads with many overlaps (jittered copies of a few
    base boxes), shifted by class as multiclass_rnms_batch does, so the
    coordinates reach ~3e4."""
    base = rng.integers(0, n // 4, (b, n))
    c = rng.uniform(100, 1200, (b, n // 4, 2))[np.arange(b)[:, None], base]
    c = c + rng.normal(0, 6, (b, n, 2))
    wh = rng.uniform(20, 80, (b, n, 2))
    ang = rng.uniform(0, np.pi, (b, n))
    lx = np.array([-0.5, 0.5, 0.5, -0.5]) * wh[..., :1]
    ly = np.array([-0.5, -0.5, 0.5, 0.5]) * wh[..., 1:]
    cs, sn = np.cos(ang)[..., None], np.sin(ang)[..., None]
    q = np.stack([cs * lx - sn * ly + c[..., :1],
                  sn * lx + cs * ly + c[..., 1:]], -1).reshape(b, n, 8)
    labels = base % classes
    return (q + labels[..., None] * 2000.0).astype(np.float32)


class TestQuadOverMask:
    def _check(self, quads, nv, ref_mask, thr=0.4):
        got = quad_iou.unpack_bits(
            quad_iou.quad_over_mask(torch.from_numpy(quads), thr,
                                    torch.from_numpy(nv)),
            quads.shape[1]).numpy()
        ref_mask = np.asarray(ref_mask)
        assert got.sum() > 20  # the case exercises suppression
        diff = got != ref_mask
        if diff.any():
            # allowed only at IoU ties with the threshold
            iou = np.asarray(jax.vmap(geo_ref.quad_iou_matrix)(quads, quads))
            assert np.all(np.abs(iou[diff] - thr) < 1e-4)

    def test_plain_vs_xla_fallback(self):
        quads = class_offset_quads(np.random.default_rng(2), 2, 96)
        assert quads.max() > 2.5e4
        nv = np.array([96, 70], np.int32)
        ref = pallas_quad_iou.quad_over_matrix_batch_pallas(
            jnp.asarray(quads), 0.4, num_valid=jnp.asarray(nv))
        self._check(quads, nv, ref)

    def test_plain_vs_pallas_interpret(self, monkeypatch):
        monkeypatch.setenv("ORP_FORCE_PALLAS_INTERPRET", "1")
        quads = class_offset_quads(np.random.default_rng(3), 1, 64)
        nv = np.array([60], np.int32)
        ref = pallas_quad_iou.quad_over_matrix_batch_pallas(
            jnp.asarray(quads), 0.4, num_valid=jnp.asarray(nv))
        self._check(quads, nv, ref)

    def test_pack_roundtrip(self):
        bits = torch.from_numpy(np.random.default_rng(4).random(
            (2, 3, 130)) < 0.5)
        words = quad_iou.pack_bits(bits)
        assert words.shape == (2, 3, 3) and words.dtype == torch.int64
        assert torch.equal(quad_iou.unpack_bits(words, 130), bits)


@pytest.mark.parametrize("density, n, nv, invalid", [
    pytest.param(0.02, 200, [200, 150, 0], 0.0, id="0.02"),
    pytest.param(0.3, 200, [200, 150, 0], 0.0, id="0.3"),
    # N not a multiple of 64, prefixes ending mid-word, a fifth of the rows
    # invalid inside the prefix (and valid rows past it)
    pytest.param(0.002, 4100, [4100, 2021], 0.2, id="invalid_rows_n4100"),
])
def test_greedy_scan_matches_exactly(density, n, nv, invalid):
    rng = np.random.default_rng(5)
    nv = np.array(nv, np.int32)
    b = len(nv)
    over = np.triu(rng.random((b, n, n)) < density, 1)
    rows = np.arange(n)
    over &= (rows[None, :, None] < nv[:, None, None]) & (
        rows[None, None, :] < nv[:, None, None])
    valid = rows[None, :] < nv[:, None]
    if invalid:
        valid = rng.random((b, n)) >= invalid
    ref = np.asarray(nms_ref.greedy_scan_sorted(
        jnp.asarray(over), jnp.asarray(valid), num_valid=jnp.asarray(nv)))
    got = nms.greedy_scan(quad_iou.pack_bits(torch.from_numpy(over)),
                          torch.from_numpy(valid), torch.from_numpy(nv))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_multiclass_rnms_batch_matches():
    rng = np.random.default_rng(6)
    b, n, c = 2, 60, 5
    boxes = class_offset_quads(rng, b, n, classes=1)
    scores = rng.random((b, n, c + 1)).astype(np.float32) * 0.3
    ref = nms_ref.multiclass_rnms_batch(
        jnp.asarray(boxes), jnp.asarray(scores), 0.05, 0.4, 100,
        reppoints=jnp.asarray(boxes.repeat(2, -1)[..., :18]),
        pre_nms_cap=128)
    got = nms.multiclass_rnms_batch(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.05, 0.4, 100,
        reppoints=torch.from_numpy(boxes.repeat(2, -1)[..., :18].copy()),
        pre_nms_cap=128)
    dets, labels, valid = (np.asarray(x) for x in ref)
    assert 0 < valid.sum() < valid.size
    np.testing.assert_array_equal(got[2].numpy(), valid)
    np.testing.assert_array_equal(got[1].numpy(), labels)
    np.testing.assert_allclose(got[0].numpy(), dets, rtol=0, atol=1e-6)


def test_deform_pair_matches():
    """Offsets of std 4 px at maps of 3..10 px sample well outside."""
    rng = np.random.default_rng(7)
    b, c, cout = 2, 16, 8
    hws = [(8, 10), (4, 5), (2, 3), (1, 2)]
    fa = [rng.normal(size=(b, h, w, c)).astype(np.float32) for h, w in hws]
    fb = [rng.normal(size=(b, h, w, c)).astype(np.float32) for h, w in hws]
    off = [(rng.normal(size=(b, h, w, 18)) * 4).astype(np.float32)
           for h, w in hws]
    wa = rng.normal(size=(9, c, cout)).astype(np.float32)
    wb = rng.normal(size=(9, c, cout)).astype(np.float32)
    ref_a, ref_b = dcn_ref.deform_conv2d_pyramid_pair(
        [jnp.asarray(x) for x in fa], [jnp.asarray(x) for x in fb],
        [jnp.asarray(x) for x in off], jnp.asarray(wa), jnp.asarray(wb))
    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    out_a, out_b = deform_conv.deform_conv2d_pyramid_pair(
        t(fa), t(fb), t(off), torch.from_numpy(wa), torch.from_numpy(wb))
    # f32 gathers and a K*C = 144 term product summed in another order
    for got, ref in zip(out_a + out_b, list(ref_a) + list(ref_b)):
        ref = np.asarray(ref)
        tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
        assert np.abs(got.numpy() - ref).max() <= tol


def test_dcn_base_offset_matches():
    np.testing.assert_array_equal(
        deform_conv.dcn_base_offset(3).numpy(),
        dcn_ref.dcn_base_offset(3).reshape(-1))


def test_quad_iou_matrix_matches():
    quads = class_offset_quads(np.random.default_rng(8), 1, 48)[0]
    ref = np.asarray(geo_ref.quad_iou_matrix(jnp.asarray(quads),
                                             jnp.asarray(quads)))
    got = quad_iou.quad_iou_matrix(torch.from_numpy(quads),
                                   torch.from_numpy(quads)).numpy()
    assert (ref > 0.4).sum() > 48  # overlaps beyond the diagonal
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_pyramid_plan_matches_exactly():
    rng = np.random.default_rng(9)
    shapes = [(2, 6, 7), (2, 3, 4), (2, 1, 2)]
    off = [(rng.normal(size=(b, h, w, 18)) * 3).astype(np.float32)
           for b, h, w in shapes]
    idx_r, ok_r, wy_r, wx_r = dcn_ref._pyramid_plan(
        tuple(shapes), tuple(jnp.asarray(o) for o in off), 3)
    idx, ok, wy, wx = deform_conv.pyramid_plan(
        shapes, torch.cat([torch.from_numpy(o).reshape(-1, 18)
                           for o in off]), 3)
    for a, b in zip(idx + ok, list(idx_r) + list(ok_r)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(wy.numpy(), np.asarray(wy_r))
    np.testing.assert_array_equal(wx.numpy(), np.asarray(wx_r))


def test_offset_to_pts_matches():
    from orientedreppoints_tpu.core import points as points_ref
    from orientedreppoints_tpu_torch.core import points

    off = np.random.default_rng(10).normal(size=(2, 5, 7, 18)).astype(
        np.float32)
    for stride in (8, 128):
        np.testing.assert_allclose(
            points.offset_to_pts(torch.from_numpy(off), stride).numpy(),
            np.asarray(points_ref.offset_to_pts(jnp.asarray(off), stride)),
            rtol=0, atol=1e-4)

"""The PyTorch port's training geometry, losses, assigners and APAA against
the JAX package, on the CPU.

Seeded numpy inputs go through the JAX function and its port (plain
versions: the tensors are on the CPU).  Where the JAX function reaches a
Pallas kernel it runs here as the JAX package's own tests run it: through
its XLA fallback, or in interpret mode (ORP_FORCE_PALLAS_INTERPRET=1).
Tolerances are stated per test; assignments are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.core import apaa as apaa_ref
from orientedreppoints_tpu.core import assigners as assigners_ref
from orientedreppoints_tpu.core import losses as losses_ref
from orientedreppoints_tpu.core import points as points_ref
from orientedreppoints_tpu.ops import geometry as geo_ref
from orientedreppoints_tpu.ops import pallas_minarearect, pallas_quad_iou
from orientedreppoints_tpu_torch.core import apaa, assigners, losses, points
from orientedreppoints_tpu_torch.ops import geometry, hull_iou, minarearect
from test_torch_slice import _min_area_rect_first_tie


def point_sets(rng, n, lo=20.0, hi=100.0, spread=12.0):
    """n 9-point sets; the first eighth coincident (hull count 1), the next
    eighth on one line (count 2)."""
    pts = rng.uniform(lo, hi, (n, 1, 2)) + rng.normal(0, spread, (n, 9, 2))
    m = n // 8
    pts[:m] = pts[:m, :1]
    t = rng.integers(-4, 5, (m, 9, 1)).astype(np.float64)
    pts[m:2 * m] = np.round(pts[m:2 * m, :1]) + t * np.array([2.0, 1.0])
    return pts.reshape(n, 18).astype(np.float32)


def rotated_quads(rng, g, lo=20.0, hi=100.0, size=(5.0, 50.0)):
    """g rotated rectangles; every third clockwise."""
    c = rng.uniform(lo, hi, (g, 2))
    wh = rng.uniform(*size, (g, 2))
    a = rng.uniform(0, np.pi, g)
    lx = np.array([-0.5, 0.5, 0.5, -0.5]) * wh[:, :1]
    ly = np.array([-0.5, -0.5, 0.5, 0.5]) * wh[:, 1:]
    cs, sn = np.cos(a)[:, None], np.sin(a)[:, None]
    q = np.stack([cs * lx - sn * ly + c[:, :1],
                  sn * lx + cs * ly + c[:, 1:]], -1)
    q[1::3] = q[1::3, ::-1]
    return q.reshape(g, 8).astype(np.float32)


def hull_case(seed):
    """Hulls (plain convex_hull_entry) of point sets with count-1 and
    count-2 hulls, and gt quads with one disjoint quad and two padded zero
    rows (the last two)."""
    rng = np.random.default_rng(seed)
    pts = point_sets(rng, 24)
    quads = rotated_quads(rng, 12)
    quads[-3] += 500.0
    quads[-2:] = 0.0
    hulls, counts = minarearect.convex_hull_entry(torch.from_numpy(pts))
    return pts, hulls, counts, quads


class TestHullIoU:
    def _port(self, hulls, counts, quads):
        return hull_iou.hull_quad_iou_matrix(
            hulls[None], counts[None], torch.from_numpy(quads)[None])[0]

    def _check(self, got, ref, counts, tol):
        # padded zero quads: every edge is a point, so inter and the hull
        # area agree up to rounding and the IoU is a large number that the
        # assigner masks to -1; only finiteness is compared there
        assert np.isfinite(got).all() and np.isfinite(ref).all()
        np.testing.assert_allclose(got[:, :-2], ref[:, :-2], rtol=0,
                                   atol=tol)
        assert (got[:, -3] == 0).all()  # disjoint
        assert np.abs(got[counts <= 2, :-2]).max() < 1e-5  # no area
        assert (got[:, :-2] > 0.1).sum() >= 10

    def test_plain_vs_xla_fallback(self):
        _, hulls, counts, quads = hull_case(0)
        ref = np.asarray(jax.jit(pallas_quad_iou.hull_quad_iou_matrix_pallas)(
            hulls.numpy(), counts.numpy(), quads))
        got = self._port(hulls, counts, quads).numpy()
        self._check(got, ref, counts.numpy(), 1e-5)

    def test_plain_vs_pallas_interpret(self, monkeypatch):
        """Same order of operations; XLA:CPU may still round a product or
        a sum differently, hence 1e-6 and not equality."""
        monkeypatch.setenv("ORP_FORCE_PALLAS_INTERPRET", "1")
        _, hulls, counts, quads = hull_case(1)
        ref = np.asarray(pallas_quad_iou.hull_quad_iou_matrix_pallas(
            jnp.asarray(hulls.numpy()), jnp.asarray(counts.numpy()),
            jnp.asarray(quads)))
        got = self._port(hulls, counts, quads).numpy()
        self._check(got, ref, counts.numpy(), 1e-6)

    def test_batched_equals_per_image(self):
        cases = [hull_case(s) for s in (2, 3)]
        hulls = torch.stack([c[1] for c in cases])
        counts = torch.stack([c[2] for c in cases])
        quads = torch.from_numpy(np.stack([c[3] for c in cases]))
        got = hull_iou.hull_quad_iou_matrix(hulls, counts, quads)
        for i, c in enumerate(cases):
            assert torch.equal(got[i], self._port(c[1], c[2], c[3]))


    def test_masked_plain_is_where_of_unmasked(self):
        """-1.0 where the gt or the row is not valid, the unmasked bits
        elsewhere: image 0 with its two padded gts masked, image 1 with no
        valid gt, image 2 with a third of its rows invalid; either mask may
        be None."""
        cases = [hull_case(s) for s in (20, 21, 22)]
        hulls = torch.stack([c[1] for c in cases])
        counts = torch.stack([c[2] for c in cases])
        quads = torch.from_numpy(np.stack([c[3] for c in cases]))
        b, n, g = counts.shape + quads.shape[1:2]
        gt_valid = torch.ones((b, g), dtype=torch.bool)
        gt_valid[0, -2:] = False
        gt_valid[1] = False
        rows_valid = torch.ones((b, n), dtype=torch.bool)
        rows_valid[2, ::3] = False
        full = hull_iou.hull_quad_iou_matrix(hulls, counts, quads)
        both = hull_iou.hull_quad_iou_matrix(hulls, counts, quads, gt_valid,
                                             rows_valid)
        assert (both[1] == -1).all() and (both[2, ::3] == -1).all()
        assert (both[0][:, :-2] > 0.1).sum() >= 10
        for gv, rv in ((gt_valid, rows_valid), (gt_valid, None),
                       (None, rows_valid)):
            live = torch.ones((b, n, g), dtype=torch.bool)
            if gv is not None:
                live &= gv[:, None, :]
            if rv is not None:
                live &= rv[:, :, None]
            got = hull_iou.hull_quad_iou_matrix(hulls, counts, quads, gv, rv)
            assert got.shape == (b, n, g)
            assert torch.equal(got.view(torch.int32),
                               torch.where(live, full, -1.0).view(torch.int32))


class TestConvexHullEntry:
    """The plain hull rounds as kernel 1 writes it: (p - c) + c."""

    def _check(self, pts, ref_hulls, ref_counts):
        hulls, counts = minarearect.convex_hull_entry(torch.from_numpy(pts))
        assert hulls.shape == (len(pts), 9, 2) and counts.dtype == torch.int32
        np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
        # one rounding of the centroid shift: coordinates < 200
        np.testing.assert_allclose(hulls.numpy(), np.asarray(ref_hulls),
                                   rtol=0, atol=2e-5)
        assert set(counts.numpy()[:8].tolist()) == {1}

    def test_vs_xla_fallback(self):
        pts = point_sets(np.random.default_rng(4), 64)
        self._check(pts, *pallas_minarearect.convex_hull_pallas(
            jnp.asarray(pts)))

    def test_vs_pallas_interpret(self, monkeypatch):
        monkeypatch.setenv("ORP_FORCE_PALLAS_INTERPRET", "1")
        pts = point_sets(np.random.default_rng(5), 64)
        self._check(pts, *pallas_minarearect.convex_hull_pallas(
            jnp.asarray(pts)))


def test_convex_iou_matches():
    """(B, G, N) against the JAX (G, N) per image; both images shifted by
    the mean of all gt corners, the padded zero rows included."""
    rng = np.random.default_rng(6)
    b, g, n = 2, 10, 40
    pts = np.stack([point_sets(rng, n) for _ in range(b)])
    quads = np.stack([rotated_quads(rng, g) for _ in range(b)])
    quads[:, -3:] = 0.0
    ref = np.asarray(jax.jit(jax.vmap(geo_ref.convex_iou))(quads, pts))
    got = geometry.convex_iou(torch.from_numpy(quads),
                              torch.from_numpy(pts)).numpy()
    assert got.shape == (b, g, n)
    assert (ref[:, :-3] > 0.1).sum() >= 10
    np.testing.assert_allclose(got[:, :-3], ref[:, :-3], rtol=0, atol=1e-5)


def test_training_geometry_matches():
    rng = np.random.default_rng(7)
    pts = point_sets(rng, 40).reshape(40, 9, 2)
    quads = rotated_quads(rng, 40).reshape(40, 4, 2)
    inside = jax.vmap(geo_ref.points_in_polygon)(jnp.asarray(pts),
                                                 jnp.asarray(quads))
    got = geometry.points_in_polygon(torch.from_numpy(pts),
                                     torch.from_numpy(quads))
    np.testing.assert_array_equal(got.numpy(), np.asarray(inside))
    assert 0 < got.sum() < got.numel()
    area = jax.vmap(geo_ref.polygon_area)(jnp.asarray(quads))
    np.testing.assert_allclose(
        geometry.polygon_area(torch.from_numpy(quads)).numpy(),
        np.asarray(area), rtol=1e-6)
    hulls, counts = minarearect.convex_hull_entry(
        torch.from_numpy(pts.reshape(40, 18)))
    clip_ref = jax.jit(jax.vmap(geo_ref.convex_intersection_area))(
        hulls.numpy(), counts.numpy(), quads)
    poly, cnt = geometry.clip_convex_by_quad(hulls, counts,
                                             torch.from_numpy(quads))
    np.testing.assert_allclose(geometry.polygon_area(poly, cnt).numpy(),
                               np.asarray(clip_ref), rtol=0, atol=1e-3)
    s1 = rng.normal(0, 5, (6, 40, 2)).astype(np.float32)
    s2 = rng.normal(0, 5, (6, 40, 2)).astype(np.float32)
    np.testing.assert_allclose(
        geometry.chamfer_distance_2d(torch.from_numpy(s1),
                                     torch.from_numpy(s2)).numpy(),
        np.asarray(geo_ref.chamfer_distance_2d(s1, s2)), rtol=1e-5)


def giou_case(seed, m=48):
    """Point sets vs gt quads in stride-normalised units: most rows of
    size ~1-5, a few tiny ones whose GIoU gradient has components > 1, a
    few disjoint, and zero-weight padding rows."""
    rng = np.random.default_rng(seed)
    quads = rotated_quads(rng, m, 0.0, 10.0, (0.5, 5.0))
    pts = (quads.reshape(m, 4, 2).mean(1, keepdims=True)
           + rng.normal(0, 1.5, (m, 9, 2))).reshape(m, 18)
    pts[:4] = quads.reshape(m, 4, 2)[:4, :1].repeat(9, 1).reshape(4, 18) \
        + rng.normal(0, 0.05, (4, 18))
    quads[:4] = quads[:4] * 0.1
    pts[4:8] += 40.0
    w = (rng.random(m) < 0.8).astype(np.float32)
    w[:8] = 1.0
    return pts.astype(np.float32), quads, w


def test_convex_giou_value_and_grad():
    pts, quads, _ = giou_case(8)
    cot = np.random.default_rng(9).normal(size=len(pts)).astype(np.float32)

    @jax.jit
    def value_and_vjp(p, q, c):
        val, vjp = jax.vjp(lambda pp: geo_ref.convex_giou(pp, q), p)
        return val, vjp(c)[0]

    ref, ref_grad = value_and_vjp(pts, quads, cot)
    p = torch.from_numpy(pts).requires_grad_(True)
    got = geometry.convex_giou(p, torch.from_numpy(quads))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=2e-5)
    assert (np.asarray(ref)[4:8] < -0.5).all()  # disjoint: GIoU near -1
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-3, atol=1e-4)


class TestGIoULoss:
    def _run(self, seed, upstream):
        pts, quads, w = giou_case(seed)
        div = int((w > 0).sum())
        fn = lambda p: losses_ref.giou_loss(  # noqa: E731
            p, jnp.asarray(quads), jnp.asarray(w), div, loss_weight=0.375)
        ref, ref_grad = jax.jit(jax.value_and_grad(fn))(pts)
        p = torch.from_numpy(pts).requires_grad_(True)
        loss = losses.giou_loss(p, torch.from_numpy(quads),
                                torch.from_numpy(w), div, loss_weight=0.375)
        (loss * upstream).backward()
        return loss.detach(), p.grad, ref, ref_grad

    def test_value_and_filtered_grad(self):
        got, grad, ref, ref_grad = self._run(10, 1.0)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
        # the filter replaced whole rows by +1e-6 (times -lw / n): rows with
        # a raw component > 1 are present
        filtered = np.all(np.isclose(np.asarray(ref_grad), -1e-6 * 0.375
                                     / 44, rtol=1e-3), axis=1)
        assert filtered.sum() >= 2, filtered.sum()
        np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad),
                                   rtol=1e-3, atol=1e-6)

    def test_backward_ignores_upstream_grad(self):
        _, g1, _, _ = self._run(11, 1.0)
        _, g7, _, _ = self._run(11, 7.0)
        assert torch.equal(g1, g7)


def test_focal_loss_value_and_grad():
    rng = np.random.default_rng(12)
    logits = rng.normal(0, 2, (2, 50, 15)).astype(np.float32)
    labels = rng.integers(0, 16, (2, 50)).astype(np.int32)
    weight = (rng.random((2, 50)) < 0.9).astype(np.float32)
    fn = lambda x: losses_ref.focal_loss(  # noqa: E731
        x, jnp.asarray(labels), jnp.asarray(weight), 17)
    ref, ref_grad = jax.jit(jax.value_and_grad(fn))(logits)
    x = torch.from_numpy(logits).requires_grad_(True)
    got = losses.focal_loss(x, torch.from_numpy(labels),
                            torch.from_numpy(weight), torch.tensor(17))
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-4, atol=1e-7)


def test_spatial_border_loss_value_and_grad():
    pts, quads, w = giou_case(13)
    fn = lambda p: losses_ref.spatial_border_loss(  # noqa: E731
        p, jnp.asarray(quads), jnp.asarray(w), loss_weight=0.1)
    ref, ref_grad = jax.jit(jax.value_and_grad(fn))(pts)
    p = torch.from_numpy(pts).requires_grad_(True)
    got = losses.spatial_border_loss(p, torch.from_numpy(quads),
                                     torch.from_numpy(w), loss_weight=0.1)
    got.backward()
    assert float(ref) > 0
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-4, atol=1e-8)


def test_point_assign_matches_exactly():
    """Ties built in: two gts with the same box (the earlier wins), and
    gt centres halfway between two grid points (the lower index wins)."""
    strides = (8, 16, 32, 64, 128)
    grid = np.asarray(jnp.concatenate(points_ref.multi_level_grid_points(
        (128, 128), strides)))
    rng = np.random.default_rng(14)
    b, g = 2, 8
    quads = np.stack([rotated_quads(rng, g, 10.0, 118.0, (8.0, 90.0))
                      for _ in range(b)])
    quads[0, 1] = quads[0, 0]
    quads[1, 2] = (np.array([-6, -6, 6, -6, 6, 6, -6, 6], np.float32)
                   + np.array([12.0, 40.0] * 4, np.float32))
    valid = np.ones((b, g), bool)
    valid[1, -2:] = False
    pv = np.asarray(jnp.stack([jnp.concatenate(
        points_ref.multi_level_valid_flags((128, 128), strides, hw))
        for hw in jnp.asarray([[128, 128], [100, 90]])]))
    ref = jax.jit(jax.vmap(assigners_ref.point_assign,
                           in_axes=(None, 0, 0, 0)))(grid, pv, quads, valid)
    got_pv = torch.cat(points.multi_level_valid_flags(
        (128, 128), strides, torch.tensor([[128, 128], [100, 90]])), 1)
    np.testing.assert_array_equal(got_pv.numpy(), pv)
    got = assigners.point_assign(torch.from_numpy(grid), got_pv,
                                 torch.from_numpy(quads),
                                 torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (np.asarray(ref) > 0).sum() >= 8


def test_max_iou_assign_from_overlaps_matches_exactly():
    """Overlaps on a 0.05 lattice, so that a gt's max is tied by several
    proposals and a proposal ties several gts; padded gts and proposals."""
    rng = np.random.default_rng(15)
    b, g, n = 2, 6, 300
    overlaps = np.round(rng.random((b, g, n)) ** 3 * 20) / 20
    gv = np.ones((b, g), bool)
    gv[1, -2:] = False
    pv = rng.random((b, n)) < 0.9
    overlaps = np.where(gv[..., None] & pv[:, None], overlaps,
                        -1.0).astype(np.float32)
    ref = jax.vmap(assigners_ref.max_iou_assign_from_overlaps)(
        jnp.asarray(overlaps), jnp.asarray(pv), jnp.asarray(gv))
    got = assigners.max_iou_assign_from_overlaps(
        torch.from_numpy(overlaps), torch.from_numpy(pv),
        torch.from_numpy(gv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (np.asarray(ref) > 0).sum() > 50


def test_max_iou_assign_matches_exactly():
    """The port's max_iou_assign (masks passed into the hull-IoU entry)
    against the JAX one per image: image 0 with three padded zero gts,
    image 1 with none valid, a sixth of the proposals invalid.  The
    assignment and the -1 pattern are equal; the overlaps agree within
    1e-6 (the hulls and the XLA fallback round apart by an ulp)."""
    rng = np.random.default_rng(19)
    b, g, n = 3, 12, 64
    pts = np.stack([point_sets(rng, n, 10.0, 110.0) for _ in range(b)])
    quads = np.stack([rotated_quads(rng, g, 10.0, 110.0, (8.0, 50.0))
                      for _ in range(b)])
    gv = np.ones((b, g), bool)
    gv[0, -3:] = False
    gv[1] = False
    quads[~gv] = 0.0
    pv = rng.random((b, n)) < 0.85
    ref, ref_over = jax.jit(jax.vmap(assigners_ref.max_iou_assign))(
        pts, pv, quads, gv)
    got, over = assigners.max_iou_assign(
        torch.from_numpy(pts), torch.from_numpy(pv), torch.from_numpy(quads),
        torch.from_numpy(gv))
    ref, ref_over = np.asarray(ref), np.asarray(ref_over)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(over.numpy() == -1, ref_over == -1)
    np.testing.assert_allclose(over.numpy(), ref_over, rtol=0, atol=1e-6)
    assert (ref[0] > 0).sum() >= 10 and (ref[1] == 0).all()
    assert (ref_over > 0.1).sum() >= 50


@pytest.mark.parametrize("max_pos", [64, 512], ids=["overflow", "no_overflow"])
def test_compact_positives_bit_identical(max_pos):
    rng = np.random.default_rng(16)
    n = 341
    gt_inds = np.where(rng.random((2, n)) < 0.4,
                       rng.integers(1, 9, (2, n)), 0).astype(np.int32)
    level_ids = np.repeat(np.arange(5), [256, 64, 16, 4, 1]).astype(np.int32)
    ref = jax.vmap(lambda gi: apaa_ref.compact_positives(
        gi, jnp.asarray(level_ids), max_pos))(jnp.asarray(gt_inds))
    got = apaa.compact_positives(torch.from_numpy(gt_inds),
                                 torch.from_numpy(level_ids), max_pos)
    for name in ("idx", "mask", "gt_idx", "level"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert bool(ref.mask.all()) == (max_pos == 64)


def test_sample_selection_identical():
    """Quality on a lattice (ties inside and across levels), inf at the
    masked slots."""
    rng = np.random.default_rng(17)
    n, max_gt = 341, 8
    gt_inds = np.where(rng.random((2, n)) < 0.5,
                       rng.integers(1, max_gt + 1, (2, n)), 0).astype(np.int32)
    level_ids = np.repeat(np.arange(5), [256, 64, 16, 4, 1]).astype(np.int32)
    cand_ref = jax.vmap(lambda gi: apaa_ref.compact_positives(
        gi, jnp.asarray(level_ids), 128))(jnp.asarray(gt_inds))
    cand = apaa.compact_positives(torch.from_numpy(gt_inds),
                                  torch.from_numpy(level_ids), 128)
    q = np.round(rng.random((2, 128)) * 8) / 8
    q = np.where(np.asarray(cand_ref.mask), q, np.inf).astype(np.float32)
    ref = jax.vmap(lambda c, qq: apaa_ref.sample_selection(c, qq, max_gt, 5))(
        cand_ref, jnp.asarray(q))
    got = apaa.sample_selection(cand, torch.from_numpy(q), max_gt, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 10 < got.sum() < int(cand.mask.sum())


def test_quality_assessment_matches(monkeypatch):
    """The JAX min-area rects take the first of equally small boxes, as the
    port does (test_torch_slice._min_area_rect_first_tie)."""
    monkeypatch.setattr(apaa_ref, "min_area_rect", lambda p: jax.vmap(
        _min_area_rect_first_tie)(p.reshape(p.shape[0], -1)))
    rng = np.random.default_rng(18)
    n, c, p = 60, 15, 48
    quads = rotated_quads(rng, n, 10.0, 110.0, (6.0, 40.0))
    centre = quads.reshape(n, 4, 2).mean(1)
    pts_init = (centre[:, None] + rng.normal(0, 8, (n, 9, 2))).reshape(n, 18)
    pts_refine = (centre[:, None] + rng.normal(0, 6, (n, 9, 2))).reshape(
        n, 18)
    gt_inds = np.where(rng.random(n) < 0.6, rng.integers(1, 5, n), 0)
    labels = np.where(gt_inds > 0, rng.integers(1, 16, n), 0)
    arrays = dict(
        cls=rng.normal(0, 2, (n, c)), pts_init=pts_init,
        pts_refine=pts_refine, labels=labels, polys=quads,
        feats=rng.normal(0, 1, (p, 9, 16)))
    arrays = {k: v.astype(np.int32 if k == "labels" else np.float32)
              for k, v in arrays.items()}
    level_ids = np.repeat(np.arange(3), 20).astype(np.int32)
    cand_ref = apaa_ref.compact_positives(jnp.asarray(gt_inds),
                                          jnp.asarray(level_ids), p)
    ref = jax.jit(apaa_ref.quality_assessment)(
        cand_ref, *(arrays[k] for k in (
            "cls", "pts_init", "pts_refine", "labels", "polys", "feats")))
    cand = apaa.compact_positives(torch.from_numpy(gt_inds[None]),
                                  torch.from_numpy(level_ids), p)
    got = apaa.quality_assessment(
        cand, *(torch.from_numpy(arrays[k])[None] for k in (
            "cls", "pts_init", "pts_refine", "labels", "polys")),
        torch.from_numpy(arrays["feats"])[None])[0]
    ref = np.asarray(ref)
    assert np.isinf(ref).sum() == np.isinf(got.numpy()).sum() > 0
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got.numpy()[fin], ref[fin], rtol=1e-4)
    np.testing.assert_allclose(
        apaa.sample_edge_points(torch.from_numpy(quads)).numpy(),
        np.asarray(apaa_ref.sample_edge_points(jnp.asarray(quads))),
        rtol=0, atol=1e-5)

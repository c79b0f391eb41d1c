"""The PyTorch port's CUDA kernels against their plain versions, on the
card.  Marked `cuda`; they skip where torch.cuda.is_available() is false.

This file imports no JAX, so that it runs on a machine with the card and
without JAX (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from orientedreppoints_tpu_torch.ops import (deform_conv, hull_iou,
                                             minarearect, nms, quad_iou)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card with "
                    "python -m pytest tests/test_torch_cuda.py -m cuda "
                    "--noconftest)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card(cuda):
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 1344, (2048, 1, 2)) + rng.normal(0, 20, (2048, 9, 2))
    p = torch.tensor(pts.reshape(-1, 18), dtype=torch.float32, device=cuda)
    rect = minarearect.min_area_rect(p)
    ref = minarearect.min_area_rect_plain(p)
    err = (rect.view(-1, 4, 2)[:, None] - torch.stack(
        [ref.view(-1, 4, 2).roll(s, 1) for s in range(4)], 1)).abs()
    assert err.amax(-1).amax(-1).amin(-1).max() < 1e-3

    quads = torch.tensor(rng.uniform(0, 300, (2, 256, 1, 2))
                         + rng.normal(0, 15, (2, 256, 4, 2)),
                         dtype=torch.float32, device=cuda).view(2, 256, 8)
    nv = torch.tensor([256, 200], dtype=torch.int32, device=cuda)
    mask = quad_iou.quad_over_mask(quads, 0.4, nv)
    assert torch.equal(mask, quad_iou.quad_over_mask_plain(quads, 0.4, nv))
    valid = torch.arange(256, device=cuda)[None] < nv[:, None]
    assert torch.equal(nms.greedy_scan(mask, valid, nv),
                       nms.greedy_scan_plain(mask, valid, nv))

    shapes = [(2, 12, 10), (2, 6, 5)]
    rows = sum(b * h * w for b, h, w in shapes)
    ta = torch.randn(rows, 64, device=cuda)
    tb = torch.randn(rows, 64, device=cuda)
    off = torch.randn(rows, 18, device=cuda) * 3
    for got, want in zip(deform_conv.deform_sample_pair(ta, tb, off, shapes),
                         deform_conv.deform_sample_pair_plain(ta, tb, off,
                                                              shapes)):
        assert (got - want).abs().max() < 1e-5


@pytest.mark.cuda
def test_training_kernels_match_plain_versions_on_the_card(cuda):
    """Kernel 1's hull output and the hull-IoU kernel give the plain
    versions' bits (the assigner compares IoUs for equality); the DCN
    backward's table grads too (close_grads)."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 400, (3000, 1, 2)) + rng.normal(0, 20, (3000, 9, 2))
    pts[:100] = pts[:100, :1]
    p = torch.tensor(pts.reshape(-1, 18), dtype=torch.float32, device=cuda)
    hulls, counts = minarearect.convex_hull_entry(p)
    hulls_p, counts_p = minarearect.convex_hull_plain(p)
    assert torch.equal(hulls, hulls_p) and torch.equal(counts, counts_p)

    quads = torch.tensor(rng.uniform(0, 400, (2, 40, 1, 2))
                         + rng.normal(0, 30, (2, 40, 4, 2)),
                         dtype=torch.float32, device=cuda).view(2, 40, 8)
    quads[:, -5:] = 0
    h, c = hulls.view(2, 1500, 9, 2), counts.view(2, 1500)
    iou = hull_iou.hull_quad_iou_matrix(h, c, quads)
    assert torch.equal(iou, hull_iou.hull_quad_iou_matrix_plain(h, c, quads))
    assert (iou[..., :-5] > 0.1).sum() > 100

    shapes = [(2, 12, 10), (2, 6, 5)]
    rows = sum(b * hh * w for b, hh, w in shapes)
    for dt in (torch.float32, torch.bfloat16):
        ta = torch.randn(rows, 64, device=cuda).to(dt)
        tb = torch.randn(rows, 64, device=cuda).to(dt)
        off = (torch.randn(rows, 18, device=cuda) * 3).to(dt)
        ga = torch.randn(rows, 9 * 64, device=cuda)  # f32 sample grads
        gb = torch.randn(rows, 9 * 64, device=cuda)
        args = (ta, tb, off, ga, gb, shapes)
        got = deform_conv.deform_sample_pair_backward(*args)
        want = on_the_cpu(deform_conv.deform_sample_pair_backward_plain,
                          *args)
        close_grads(got, want, dt, ((rows, 64), (rows, 64), (rows, 18)))


@pytest.mark.cuda
def test_quad_iou_kernels_match_plain_versions_on_the_card(cuda):
    """Kernels 4 and 5 (full and upper-triangle f32 IoU) and the single-image
    over-mask give the plain versions' bits; the over-mask is (tri > thr).
    Then both kernels at shapes that cross their 64 x 64 tiles, with
    prefixes 0, 1, 64, 65, N - 1, N and above N, bit for bit."""
    rng = np.random.default_rng(3)
    quads = torch.tensor(rng.uniform(0, 120, (3, 200, 1, 2))
                         + rng.normal(0, 15, (3, 200, 4, 2)),
                         dtype=torch.float32, device=cuda).view(3, 200, 8)
    quads[:, :100] += 2e4  # class-offset coordinates
    other = quads[:, torch.randperm(200, device=cuda)[:150]].contiguous()
    full = quad_iou.quad_iou_matrix_batch(quads, other)
    assert torch.equal(full, quad_iou.quad_iou_matrix_plain(quads, other))
    assert (full > 0.3).sum() > 100
    nv = torch.tensor([200, 120, 0], dtype=torch.int32, device=cuda)
    tri = quad_iou.quad_iou_matrix_batch(quads, quads, True, nv)
    assert torch.equal(tri, quad_iou.quad_iou_matrix_plain(quads, quads,
                                                           True, nv))
    assert tri[2].max() == 0 and (tri[:2] > 0.3).sum() > 10
    words = quad_iou.quad_over_matrix(quads[1], 0.4, nv[1])
    assert torch.equal(words, quad_iou.pack_bits(tri[1] > 0.4))
    assert torch.equal(words, quad_iou.quad_over_mask_plain(
        quads[1:2], 0.4, nv[1:2])[0])
    # shapes across the 64-wide tiles: N, M ragged, M < 64, N < M and
    # N > M, rows with 16-byte stores (M % 4 == 0) and scalar ones
    for n, m in ((70, 132), (200, 37), (130, 200), (200, 132), (64, 65)):
        a = quads[:, :n].contiguous()
        c = (other if m <= 150 else quads)[:, :m].contiguous()
        assert same_bits(quad_iou.quad_iou_matrix_batch(a, c),
                         quad_iou.quad_iou_matrix_plain(a, c))
        for nvs in ((0, 1, 64), (65, n - 1, n), (n + 1, 1 << 30, m)):
            nv = torch.tensor(nvs, dtype=torch.int32, device=cuda)
            got = quad_iou.quad_iou_matrix_batch(a, c, True, nv)
            want = quad_iou.quad_iou_matrix_plain(a, c, True, nv)
            assert same_bits(got, want), (n, m, nvs)
    # the triangle at every prefix of the list, one image, N = M = 200
    for v in (0, 1, 64, 65, 199, 200, 201):
        nv = torch.tensor([v], dtype=torch.int32, device=cuda)
        got = quad_iou.quad_iou_matrix(quads[0], quads[0], True, nv[0])
        want = quad_iou.quad_iou_matrix_plain(quads[:1], quads[:1], True, nv)
        assert same_bits(got, want[0]), v


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.cuda
def test_hull_iou_kernel_masks_and_ragged_shapes_bit_for_bit(cuda):
    """N 1000 and G 75 (not multiples of the kernel's 128 hulls and 64 gts
    a block); image 0 ordinary with padded gts, image 1 all gts padded,
    image 2 all hulls degenerate (count 1); a tenth of the point sets
    spread wide so that their hulls overlap many gts; a fifth of the rows
    invalid."""
    rng = np.random.default_rng(4)
    b, n, g = 3, 1000, 75
    spread = np.where(rng.random((b * n, 1, 1)) < 0.1, 150.0, 20.0)
    pts = rng.uniform(0, 400, (b * n, 1, 2)) + rng.normal(
        0, 1, (b * n, 9, 2)) * spread
    pts[2 * n:] = pts[2 * n:, :1]
    p = torch.tensor(pts.reshape(-1, 18), dtype=torch.float32, device=cuda)
    hulls, counts = minarearect.convex_hull_entry(p)
    h, c = hulls.view(b, n, 9, 2), counts.view(b, n)
    assert (c[2] == 1).all() and (c[:2] > 2).float().mean() > 0.9
    quads = torch.tensor(rng.uniform(0, 400, (b, g, 1, 2))
                         + rng.normal(0, 30, (b, g, 4, 2)),
                         dtype=torch.float32, device=cuda).view(b, g, 8)
    gt_valid = torch.tensor(rng.random((b, g)) < 0.7, device=cuda)
    gt_valid[1] = False
    quads[~gt_valid] = 0.0  # padded gts are zero rows, as the loader pads
    rows_valid = torch.tensor(rng.random((b, n)) < 0.8, device=cuda)

    want = hull_iou.hull_quad_iou_matrix_plain(h, c, quads)
    assert same_bits(hull_iou.hull_quad_iou_matrix(h, c, quads), want)
    live = rows_valid[:, :, None] & gt_valid[:, None, :]
    want_m = hull_iou.hull_quad_iou_matrix_plain(h, c, quads, gt_valid,
                                                 rows_valid)
    assert same_bits(want_m, torch.where(live, want, -1.0))
    for gv, rv in ((gt_valid, rows_valid), (gt_valid, None),
                   (None, rows_valid)):
        got = hull_iou.hull_quad_iou_matrix(h, c, quads, gv, rv)
        assert got.shape == (b, n, g)
        assert same_bits(got, hull_iou.hull_quad_iou_matrix_plain(
            h, c, quads, gv, rv))
    got = hull_iou.hull_quad_iou_kernel(h, c, quads, gt_valid, rows_valid)
    assert got.shape == (b, g, n) and got.is_contiguous()
    assert (got[1] == -1).all() and (got[2][live[2].T] == 0).all()
    assert (got[0] > 0.1).sum() > 200
    # the wide hulls overlap many gts each
    assert ((got[0] > 0).sum(0) >= 10).sum() >= 20


def fwd_inputs(cuda, c, dtype):
    """Two tables, offsets and shapes for the DCN forward: a 1x1 level,
    rows (372) not a multiple of the kernel's 8 a block, and offsets that
    throw a tenth of the samples far outside the map."""
    rng = np.random.default_rng(5)
    shapes = [(2, 13, 11), (2, 7, 6), (2, 1, 1)]
    rows = sum(bb * hh * w for bb, hh, w in shapes)
    ta = torch.tensor(rng.normal(size=(rows, c)), device=cuda).to(dtype)
    tb = torch.tensor(rng.normal(size=(rows, c)), device=cuda).to(dtype)
    off = rng.normal(0, 3, (rows, 18))
    far = rng.random((rows, 18)) < 0.1
    off[far] = rng.choice([-60.0, 60.0], far.sum())
    off = torch.tensor(off, device=cuda).to(dtype)
    return ta, tb, off, shapes


def same_sampling(got, want, dtype, rows, c):
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == dtype and x.shape == (rows, 9 * c)
        assert torch.equal(x.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                           y.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))
        assert (y != 0).float().mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 64, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_deform_sample_kernel_bit_for_bit(cuda, c, dtype):
    """The DCN forward against its plain version, bit for bit: C 256 and
    64 take the 16-byte path, C 24 the scalar loop (fwd_inputs)."""
    ta, tb, off, shapes = fwd_inputs(cuda, c, dtype)
    got = deform_conv.deform_sample_pair(ta, tb, off, shapes)
    want = deform_conv.deform_sample_pair_plain(ta, tb, off, shapes)
    same_sampling(got, want, dtype, ta.shape[0], c)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 64, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_deform_sample_single_kernel_bit_for_bit(cuda, c, dtype):
    """The single-table DCN forward (deform_sample_kernel) against its
    plain version, bit for bit, on the pair test's inputs."""
    ta, _, off, shapes = fwd_inputs(cuda, c, dtype)
    launches = deform_conv.deform_sample_kernel.launches
    got = deform_conv.deform_sample(ta, off, shapes)
    assert deform_conv.deform_sample_kernel.launches == launches + 1
    want = deform_conv.deform_sample_plain(ta, off, shapes)
    same_sampling([got], [want], dtype, ta.shape[0], c)


def bwd_inputs(cuda, c, dtype):
    """Two tables, offsets, two f32 sample grads and shapes for the DCN
    backward: levels wider and taller than a tile with ragged edges, a
    level of width 1 and one of a single pixel; a tenth of the offsets
    thrown far off the map and a tenth thrown 6-12 px, onto the map but
    outside a tile's window."""
    rng = np.random.default_rng(8)
    shapes = [(2, 13, 37), (2, 9, 1), (2, 7, 19), (1, 1, 1)]
    rows = sum(bb * hh * w for bb, hh, w in shapes)
    ta = torch.tensor(rng.normal(size=(rows, c)), device=cuda).to(dtype)
    tb = torch.tensor(rng.normal(size=(rows, c)), device=cuda).to(dtype)
    off = rng.normal(0, 3, (rows, 18))
    pick = rng.random((rows, 18))
    off[pick < 0.1] = rng.choice([-60.0, 60.0], (pick < 0.1).sum())
    mid = (pick >= 0.1) & (pick < 0.2)
    off[mid] = rng.uniform(6, 12, mid.sum()) * rng.choice([-1.0, 1.0],
                                                          mid.sum())
    off = torch.tensor(off, device=cuda).to(dtype)
    ga = torch.tensor(rng.normal(size=(rows, 9 * c)), dtype=torch.float32,
                      device=cuda)
    gb = torch.tensor(rng.normal(size=(rows, 9 * c)), dtype=torch.float32,
                      device=cuda)
    return ta, tb, off, ga, gb, shapes


def on_the_cpu(plain, *args):
    """A plain version run on CPU copies of the card's tensors, its outputs
    back on the card: its index_add_ sums in the declared order there
    (tests/test_torch_dcn_order.py), whatever algorithm the card's takes."""
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    return [o.to(args[0].device) for o in plain(*cpu)]


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    as_int = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(as_int),
                                              b.contiguous().view(as_int))


def close_grads(got, want, dtype, shapes_of, dense=True):
    """Table grads (all outputs but the last) bit for bit: the kernel sums
    them in the plain version's order.  Offset grads (the last) sum over
    channels in the kernel's own order: within one rounding step of the
    dtype (f32: 1e-5) of their largest (chip_smoke.DCN_BWD_RTOL).
    dense: most of every wanted grad is nonzero (else at least one value
    of each)."""
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for i, (g, w, shape) in enumerate(zip(got, want, shapes_of)):
        assert g.dtype == w.dtype == dtype and g.shape == shape
        if i < len(got) - 1:
            assert bit_equal(g, w)
        else:
            scale = max(1.0, float(w.float().abs().max()))
            assert (g.float() - w.float()).abs().max() <= tol * scale
        assert (w != 0).float().mean() > (0.5 if dense else 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 48, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_deform_sample_backward_kernel_matches_plain(cuda, c, dtype):
    """The DCN backward against its plain version, f32 sample grads: C 256
    and 48 take the tile kernel, C 20 the scalar one (bwd_inputs,
    close_grads)."""
    ta, tb, off, ga, gb, shapes = bwd_inputs(cuda, c, dtype)
    rows = ta.shape[0]
    got = deform_conv.deform_sample_pair_backward(ta, tb, off, ga, gb, shapes)
    want = on_the_cpu(deform_conv.deform_sample_pair_backward_plain, ta, tb,
                      off, ga, gb, shapes)
    close_grads(got, want, dtype, ((rows, c), (rows, c), (rows, 18)))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 48, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_deform_sample_single_backward_kernel_matches_plain(cuda, c, dtype):
    """The single-table DCN backward (deform_sample_bwd_{tile,scalar})
    against its plain version on the pair test's inputs."""
    ta, _, off, ga, _, shapes = bwd_inputs(cuda, c, dtype)
    rows = ta.shape[0]
    launches = deform_conv.deform_sample_backward_kernel.launches
    got = deform_conv.deform_sample_backward(ta, off, ga, shapes)
    assert deform_conv.deform_sample_backward_kernel.launches == launches + 1
    want = on_the_cpu(deform_conv.deform_sample_backward_plain, ta, off, ga,
                      shapes)
    close_grads(got, want, dtype, ((rows, c), (rows, 18)))


def piled_inputs(cuda, c, dtype):
    """DCN backward inputs whose corners pile up: on a (1, 40, 48) level
    every sample goes near one pixel (17,280 entries on each of its four
    corners: the sort's pass in place in global memory), on a (2, 12, 20)
    level near one of three (~1.4k: its pass in shared memory), a (1, 1, 1)
    level; grads with -0.0 and 0.0 among them."""
    rng = np.random.default_rng(9)
    shapes = [(1, 40, 48), (2, 12, 20), (1, 1, 1)]
    rows = sum(b * h * w for b, h, w in shapes)
    base = deform_conv.dcn_base_offset(3).numpy().reshape(9, 2)
    offs = []
    for (b, h, w), targets in zip(shapes, ([[11, 17]],
                                           [[2, 3], [6, 10], [9, 2]],
                                           [[0, 0]])):
        yx = np.stack(np.meshgrid(np.arange(h), np.arange(w),
                                  indexing="ij"), -1).reshape(1, h * w, 1, 2)
        pick = rng.integers(0, len(targets), (b, h * w, 9))
        target = (np.array(targets, np.float64)[pick]
                  + rng.uniform(0, 1, (b, h * w, 9, 2)))
        offs.append((target - yx - base).reshape(-1, 18))
    off = torch.tensor(np.concatenate(offs), device=cuda).to(dtype)
    tabs = [torch.tensor(rng.normal(size=(rows, c)), device=cuda).to(dtype)
            for _ in range(2)]
    grads = []
    for _ in range(2):
        g = rng.normal(size=(rows, 9 * c)).astype(np.float32)
        pick = rng.random(g.shape)
        g[pick < 0.05] = -0.0
        g[(pick >= 0.05) & (pick < 0.1)] = 0.0
        grads.append(torch.tensor(g, device=cuda))
    return tabs, off, grads, shapes


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 48, 20, 22])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_tables", [2, 1], ids=["pair", "single"])
def test_deform_sample_backward_repeats_bit_for_bit(cuda, c, dtype,
                                                    n_tables):
    """The DCN backward (offset grads: tile kernel at C 256 and 48, scalar
    at 20 and 22; table grads: 16-byte sums where C is a multiple of 4,
    single columns at 22) on inputs that pile thousands of corners onto a
    few pixels: two launches give the same bits in every output, and the
    table grads are the plain version's (close_grads)."""
    tabs, off, grads, shapes = piled_inputs(cuda, c, dtype)
    if n_tables == 2:
        fn = deform_conv.deform_sample_pair_backward
        plain = deform_conv.deform_sample_pair_backward_plain
    else:
        fn = deform_conv.deform_sample_backward
        plain = deform_conv.deform_sample_backward_plain
    args = (*tabs[:n_tables], off, *grads[:n_tables], shapes)
    first = fn(*args)
    again = fn(*args)
    assert all(bit_equal(a, b) for a, b in zip(first, again))
    rows = off.shape[0]
    close_grads(first, on_the_cpu(plain, *args), dtype,
                [(rows, c)] * n_tables + [(rows, 18)], dense=False)


def rect_err(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row max corner distance over b's corner rotations/reversal."""
    a, b = a.view(-1, 4, 2), b.view(-1, 4, 2)
    return torch.stack([(a - bb.roll(s, 1)).abs().amax((1, 2))
                        for bb in (b, b.flip(1)) for s in range(4)]).amin(0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2047, 3001])
def test_min_area_rect_kernel_matches_plain(cuda, n):
    """The min-area rect (4 lanes a set, eight sets a warp) against its
    plain versions: n not a multiple of 8 (lanes past n), coincident sets, collinear
    sets, sets of two distinct points, sets with a duplicated hull vertex,
    and sets at ~3e4.  Hull and count exactly; rects within 1e-3 px, or a
    tie (the same area within the tie rule's relative 1e-5)."""
    from orientedreppoints_tpu_torch.ops.geometry import TIE_RTOL

    rng = np.random.default_rng(9)
    pts = rng.uniform(0, 1344, (n, 1, 2)) + rng.normal(0, 24, (n, 9, 2))
    m = n // 6
    pts[:m] = pts[:m, :1]  # coincident
    t = rng.integers(-8, 9, (m, 9, 1)).astype(np.float64)
    pts[m:2 * m] = np.round(pts[m:2 * m, :1]) + t * np.array([3.0, 1.0])
    pts[2 * m:3 * m, 2::2] = pts[2 * m:3 * m, :1]  # two distinct points
    pts[2 * m:3 * m, 3::2] = pts[2 * m:3 * m, 1:2]
    pts[3 * m:4 * m, 4:] = pts[3 * m:4 * m, 3:4]  # repeated vertices
    pts[4 * m:5 * m] += 3e4
    p = torch.tensor(pts.reshape(n, 18), dtype=torch.float32, device=cuda)
    rect, hull, count = minarearect.min_area_rect_kernel(p)
    hull_p, count_p = minarearect.convex_hull_plain(p)
    assert torch.equal(hull, hull_p) and torch.equal(count, count_p)
    want = minarearect.min_area_rect_plain(p)
    assert torch.isfinite(rect).all()
    err = rect_err(rect, want)
    off = err > 1e-3 * (1 + p.abs().amax(1) / 1e3)

    def area(r):
        r = r.view(-1, 4, 2).double()
        return (r[:, 1] - r[:, 0]).norm(dim=-1) * (r[:, 2] - r[:, 1]).norm(
            dim=-1)
    rel = (area(rect) - area(want)).abs() / area(want).clamp(min=1e-6)
    assert bool((rel[off] <= 2 * TIE_RTOL).all())
    if n > 6:
        assert (count[:m] == 1).all() and (count[m:2 * m] <= 2).all()
        assert (count[2 * m:3 * m] == 2).all()
        assert (count[5 * m:] > 3).float().mean() > 0.9


def nms_case_quads(rng, b, n):
    """Score-sorted-like NMS candidates (b, n, 8): jittered copies of n/8
    base boxes shifted by class to ~3e4, with identical quads (IoU exactly
    1), zero-area quads (four collinear points, and four equal points), and
    axis-aligned pairs at ~2.9e4 whose IoU lies within 1e-4 of 0.4."""
    base = rng.integers(0, n // 8, (b, n))
    c = rng.uniform(0, 1344, (b, n // 8, 2))[np.arange(b)[:, None], base]
    c = c + rng.normal(0, 8, (b, n, 2))
    wh = rng.uniform(16, 96, (b, n, 2))
    ang = rng.uniform(0, np.pi, (b, n))
    lx = np.array([-0.5, 0.5, 0.5, -0.5]) * wh[..., :1]
    ly = np.array([-0.5, -0.5, 0.5, 0.5]) * wh[..., 1:]
    cs, sn = np.cos(ang)[..., None], np.sin(ang)[..., None]
    q = np.stack([cs * lx - sn * ly + c[..., :1],
                  sn * lx + cs * ly + c[..., 1:]], -1).reshape(b, n, 8)
    q += (base % 15)[..., None] * 2000.0
    q[:, 1:40:3] = q[:, 0:39:3]  # identical neighbours
    t = np.arange(4)[:, None] * np.array([7.0, 3.0])
    q[:, 50:60] = (q[:, 50:60, None, :2] + t).reshape(b, 10, 8)  # collinear
    q[:, 60:70] = np.tile(q[:, 60:70, :2], 4)  # a point
    # IoU(a, a shifted by dx) = 0.4 at dx = 300 / 7 for 100 x 100 boxes; f32
    # steps of 2^-9 px at 2.9e4 move the IoU by ~2e-5
    dx = 300.0 / 7.0 + rng.uniform(-5e-3, 5e-3, (b, 20))
    sq = np.array([0, 0, 100, 0, 100, 100, 0, 100], np.float64)
    org = rng.uniform(0, 1000, (b, 20, 1)) * np.array([1.0, 0.0] * 4)
    q[:, 100:140:2] = sq + org + 29000.0
    q[:, 101:141:2] = sq + org + 29000.0 + np.array([1.0, 0.0] * 4) * \
        dx[..., None]
    return torch.tensor(q, dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 4100])
def test_over_mask_ragged_shapes_bit_for_bit(cuda, n):
    """The over-mask at N not a multiple of 64, with nv 0, mid-tile and N in
    one batch, against its plain version bit for bit; the single-image
    entry too."""
    rng = np.random.default_rng(6)
    q = nms_case_quads(rng, 3, n).to(cuda)
    nv = torch.tensor([n, 0, 517], dtype=torch.int32, device=cuda)
    got = quad_iou.quad_over_mask(q, 0.4, nv)
    want = quad_iou.quad_over_mask_plain(q, 0.4, nv)
    assert got.shape == (3, n, (n + 63) // 64)
    assert torch.equal(got, want)
    assert (want[1] == 0).all() and (want[2, 517:] == 0).all()
    bits = quad_iou.unpack_bits(want, n)
    assert bits[0].sum() > 1000 and bits[2].sum() > 50
    # the near-threshold pairs and the identical quads are in the case
    iou = quad_iou.quad_iou_pairs(q[0, 100:140:2], q[0, 101:141:2])
    assert ((iou - 0.4).abs() < 1e-4).all()
    assert bool(bits[0, 100:140:2, 101:141:2].diagonal().any())
    assert bool((~bits[0, 100:140:2, 101:141:2].diagonal()).any())
    assert bits[0, 0:39:3, 1:40:3].diagonal().all()
    single = quad_iou.quad_over_matrix(q[2], 0.4, nv[2])
    assert torch.equal(single, want[2])
    assert torch.equal(quad_iou.quad_over_matrix(q[0], 0.4), want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 4100])
def test_scan_ragged_cases_match_plain(cuda, n):
    """B 4 with distinct nv: a sparse mask with a fifth of the rows invalid
    inside the prefix, a mask in which row 0 suppresses every later row, an
    empty mask, a dense mask; N not a multiple of 64; valid rows past nv."""
    rng = np.random.default_rng(7)
    nv = np.array([n, 700, 333, 64 * 5 + 17], np.int32)
    over = np.triu(rng.random((4, n, n)) < np.array(
        [0.003, 0.0, 0.0, 0.3])[:, None, None], 1)
    over[1, 0, 1:] = True
    rows = np.arange(n)
    over &= (rows[None, :, None] < nv[:, None, None]) & (
        rows[None, None, :] < nv[:, None, None])
    valid = rng.random((4, n)) >= 0.2
    valid[1, 0] = True
    mask = quad_iou.pack_bits(torch.from_numpy(over)).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    nvt = torch.from_numpy(nv).to(cuda)
    got = nms.greedy_scan(mask, v, nvt)
    want = nms.greedy_scan_plain(mask, v, nvt)
    assert torch.equal(got, want)
    assert not want[1, 1:700].any() and want[1, 700:].sum() > 0
    assert torch.equal(want[2], v[2])
    assert 0 < want[3, :nv[3]].sum() < nv[3] // 2

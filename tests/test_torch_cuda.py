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
    backward is within the reordering of its f32 atomics."""
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
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
        ta = torch.randn(rows, 64, device=cuda).to(dt)
        tb = torch.randn(rows, 64, device=cuda).to(dt)
        off = (torch.randn(rows, 18, device=cuda) * 3).to(dt)
        ga = torch.randn(rows, 9 * 64, device=cuda).to(dt)
        gb = torch.randn(rows, 9 * 64, device=cuda).to(dt)
        got = deform_conv.deform_sample_pair_backward(ta, tb, off, ga, gb,
                                                      shapes)
        want = deform_conv.deform_sample_pair_backward_plain(
            ta, tb, off, ga, gb, shapes)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == dt
            scale = max(1.0, float(w.float().abs().max()))
            assert (g.float() - w.float()).abs().max() <= tol * scale

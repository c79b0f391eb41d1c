"""The port's horizontal-box NMS (ops/nms.py: hbb_iou_matrix(_legacy),
nms_hbb, soft_nms_hbb) against the JAX package's, on the CPU.

Seeded numpy boxes go through both.  Keep masks are compared exactly; IoU
matrices and decayed scores within 1e-6 absolute (f32; both sides compute
the same IoU op for op, XLA may round a fused product differently).  The
cases hold tied scores (JAX's order: the reverse of a stable ascending
argsort, so the higher index first), invalid rows, IoU exactly at the
threshold (nms_hbb suppresses at >=), both soft methods and max_keep.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.ops import nms as nms_ref
from orientedreppoints_tpu_torch.ops import nms

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def boxes_case(seed, n=160, tie_step=1 / 16):
    """Clustered x1y1x2y2 boxes on integer pixels (legacy IoUs hit exact
    values), scores in steps of tie_step, every seventh row invalid."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, 200, (n // 8, 2)).repeat(8, 0)[:n]
    xy = np.round(centres + rng.normal(0, 6, (n, 2)))
    wh = np.round(rng.uniform(4, 40, (n, 2)))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], 1).astype(np.float32)
    scores = (rng.integers(1, int(1 / tie_step), n) * tie_step).astype(
        np.float32)
    valid = np.arange(n) % 7 != 6
    return boxes, scores, valid


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("legacy", [False, True])
def test_hbb_iou_matrix(legacy):
    boxes, _, _ = boxes_case(0)
    a, b = boxes[:90], boxes[70:]
    ref_fn = nms_ref.hbb_iou_matrix_legacy if legacy else \
        nms_ref.hbb_iou_matrix
    fn = nms.hbb_iou_matrix_legacy if legacy else nms.hbb_iou_matrix
    ref = np.asarray(ref_fn(jnp.asarray(a), jnp.asarray(b)))
    got = fn(*t(a, b)).numpy()
    assert (ref > 0).sum() > 100
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("seed, thr", [(1, 0.5), (2, 0.3), (3, 0.7)])
def test_nms_hbb_keeps_as_jax(seed, thr):
    boxes, scores, valid = boxes_case(seed)
    ref = np.asarray(nms_ref.nms_hbb(jnp.asarray(boxes), jnp.asarray(scores),
                                     thr, jnp.asarray(valid)))
    got = nms.nms_hbb(*t(boxes, scores), thr, torch.from_numpy(valid))
    assert 0 < ref.sum() < valid.sum() and not ref[~valid].any()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_nms_hbb_ties_and_inclusive_threshold():
    """Two equal boxes of equal score: the higher index is kept; a pair at
    IoU exactly thr is suppressed (>=); without valid every row counts."""
    boxes = np.float32([[0, 0, 9, 9], [0, 0, 9, 9], [20, 0, 29, 9],
                        [25, 0, 34, 9], [50, 50, 60, 60]])
    scores = np.float32([0.5, 0.5, 0.9, 0.8, 0.1])
    iou = np.asarray(nms_ref.hbb_iou_matrix_legacy(jnp.asarray(boxes),
                                                   jnp.asarray(boxes)))
    thr = float(iou[2, 3])  # the legacy IoU of boxes 2 and 3, exactly
    ref = np.asarray(nms_ref.nms_hbb(jnp.asarray(boxes),
                                     jnp.asarray(scores), thr))
    got = nms.nms_hbb(*t(boxes, scores), thr).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [False, True, True, False, True])


@pytest.mark.parametrize("method, max_keep", [("linear", None),
                                              ("gaussian", None),
                                              ("linear", 20)])
def test_soft_nms_hbb_as_jax(method, max_keep):
    boxes, scores, valid = boxes_case(4, n=120)
    ref_s, ref_k = nms_ref.soft_nms_hbb(
        jnp.asarray(boxes), jnp.asarray(scores), iou_thr=0.3,
        method=method, valid=jnp.asarray(valid), max_keep=max_keep,
        min_score=0.05)
    got_s, got_k = nms.soft_nms_hbb(*t(boxes, scores), iou_thr=0.3,
                                    method=method,
                                    valid=torch.from_numpy(valid),
                                    max_keep=max_keep, min_score=0.05)
    ref_s, ref_k = np.asarray(ref_s), np.asarray(ref_k)
    assert 0 < ref_k.sum() < valid.sum()
    np.testing.assert_array_equal(got_k.numpy(), ref_k)
    np.testing.assert_allclose(got_s.numpy(), ref_s, rtol=0, atol=TOL)

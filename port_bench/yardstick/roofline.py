"""The least time of one launch of each hand-written kernel, from the
shapes of its call: every input byte read once and every output byte
written once at the HBM peak, or, where the shapes alone fix the
arithmetic (the DCN sampling), its float32 operations at the CUDA-core
peak, whichever is longer.  Data-dependent work (clipping, hull walks,
the scan's suppressions) is not counted, so a kernel that skips work
never reads above 100%; the rows past an image's valid prefix, which the
decode kernels skip, are not counted either.

Each function takes the call's recorded arguments: a tensor as
("tensor", shape, element size), a count an image as ("values", counts),
anything else as given.
"""

from __future__ import annotations

import math

from . import peaks


def _nbytes(t) -> int:
    if t is None:
        return 0
    _, shape, elem = t
    return math.prod(shape) * elem


def _least(nbytes: float, ops: float = 0.0) -> float:
    return max(nbytes / peaks.HBM_BYTES, ops / peaks.FP32_OPS)


def min_area_rect(points):
    """(n, 18) f32 point sets -> rects (n, 8), hulls (n, 9, 2), counts."""
    n = points[1][0]
    return _least(_nbytes(points) + n * (8 + 18) * 4 + n * 4)


def _prefixes(num_valid) -> list[int]:
    """Each image's valid rows: ("values", its (B,) counts) -> [rows]."""
    return [int(v) for v in num_valid[1].tolist()]


def _words(rows: int) -> int:
    return (rows + 63) // 64


def quad_over_mask(quads, iou_thr, num_valid):
    """(B, N, 8) quads, (B,) prefixes -> (B, N, ceil(N / 64)) int64; the
    rows and words past an image's prefix are the launcher's memset, not
    the kernel's: an image of r valid rows needs r quads read and r x
    ceil(r / 64) words written."""
    b = quads[1][0]
    return _least(4 * b + sum(r * 32 + r * _words(r) * 8
                              for r in _prefixes(num_valid)))


def greedy_scan(mask, valid, num_valid):
    """(B, N, W) bitmask, (B, N) valid, (B,) prefixes -> (B, N) keep; of
    the mask, an image of r valid rows needs r x ceil(r / 64) words."""
    b, n = valid[1]
    return _least(sum(r * _words(r) * 8 for r in _prefixes(num_valid))
                  + _nbytes(valid) + 4 * b + b * n)


def hull_quad_iou(hulls, counts, quads, gt_valid=None, rows_valid=None):
    """(B, N, 9, 2) hulls, (B, N) counts, (B, G, 8) quads, masks ->
    (B, G, N) f32."""
    b, n = counts[1]
    g = quads[1][1]
    return _least(_nbytes(hulls) + _nbytes(counts) + _nbytes(quads)
                  + _nbytes(gt_valid) + _nbytes(rows_valid) + b * g * n * 4)


def convex_giou(points, quads, weight=None):
    """(n, 18) point sets, (n, 8) gt quads -> GIoU (n,); with the (n,)
    weights also the weighted gradient (n, 18).  The hull walks and clips
    depend on the data and are not counted: bytes alone."""
    n = points[1][0]
    grad = weight is not None
    return _least(_nbytes(points) + _nbytes(quads) + _nbytes(weight)
                  + n * 4 + (n * 18 * 4 if grad else 0))


def _dcn(table_a, offsets, kernel_size, n_tables, backward, grad=None):
    rows, c = table_a[1]
    e = table_a[2]
    k = kernel_size * kernel_size
    tables, offs = n_tables * rows * c * e, rows * 2 * k * e
    if backward:
        # in: tables, offsets, the buffers' f32 grads; out: the tables'
        # f32 grads and the offsets' grad
        nbytes = tables + offs + n_tables * _nbytes(grad) + \
            n_tables * rows * c * 4 + offs
        ops = rows * k * (30 + 22 * n_tables * c)
    else:
        nbytes = tables + offs + n_tables * rows * k * c * e
        ops = rows * k * (30 + 7 * n_tables * c)
    return _least(nbytes, ops)


def deform_sample_pair(table_a, table_b, offsets, shapes, kernel_size=3):
    """Two (rows, C) tables sampled at (rows, 2K) offsets -> two (rows,
    K C) buffers; per sample 30 operations of plan, per channel and table 7
    (four weighted corners)."""
    return _dcn(table_a, offsets, kernel_size, 2, False)


def deform_sample_pair_backward(table_a, table_b, offsets, grad_a, grad_b,
                                shapes, kernel_size=3):
    """Per channel and table 22 operations (four weighted scatters, two
    corner differences and their products with the grad)."""
    return _dcn(table_a, offsets, kernel_size, 2, True, grad_a)

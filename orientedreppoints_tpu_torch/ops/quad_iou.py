"""Exact quad-quad IoU for rotated NMS (counterpart of
ops/pallas_quad_iou.py: ``quad_iou_matrix_pallas`` and
``quad_iou_matrix_batch_pallas`` with their kernels ``_quad_kernel`` and
``_make_quad_kernel_tri``, and the over-mask entries
``quad_over_matrix_pallas`` / ``quad_over_matrix_batch_pallas`` with
``_make_quad_over_kernel``).

Every entry evaluates one pair function, the Pallas tile's quad IoU
(``quad_iou_pairs``: subject quad of the row, clip quad of the column).  The
CUDA kernels evaluate it with csrc/clip_ring.cuh (one thread a row over a
64 x 64 tile of clip quads staged in shared memory), in the same order of
operations, built with -fmad=false, so a kernel and its plain version give
the same bits:

  * quad_iou_matrix / quad_iou_matrix_batch: the f32 (N, M) matrix, in full
    (csrc/quad_iou.cu, orp_quad_iou_full) or, with upper_tri, only where
    col > row inside the valid prefix num_valid, zeros elsewhere
    (orp_quad_iou_tri);
  * quad_over_mask / quad_over_matrix: for score-sorted quads (B, N, 8) and
    valid-prefix lengths nv (B,), (B, N, W) int64 words with
    W = ceil(N / 64): bit t of word w in row i is set iff IoU(i, 64 w + t)
    > thr (strict), the column is right of the diagonal, and both lie
    inside the prefix (csrc/quad_over.cu); quad_over_matrix is the
    single-image entry, a batch-1 launch.

Each entry runs its CUDA kernel for CUDA tensors and the plain PyTorch
version for CPU tensors; the over-mask does so as the custom op
orp::quad_over_mask, which torch.export keeps whole.
"""

from __future__ import annotations

import torch

from . import _ext
from .hull_iou import _hull_quad_iou_pairs

_CHUNK_PAIRS = 1 << 20  # pairs the plain versions hold at once


def quad_iou_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of broadcast quad pairs (..., 8) x (..., 8), subject a and clip
    quad b, in the Pallas tile's order of operations: recentre on b's
    vertex 0, a's shoelace, b turned counter-clockwise ((4 - k) % 4), clip
    stages with caps 5-8, masked shoelace, max(union, 1e-8).  A quad is a
    hull of count 4 in 4 slots."""
    a, b = torch.broadcast_tensors(a.to(torch.float32), b.to(torch.float32))
    cnt = torch.full(a.shape[:-1], 4, dtype=torch.int32, device=a.device)
    return _hull_quad_iou_pairs(a[..., 0::2], a[..., 1::2], cnt, b)


def _live(rows, cols, nv):
    """The upper-triangle, valid-prefix mask of the tri entries."""
    return (cols > rows) & (rows < nv) & (cols < nv)


def quad_iou_matrix_plain(a, b, upper_tri: bool = False, num_valid=None):
    """Plain version of quad_iou_matrix_batch: rows in chunks of about
    _CHUNK_PAIRS pairs; with upper_tri only the rows inside the prefix."""
    bsz, n, _ = a.shape
    m = b.shape[1]
    out = torch.zeros((bsz, n, m), dtype=torch.float32, device=a.device)
    rows_needed = n
    if upper_tri:
        nv = num_valid.to(torch.int64).reshape(bsz, 1, 1)
        rows_needed = min(n, int(num_valid.max())) if bsz else 0
    cols = torch.arange(m, device=a.device)[None, None, :]
    step = max(1, _CHUNK_PAIRS // max(1, bsz * m))
    for r0 in range(0, rows_needed, step):
        r1 = min(rows_needed, r0 + step)
        iou = quad_iou_pairs(a[:, r0:r1, None, :], b[:, None, :, :])
        if upper_tri:
            rows = torch.arange(r0, r1, device=a.device)[None, :, None]
            iou = torch.where(_live(rows, cols, nv), iou, 0.0)
        out[:, r0:r1] = iou
    return out


def quad_iou_matrix_batch(a: torch.Tensor, b: torch.Tensor,
                          upper_tri: bool = False,
                          num_valid: torch.Tensor | None = None):
    """(B, N, 8) x (B, M, 8) float32 quads -> (B, N, M) float32 IoU.

    upper_tri: only entries with col > row inside the valid prefix
    num_valid ((B,) int32, default N), zeros elsewhere; without it
    num_valid is ignored, as in the JAX package.
    """
    if upper_tri and num_valid is None:
        num_valid = torch.full((a.shape[0],), a.shape[1], dtype=torch.int32,
                               device=a.device)
    if a.device.type == "cpu":
        return quad_iou_matrix_plain(a, b, upper_tri, num_valid)
    if upper_tri:
        return quad_iou_tri_kernel(a, b, num_valid)
    return quad_iou_full_kernel(a, b)


def quad_iou_matrix(a: torch.Tensor, b: torch.Tensor, upper_tri: bool = False,
                    num_valid=None):
    """(N, 8) x (M, 8) -> (N, M) float32 IoU; num_valid a scalar (int or
    0-d tensor), see quad_iou_matrix_batch."""
    if num_valid is not None:
        num_valid = torch.as_tensor(num_valid, dtype=torch.int32,
                                    device=a.device).reshape(1)
    return quad_iou_matrix_batch(a[None], b[None], upper_tri, num_valid)[0]


def quad_iou_full_kernel(a, b):
    bsz, n, _ = a.shape
    m = b.shape[1]
    _ext.check_cuda(a, "quads_a", torch.float32, (bsz, n, 8))
    _ext.check_cuda(b, "quads_b", torch.float32, (bsz, m, 8), a.device)
    out = torch.empty((bsz, n, m), dtype=torch.float32, device=a.device)
    _ext.launch("orp_quad_iou_full", a.data_ptr(), b.data_ptr(),
                out.data_ptr(), bsz, n, m, on=a)
    quad_iou_full_kernel.launches += 1
    return out


quad_iou_full_kernel.launches = 0


def quad_iou_tri_kernel(a, b, num_valid):
    bsz, n, _ = a.shape
    m = b.shape[1]
    _ext.check_cuda(a, "quads_a", torch.float32, (bsz, n, 8))
    _ext.check_cuda(b, "quads_b", torch.float32, (bsz, m, 8), a.device)
    _ext.check_cuda(num_valid, "num_valid", torch.int32, (bsz,), a.device)
    out = torch.empty((bsz, n, m), dtype=torch.float32, device=a.device)
    _ext.launch("orp_quad_iou_tri", a.data_ptr(), b.data_ptr(),
                num_valid.data_ptr(), out.data_ptr(), bsz, n, m, on=a)
    quad_iou_tri_kernel.launches += 1
    return out


quad_iou_tri_kernel.launches = 0


def pack_bits(over: torch.Tensor) -> torch.Tensor:
    """(..., N) bool -> (..., ceil(N/64)) int64 words, bit t = column t."""
    n = over.shape[-1]
    words = (n + 63) // 64
    x = torch.nn.functional.pad(over, (0, words * 64 - n))
    x = x.reshape(over.shape[:-1] + (words, 64)).to(torch.int64)
    shifts = torch.arange(64, device=over.device, dtype=torch.int64)
    return (x << shifts).sum(-1)  # distinct bits: the sum is the OR


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of pack_bits: (..., W) int64 -> (..., n) bool."""
    shifts = torch.arange(64, device=words.device, dtype=torch.int64)
    bits = (words[..., None] >> shifts) & 1
    return bits.flatten(-2)[..., :n].bool()


def quad_over_mask_plain(quads: torch.Tensor, iou_thr: float,
                         num_valid: torch.Tensor) -> torch.Tensor:
    """Plain version: pack_bits(tri IoU > thr), the tri IoU of the plain
    quad_iou_matrix over row chunks."""
    b, n, _ = quads.shape
    words = (n + 63) // 64
    out = torch.zeros((b, n, words), dtype=torch.int64, device=quads.device)
    nv = num_valid.to(torch.int64).reshape(b, 1, 1)
    cols = torch.arange(n, device=quads.device)[None, None, :]
    rows_needed = min(n, int(num_valid.max())) if b else 0
    step = max(1, _CHUNK_PAIRS // max(1, b * n))
    for r0 in range(0, rows_needed, step):
        r1 = min(r0 + step, rows_needed)
        iou = quad_iou_pairs(quads[:, r0:r1, None, :], quads[:, None, :, :])
        rows = torch.arange(r0, r1, device=quads.device)[None, :, None]
        out[:, r0:r1] = pack_bits((iou > iou_thr) & _live(rows, cols, nv))
    return out


@torch.library.custom_op("orp::quad_over_mask", mutates_args=(),
                         device_types="cpu")
def quad_over_mask(quads: torch.Tensor, iou_thr: float,
                   num_valid: torch.Tensor) -> torch.Tensor:
    """(B, N, 8) float32 score-sorted quads, (B,) int32 prefix lengths ->
    (B, N, ceil(N/64)) int64 suppression bitmask: the custom op
    orp::quad_over_mask."""
    return quad_over_mask_plain(quads, iou_thr, num_valid)


@quad_over_mask.register_kernel("cuda")
def _(quads, iou_thr, num_valid):
    return quad_over_mask_kernel(quads, iou_thr, num_valid)


@quad_over_mask.register_fake
def _(quads, iou_thr, num_valid):
    b, n = quads.shape[:2]
    return quads.new_empty((b, n, (n + 63) // 64), dtype=torch.int64)


def quad_over_matrix(quads: torch.Tensor, iou_thr: float, num_valid=None):
    """Single-image entry: (N, 8) score-sorted quads, prefix length (int or
    0-d tensor, default N) -> (N, ceil(N/64)) int64 bitmask; one batch-1
    launch of the over-mask kernel on CUDA."""
    n = quads.shape[0]
    nv = torch.as_tensor(n if num_valid is None else num_valid,
                         dtype=torch.int32, device=quads.device).reshape(1)
    return quad_over_mask(quads[None], iou_thr, nv)[0]


def quad_over_mask_kernel(quads: torch.Tensor, iou_thr: float,
                          num_valid: torch.Tensor) -> torch.Tensor:
    b, n, _ = quads.shape
    _ext.check_cuda(quads, "quads", torch.float32, (b, n, 8))
    _ext.check_cuda(num_valid, "num_valid", torch.int32, (b,), quads.device)
    words = (n + 63) // 64
    out = torch.empty((b, n, words), dtype=torch.int64, device=quads.device)
    _ext.launch("orp_quad_over_mask", quads.data_ptr(), num_valid.data_ptr(),
                out.data_ptr(), b, n, float(iou_thr), on=quads)
    quad_over_mask_kernel.launches += 1
    return out


quad_over_mask_kernel.launches = 0

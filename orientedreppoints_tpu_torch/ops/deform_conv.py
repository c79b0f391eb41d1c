"""Deformable conv over an FPN pyramid: the paired form (counterpart of
ops/deform_conv.py::deform_conv2d_pyramid_pair) and the single one.

Every (level, image, pixel) of the pyramid is one row of a flat
(rows, C) feature table.  Both DCN instances of the head (cls and refine)
sample at the same offsets, so one bilinear plan drives the gathers from
both tables; each gives a (rows, K*C) im2col buffer that is multiplied by
its (K*C, Cout) weight.  Offsets are (dy, dx) pairs per kernel position,
relative to the base grid; coordinates are f32 whatever the table dtype,
and corners outside the map read zero.

``deform_sample_pair`` (the custom op orp::deform_sample_pair) runs the
CUDA kernel (csrc/deform_sample.cu: one warp a row, 16-byte chunks of
channels, or a scalar loop where C does not split into them; the same bits
as the plain version) for CUDA tensors and the plain PyTorch gather + lerp
for CPU tensors; its
backward ``deform_sample_pair_backward`` likewise runs
csrc/deform_sample_bwd.cu or the plain scatter.  ``DeformSamplePair`` is the
whole paired DCN as one autograd node over (table_a, table_b, offsets,
weight_a, weight_b), the counterpart of the JAX package's ``_pair_core``
custom_vjp: it owns the two matmuls, so that the sample grads reach the
backward kernel in f32 and the weight grads are f32 sums returned in the
weights' dtype, as ``_pair_core_bwd`` computes them.  Only the JAX
package's default variants are ported (not ORP_DCN_GATHER=fused,
ORP_PAIR_GATHER=cat or ORP_PAIR_SCATTER=window).

The single DCNv1 (``deform_conv2d``, ``deform_conv2d_pyramid``, the JAX
package's functions of those names) is ``DeformSample``, the same node for
one table: ``deform_sample`` / ``deform_sample_backward`` launch the same
two kernels instantiated for one table, or run the pair's plain versions
for one table on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _ext

_KERNEL_DTYPES = {torch.float32: "orp_deform_sample_pair_f32",
                  torch.bfloat16: "orp_deform_sample_pair_bf16"}
_BWD_KERNEL_DTYPES = {torch.float32: "orp_deform_sample_pair_bwd_f32",
                      torch.bfloat16: "orp_deform_sample_pair_bwd_bf16"}
# the same kernels instantiated for one table
_SINGLE_KERNEL_DTYPES = {torch.float32: "orp_deform_sample_f32",
                         torch.bfloat16: "orp_deform_sample_bf16"}
_SINGLE_BWD_KERNEL_DTYPES = {torch.float32: "orp_deform_sample_bwd_f32",
                             torch.bfloat16: "orp_deform_sample_bwd_bf16"}


def dcn_base_offset(kernel_size: int = 3) -> torch.Tensor:
    """(2K,) base grid offsets as (dy, dx) pairs, k row-major."""
    pad = (kernel_size - 1) // 2
    base = torch.arange(-pad, pad + 1, dtype=torch.float32)
    base_y = base.repeat_interleave(kernel_size)
    base_x = base.repeat(kernel_size)
    return torch.stack([base_y, base_x], 1).reshape(-1)


def pyramid_plan(shapes, offsets: torch.Tensor, kernel_size: int = 3):
    """Bilinear plan for every (row, k) sample, rows-major then k.

    shapes: per-level (B, H, W); offsets: (rows, 2K) flat over levels.
    Returns (idx: 4 x (rows*K,) int64 table rows, ok: 4 x bool,
    wy, wx: (rows*K,) f32).
    """
    k = kernel_size * kernel_size
    base = dcn_base_offset(kernel_size).to(offsets.device)
    dev = offsets.device
    idxs, oks, wys, wxs = [[], [], [], []], [[], [], [], []], [], []
    start = 0
    for b, h, w in shapes:
        rows = b * h * w
        off = (offsets[start:start + rows].to(torch.float32) + base)
        off = off.reshape(b, h, w, k, 2)
        iy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None,
                                                              None]
        ix = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :,
                                                              None]
        py = (off[..., 0] + iy).reshape(b, -1)
        px = (off[..., 1] + ix).reshape(b, -1)
        y0f, x0f = torch.floor(py), torch.floor(px)
        wys.append((py - y0f).reshape(-1))
        wxs.append((px - x0f).reshape(-1))
        # clamp before the int conversion; beyond [-1, h] is out either way
        y0 = y0f.clamp(-2, h + 1).to(torch.int64)
        x0 = x0f.clamp(-2, w + 1).to(torch.int64)
        row0 = (torch.arange(b, device=dev) * (h * w) + start)[:, None]
        ci = 0
        for dy in (0, 1):
            for dx in (0, 1):
                yy, xx = y0 + dy, x0 + dx
                oks[ci].append(((yy >= 0) & (yy < h) & (xx >= 0)
                                & (xx < w)).reshape(-1))
                idxs[ci].append((yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
                                 + row0).reshape(-1))
                ci += 1
        start += rows
    return ([torch.cat(x) for x in idxs], [torch.cat(x) for x in oks],
            torch.cat(wys), torch.cat(wxs))


def _sample_plain(tables, offsets, shapes, kernel_size):
    """Plain sampling of each table with one plan: four corner gathers
    per table, lerp in f32, one rounding to the table dtype."""
    k = kernel_size * kernel_size
    c = tables[0].shape[1]
    idx, ok, wy, wx = pyramid_plan(shapes, offsets, kernel_size)
    weights = ((1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx)
    outs = []
    for table in tables:
        acc = torch.zeros((idx[0].shape[0], c), dtype=torch.float32,
                          device=table.device)
        for i, o, cw in zip(idx, ok, weights):
            acc += table[i].to(torch.float32) * torch.where(o, cw, 0.0)[:,
                                                                      None]
        outs.append(acc.to(table.dtype).reshape(-1, k * c))
    return outs


def deform_sample_pair_plain(table_a, table_b, offsets, shapes,
                             kernel_size: int = 3):
    """Plain version: four corner gathers per table, lerp in f32, one
    rounding to the table dtype."""
    out_a, out_b = _sample_plain((table_a, table_b), offsets, shapes,
                                 kernel_size)
    return out_a, out_b


def deform_sample_plain(table, offsets, shapes, kernel_size: int = 3):
    """Plain version of the single-table sampling: the pair's arithmetic
    for one table."""
    return _sample_plain((table,), offsets, shapes, kernel_size)[0]


def deform_sample_pair(table_a: torch.Tensor, table_b: torch.Tensor,
                       offsets: torch.Tensor, shapes, kernel_size: int = 3):
    """(rows, C) tables + (rows, 2K) offsets -> two (rows, K*C) im2col
    buffers in the table dtype.  shapes: per-level (B, H, W).  The custom
    op orp::deform_sample_pair, which takes the shapes flat."""
    flat = [int(v) for shape in shapes for v in shape]
    return _deform_sample_pair_op(table_a, table_b, offsets, flat,
                                  kernel_size)


def _levels(flat):
    return [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]


@torch.library.custom_op("orp::deform_sample_pair", mutates_args=(),
                         device_types="cpu")
def _deform_sample_pair_op(table_a: torch.Tensor, table_b: torch.Tensor,
                           offsets: torch.Tensor, shapes: list[int],
                           kernel_size: int) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    return deform_sample_pair_plain(table_a, table_b, offsets,
                                    _levels(shapes), kernel_size)


@_deform_sample_pair_op.register_kernel("cuda")
def _(table_a, table_b, offsets, shapes, kernel_size):
    return deform_sample_pair_kernel(table_a, table_b, offsets,
                                     _levels(shapes), kernel_size)


@_deform_sample_pair_op.register_fake
def _(table_a, table_b, offsets, shapes, kernel_size):
    k = kernel_size * kernel_size
    out = (table_a.shape[0], k * table_a.shape[1])
    return table_a.new_empty(out), table_b.new_empty(out)


def _sample_kernel(what, entries, tables, offsets, shapes, kernel_size):
    """Launch the sampling kernel over one or two tables (entries: the
    C entry by dtype) -> one (rows, K*C) buffer a table."""
    table = tables[0]
    rows, c = table.shape
    k = kernel_size * kernel_size
    if table.dtype not in entries:
        raise TypeError(f"{what}: no kernel for {table.dtype}")
    if sum(b * h * w for b, h, w in shapes) != rows:
        raise ValueError(f"{what}: shapes do not cover the table")
    if 2 * k > 32:  # a lane of the warp holds each of the row's offsets
        raise ValueError(f"{what}: kernel_size {kernel_size} above 4 is not "
                         "supported by the kernel")
    named = [(f"table_{x}", t, (rows, c)) for x, t in zip("ab", tables)]
    for name, t, shape in named + [("offsets", offsets, (rows, 2 * k))]:
        _ext.check_cuda(t, name, table.dtype, shape, table.device)
    outs = [torch.empty((rows, k * c), dtype=table.dtype, device=table.device)
            for _ in tables]
    ptrs = [t.data_ptr() for t in tables]
    out_ptrs = [o.data_ptr() for o in outs]
    if len(tables) == 1:  # the single-table entry ignores the b pointers
        ptrs, out_ptrs = ptrs * 2, out_ptrs * 2
    _ext.launch(entries[table.dtype], ptrs[0], ptrs[1], offsets.data_ptr(),
                _levels_arg(shapes), out_ptrs[0], out_ptrs[1], rows, c, k,
                len(shapes), on=table)
    return outs


def deform_sample_pair_kernel(table_a, table_b, offsets, shapes,
                              kernel_size: int = 3):
    out_a, out_b = _sample_kernel("deform_sample_pair", _KERNEL_DTYPES,
                                  (table_a, table_b), offsets, shapes,
                                  kernel_size)
    deform_sample_pair_kernel.launches += 1
    return out_a, out_b


deform_sample_pair_kernel.launches = 0


def deform_sample_kernel(table, offsets, shapes, kernel_size: int = 3):
    """The single-table sampling kernel (csrc/deform_sample.cu at one
    table): one (rows, K*C) im2col buffer in the table dtype."""
    out = _sample_kernel("deform_sample", _SINGLE_KERNEL_DTYPES, (table,),
                         offsets, shapes, kernel_size)[0]
    deform_sample_kernel.launches += 1
    return out


deform_sample_kernel.launches = 0


def deform_sample(table, offsets, shapes, kernel_size: int = 3):
    """(rows, C) table + (rows, 2K) offsets -> one (rows, K*C) im2col
    buffer in the table dtype; the kernel for CUDA tensors, the plain
    version for CPU tensors.  shapes: per-level (B, H, W)."""
    if table.device.type == "cpu":
        return deform_sample_plain(table, offsets, shapes, kernel_size)
    return deform_sample_kernel(table, offsets, shapes, kernel_size)


def _levels_arg(shapes):
    """Host int array of (first row, h, w) per level for the kernels."""
    levels, start = [], 0
    for b, h, w in shapes:
        levels += [start, h, w]
        start += b * h * w
    return (ctypes.c_int * len(levels))(*levels)


def deform_sample_pair_backward_plain(table_a, table_b, offsets, grad_a,
                                      grad_b, shapes, kernel_size: int = 3):
    """Plain version of the backward of deform_sample_pair.

    grad_a, grad_b: (rows, K*C) f32 grads of the two im2col buffers.
    Returns the grads of table_a, table_b (rows, C) and offsets (rows, 2K)
    in their dtypes.  Table grads: per corner, the grad rounded to the table
    dtype (the JAX package's gs_a_dt) * lerp weight, scattered into an f32
    (rows, 2C) table (both instances side by side, as the JAX package
    scatters them), rounded once.  The scatter adds corner 0..3 in turn,
    each corner's samples (row * K + tap) in ascending order, one term
    after another from +0.0 (index_add_ on the CPU; on the card under
    PyTorch's deterministic algorithms): the order csrc/deform_sample_bwd.cu
    sums in, so the kernel's table grads are these bit for bit.  Offset
    grads: (dy, dx) per sample, the f32 sum over channels and both
    instances of the f32 grad * d(sample)/d(coord).
    """
    *gtabs, goff = _sample_backward_plain((table_a, table_b), offsets,
                                          (grad_a, grad_b), shapes,
                                          kernel_size)
    return gtabs[0], gtabs[1], goff


def _sample_backward_plain(tables, offsets, grads, shapes, kernel_size):
    """The plain backward over one or two tables sampled with one plan:
    each table's grad (the tables' f32 scatters side by side, rounded
    once), then the offsets' grad."""
    k = kernel_size * kernel_size
    rows, c = tables[0].shape
    idx, ok, wy, wx = pyramid_plan(shapes, offsets, kernel_size)
    okf = [o.to(torch.float32) for o in ok]
    weights = ((1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx)
    grads = [g.reshape(-1, c).to(torch.float32) for g in grads]
    rounded = [g.to(t.dtype).to(torch.float32)
               for g, t in zip(grads, tables)]
    gtab = torch.zeros((rows, len(tables) * c), dtype=torch.float32,
                       device=tables[0].device)
    for i, o, cw in zip(idx, okf, weights):
        w = (cw * o)[:, None]
        gtab.index_add_(0, i, torch.cat([r * w for r in rounded], 1))
    del rounded
    gwy = torch.zeros_like(wy)
    gwx = torch.zeros_like(wx)
    for table, g in zip(tables, grads):
        v = [table[i].to(torch.float32) * o[:, None]
             for i, o in zip(idx, okf)]
        ddy = (v[2] - v[0]) * (1 - wx)[:, None] + (v[3] - v[1]) * wx[:, None]
        ddx = (v[1] - v[0]) * (1 - wy)[:, None] + (v[3] - v[2]) * wy[:, None]
        gwy += (g * ddy).sum(-1)
        gwx += (g * ddx).sum(-1)
        del v, ddy, ddx
    goff = torch.stack([gwy, gwx], -1).reshape(rows, 2 * k)
    return (*(gtab[:, j * c:(j + 1) * c].to(t.dtype)
              for j, t in enumerate(tables)), goff.to(offsets.dtype))


def deform_sample_backward_plain(table, offsets, grad, shapes,
                                 kernel_size: int = 3):
    """Plain version of the single-table backward: the pair's arithmetic
    for one table.  grad: (rows, K*C) f32.  Returns the grads of table
    (rows, C) and offsets (rows, 2K) in their dtypes."""
    return _sample_backward_plain((table,), offsets, (grad,), shapes,
                                  kernel_size)


def deform_sample_pair_backward(table_a, table_b, offsets, grad_a, grad_b,
                                shapes, kernel_size: int = 3):
    """Grads of (table_a, table_b, offsets) from the f32 grads of the two
    im2col buffers; the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if table_a.device.type == "cpu":
        return deform_sample_pair_backward_plain(
            table_a, table_b, offsets, grad_a, grad_b, shapes, kernel_size)
    return deform_sample_pair_backward_kernel(
        table_a, table_b, offsets, grad_a, grad_b, shapes, kernel_size)


def _bwd_work_bytes(rows: int, k: int) -> int:
    """Bytes of the backward kernel's workspace (csrc/deform_sample_bwd.cu,
    work_layout): a count and a segment start a row, a sum a scan chunk of
    4,096 rows, and a key and a weight for each of the 4 corners of the
    rows * k samples, each part 16-byte aligned."""
    def a16(n):
        return (n + 15) // 16 * 16
    entries = 4 * rows * k
    seg = a16(4 * rows)
    bsum = a16(seg + 4 * (rows + 1))
    keys = a16(bsum + 4 * ((rows + 1 + 4095) // 4096))
    wgt = a16(keys + 4 * entries)
    return a16(wgt + 4 * entries)


def _sample_backward_kernel(what, entries, tables, offsets, grads, shapes,
                            kernel_size):
    """Launch the sampling backward over one or two tables -> the tables'
    grads, then the offsets' grad."""
    table = tables[0]
    rows, c = table.shape
    k = kernel_size * kernel_size
    if table.dtype not in entries:
        raise TypeError(f"{what}: no kernel for {table.dtype}")
    if sum(b * h * w for b, h, w in shapes) != rows:
        raise ValueError(f"{what}: shapes do not cover the table")
    named = [(f"table_{x}", t, (rows, c)) for x, t in zip("ab", tables)]
    for name, t, shape in named + [("offsets", offsets, (rows, 2 * k))]:
        _ext.check_cuda(t, name, table.dtype, shape, table.device)
    for x, g in zip("ab", grads):
        _ext.check_cuda(g, f"grad_{x}", torch.float32, (rows, k * c),
                        table.device)
    # the tables' grads side by side in f32, every value written by the
    # kernel; the workspace of its entries
    gtab = torch.empty((rows, len(tables) * c), dtype=torch.float32,
                       device=table.device)
    goff = torch.empty((rows, 2 * k), dtype=table.dtype, device=table.device)
    work_bytes = _bwd_work_bytes(rows, k)
    work = torch.empty((work_bytes,), dtype=torch.uint8, device=table.device)
    ptrs = [t.data_ptr() for t in tables]
    gptrs = [g.data_ptr() for g in grads]
    if len(tables) == 1:  # the single-table entry ignores the b pointers
        ptrs, gptrs = ptrs * 2, gptrs * 2
    _ext.launch(entries[table.dtype], ptrs[0], ptrs[1], offsets.data_ptr(),
                gptrs[0], gptrs[1], _levels_arg(shapes), gtab.data_ptr(),
                goff.data_ptr(), work.data_ptr(), work_bytes, rows, c, k,
                len(shapes), on=table)
    gtab = gtab.to(table.dtype)
    return (*(gtab[:, j * c:(j + 1) * c] for j in range(len(tables))), goff)


def deform_sample_pair_backward_kernel(table_a, table_b, offsets, grad_a,
                                       grad_b, shapes, kernel_size: int = 3):
    out = _sample_backward_kernel(
        "deform_sample_pair_backward", _BWD_KERNEL_DTYPES, (table_a, table_b),
        offsets, (grad_a, grad_b), shapes, kernel_size)
    deform_sample_pair_backward_kernel.launches += 1
    return out


deform_sample_pair_backward_kernel.launches = 0


def deform_sample_backward_kernel(table, offsets, grad, shapes,
                                  kernel_size: int = 3):
    """The single-table backward kernel (csrc/deform_sample_bwd.cu at one
    table): the grads of table and offsets from the buffer's f32 grad."""
    out = _sample_backward_kernel(
        "deform_sample_backward", _SINGLE_BWD_KERNEL_DTYPES, (table,),
        offsets, (grad,), shapes, kernel_size)
    deform_sample_backward_kernel.launches += 1
    return out


deform_sample_backward_kernel.launches = 0


def deform_sample_backward(table, offsets, grad, shapes,
                           kernel_size: int = 3):
    """Grads of (table, offsets) from the f32 grad of the im2col buffer;
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if table.device.type == "cpu":
        return deform_sample_backward_plain(table, offsets, grad, shapes,
                                            kernel_size)
    return deform_sample_backward_kernel(table, offsets, grad, shapes,
                                         kernel_size)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in f32 with an f32 result, as the JAX package's einsums
    with preferred_element_type=float32 (a plain matrix product, left to
    the library as the JAX package leaves it to XLA)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


class DeformSamplePair(torch.autograd.Function):
    """The paired DCN as one autograd node over (table_a, table_b, offsets,
    weight_a, weight_b), as the JAX package's _pair_core.  Forward: both
    im2col buffers (kernel or plain version), then cols @ W in the table
    dtype (the library sums in f32 and rounds once).  Backward: the sample
    grads g @ W^T in f32 go to the sampling backward (kernel or plain
    version), and the weight grads cols^T @ g are f32 sums returned in the
    weights' dtype."""

    @staticmethod
    def forward(ctx, table_a, table_b, offsets, weight_a, weight_b, shapes,
                kernel_size):
        dt = table_a.dtype
        cols_a, cols_b = deform_sample_pair(table_a, table_b, offsets,
                                            shapes, kernel_size)
        wa = weight_a.reshape(-1, weight_a.shape[-1]).to(dt)
        wb = weight_b.reshape(-1, weight_b.shape[-1]).to(dt)
        ctx.save_for_backward(table_a, table_b, offsets, cols_a, cols_b, wa,
                              wb)
        ctx.shapes, ctx.kernel_size = shapes, kernel_size
        ctx.weights = ((weight_a.shape, weight_a.dtype),
                       (weight_b.shape, weight_b.dtype))
        return cols_a @ wa, cols_b @ wb

    @staticmethod
    def backward(ctx, grad_a, grad_b):
        # autograd materialises a missing output grad as zeros
        table_a, table_b, offsets, cols_a, cols_b, wa, wb = ctx.saved_tensors
        grad_a, grad_b = grad_a.contiguous(), grad_b.contiguous()
        grads = deform_sample_pair_backward(
            table_a, table_b, offsets, _mm_f32(grad_a, wa.t()),
            _mm_f32(grad_b, wb.t()), ctx.shapes, ctx.kernel_size)
        gw = [_mm_f32(cols.t(), g).reshape(shape).to(dtype)
              for cols, g, (shape, dtype) in zip((cols_a, cols_b),
                                                 (grad_a, grad_b),
                                                 ctx.weights)]
        return (*grads, *gw, None, None)


def deform_conv2d_pyramid_pair(feats_a, feats_b, offsets, weight_a, weight_b,
                               kernel_size: int = 3):
    """Two DCNv1 instances sharing one set of sampling offsets.

    feats_a, feats_b: per-level (B, H, W, C) NHWC maps; offsets: per-level
    (B, H, W, 2K); weights (K, C, Cout).  Returns (outs_a, outs_b), per-level
    (B, H, W, Cout) lists in the feature dtype.
    """
    c = feats_a[0].shape[-1]
    shapes = [tuple(f.shape[:3]) for f in feats_a]
    table_a = torch.cat([f.reshape(-1, c) for f in feats_a])
    table_b = torch.cat([f.reshape(-1, c) for f in feats_b])
    off = torch.cat([o.reshape(-1, o.shape[-1]) for o in offsets])
    out_a, out_b = DeformSamplePair.apply(table_a, table_b,
                                          off.to(table_a.dtype), weight_a,
                                          weight_b, shapes, kernel_size)
    return _split_levels(out_a, shapes), _split_levels(out_b, shapes)


class DeformSample(torch.autograd.Function):
    """The single DCNv1 as one autograd node over (table, offsets, weight),
    built as DeformSamplePair for one table: the forward samples the table
    (kernel or plain version), then cols @ W in the table dtype; the
    backward hands the f32 sample grads g @ W^T to the sampling backward
    and returns the weight grad cols^T @ g summed in f32, in the weight's
    dtype.  Its grads are those JAX's autodiff takes through
    bilinear_gather and the einsum of deform_conv2d (f32 lerp, one
    rounding: ROADMAP Queue 3 item 3)."""

    @staticmethod
    def forward(ctx, table, offsets, weight, shapes, kernel_size):
        cols = deform_sample(table, offsets, shapes, kernel_size)
        w = weight.reshape(-1, weight.shape[-1]).to(table.dtype)
        ctx.save_for_backward(table, offsets, cols, w)
        ctx.shapes, ctx.kernel_size = shapes, kernel_size
        ctx.weight = (weight.shape, weight.dtype)
        return cols @ w

    @staticmethod
    def backward(ctx, grad):
        table, offsets, cols, w = ctx.saved_tensors
        grad = grad.contiguous()
        gtab, goff = deform_sample_backward(
            table, offsets, _mm_f32(grad, w.t()), ctx.shapes,
            ctx.kernel_size)
        shape, dtype = ctx.weight
        gw = _mm_f32(cols.t(), grad).reshape(shape).to(dtype)
        return gtab, goff, gw, None, None


def deform_conv2d_pyramid(feats, offsets, weight, kernel_size: int = 3):
    """DCNv1 over a feature pyramid with one table (counterpart of the JAX
    package's deform_conv2d_pyramid).

    feats: per-level (B, H, W, C) NHWC maps; offsets: per-level
    (B, H, W, 2K) (dy, dx) pairs relative to the base grid; weight
    (K, C, Cout).  Returns the per-level (B, H, W, Cout) outputs in the
    feature dtype; gradients reach feats, offsets and weight.

    The offsets must be in the feature dtype: the sampling kernels read
    them so.  The JAX function samples f32 offsets at f32 positions
    whatever the feature dtype, so offsets in another dtype are refused,
    not rounded (bf16 moves a sample by up to 1/16 px at |offset| 8).
    """
    c = feats[0].shape[-1]
    dtypes = {o.dtype for o in offsets} - {feats[0].dtype}
    if dtypes:
        raise TypeError(f"deform_conv2d: offsets in {dtypes.pop()} with "
                        f"{feats[0].dtype} features; cast them to the "
                        "feature dtype")
    shapes = [tuple(f.shape[:3]) for f in feats]
    table = torch.cat([f.reshape(-1, c) for f in feats])
    off = torch.cat([o.reshape(-1, o.shape[-1]) for o in offsets])
    out = DeformSample.apply(table, off, weight, shapes, kernel_size)
    return _split_levels(out, shapes)


def deform_conv2d(feat, offsets, weight, kernel_size: int = 3):
    """DCNv1 forward (counterpart of the JAX package's deform_conv2d):
    feat (B, H, W, Cin), offsets (B, H, W, 2K) relative to the base grid,
    weight (K, Cin, Cout) -> (B, H, W, Cout) in the feature dtype.  Stride
    1, zero padding, no bias.  The offsets must be in the feature dtype
    (deform_conv2d_pyramid)."""
    return deform_conv2d_pyramid([feat], [offsets], weight, kernel_size)[0]


def bilinear_gather(feat: torch.Tensor, py: torch.Tensor, px: torch.Tensor):
    """feat (B, H, W, C) sampled at float (B, ...) positions, zero outside
    the map -> (B, ..., C), in the feature dtype (the JAX package's 4-take
    formulation)."""
    b, h, w, c = feat.shape
    out_shape = py.shape[1:]
    py, px = py.reshape(b, -1), px.reshape(b, -1)
    y0f, x0f = torch.floor(py), torch.floor(px)
    wy = (py - y0f)[..., None].to(feat.dtype)
    wx = (px - x0f)[..., None].to(feat.dtype)
    y0, x0 = y0f.to(torch.int64), x0f.to(torch.int64)
    flat = feat.reshape(b * h * w, c)
    base = (torch.arange(b, device=feat.device) * (h * w))[:, None]

    def corner(yi, xi):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1) + base
        return flat[idx.reshape(-1)].reshape(b, -1, c) * ok[..., None]

    out = (corner(y0, x0) * (1 - wy) * (1 - wx)
           + corner(y0, x0 + 1) * (1 - wy) * wx
           + corner(y0 + 1, x0) * wy * (1 - wx)
           + corner(y0 + 1, x0 + 1) * wy * wx)
    return out.reshape((b,) + out_shape + (c,))


def _split_levels(flat_rows: torch.Tensor, shapes) -> list[torch.Tensor]:
    outs, start = [], 0
    for b, h, w in shapes:
        outs.append(flat_rows[start:start + b * h * w].reshape(b, h, w, -1))
        start += b * h * w
    return outs

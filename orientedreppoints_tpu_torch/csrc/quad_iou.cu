// Full f32 IoU matrix of two batched quad sets, and its upper-triangle
// variant with a valid-prefix skip, one thread per (row, column) pair.
//
// Replaces: orientedreppoints_tpu/ops/pallas_quad_iou.py, _quad_kernel
// (entries quad_iou_matrix_pallas and quad_iou_matrix_batch_pallas) as
// orp_quad_iou_full, and _make_quad_kernel_tri (the same entries with
// upper_tri=True) as orp_quad_iou_tri.  out[b, i, j] is quad_clip.cuh's
// quad_iou of subject a[b, i] and clip quad c[b, j], the over-mask
// kernel's function (quad_over.cu), so (tri > thr) there gives the
// over-mask's bits.  The tri variant writes it where j > i, i < nv[b] and
// j < nv[b], and 0 elsewhere; a block wholly outside that region writes
// its zeros without clipping.
//
// Bound on the H100: arithmetic for the full matrix, bytes for the tri
// variant.  An overlapping pair is ~200 f32 operations of clipping, a
// disjoint one ~30 (separate multiplies and adds: the library is built
// with -fmad=false so that the plain version's bits come out); NMS
// candidates average ~50, against 4 bytes of output and 64 bytes of inputs
// that stay in L1/L2.  At N = M = 4096 that is 16.8M pairs against a 67 MB
// output.  The design, for the card
// and not the (8, 128) TPU tile: a block is 32 columns x 8 rows, so each
// warp covers 32 neighbouring columns of one row and its f32 stores form
// one 128-byte line; the block stages its 32 column quads and 8 row quads
// once in shared memory.  The clip keeps quad_clip.cuh's dynamic vertex
// loops (local arrays, divergence in vertex counts): a simple, correct
// kernel first, tuning later.

#include <cuda_runtime.h>

#include "quad_clip.cuh"

namespace {

constexpr int TC = 32;  // columns of a block: one warp
constexpr int TR = 8;   // rows of a block: one warp each

template <bool TRI>
__global__ void __launch_bounds__(TC * TR)
    quad_iou_kernel(const float* __restrict__ a, const float* __restrict__ c,
                    const int* __restrict__ nv, float* __restrict__ out,
                    int N, int M) {
  __shared__ float s_col[TC * 8];
  __shared__ float s_row[TR * 8];
  const int b = blockIdx.z;
  const int col0 = blockIdx.x * TC;
  const int row0 = blockIdx.y * TR;
  const int j = col0 + threadIdx.x;
  const int i = row0 + threadIdx.y;
  float* dst = out + ((size_t)b * N + i) * M + j;
  int n_valid = 0;
  if (TRI) {
    n_valid = nv[b];
    // uniform over the block: no column right of the diagonal, or past
    // the valid prefix
    if (!((col0 + TC - 1 > row0) && (row0 < n_valid) && (col0 < n_valid))) {
      if (i < N && j < M) *dst = 0.f;
      return;
    }
  }
  const int t = threadIdx.y * TC + threadIdx.x;
  const float* csrc = c + ((size_t)b * M + col0) * 8;
  for (int k = t; k < TC * 8; k += TC * TR)
    s_col[k] = (col0 + k / 8 < M) ? csrc[k] : 0.f;
  const float* asrc = a + ((size_t)b * N + row0) * 8;
  for (int k = t; k < TR * 8; k += TC * TR)
    s_row[k] = (row0 + k / 8 < N) ? asrc[k] : 0.f;
  __syncthreads();
  if (i >= N || j >= M) return;
  const bool live = !TRI || (j > i && i < n_valid && j < n_valid);
  *dst = live ? quad_iou(s_row + threadIdx.y * 8, s_col + threadIdx.x * 8)
              : 0.f;
}

template <bool TRI>
int launch(const float* a, const float* c, const int* nv, float* out, int B,
           int N, int M, void* stream) {
  if ((N + TR - 1) / TR > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B > 0 && N > 0 && M > 0) {
    const dim3 grid((M + TC - 1) / TC, (N + TR - 1) / TR, B);
    quad_iou_kernel<TRI><<<grid, dim3(TC, TR), 0, (cudaStream_t)stream>>>(
        a, c, nv, out, N, M);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a (B, N, 8) f32 subjects, c (B, M, 8) f32 clip quads -> out (B, N, M) f32.
extern "C" int orp_quad_iou_full(const float* a, const float* c, float* out,
                                 int B, int N, int M, void* stream) {
  return launch<false>(a, c, nullptr, out, B, N, M, stream);
}

// As orp_quad_iou_full, with nv (B,) i32: 0 unless j > i and i, j < nv[b].
extern "C" int orp_quad_iou_tri(const float* a, const float* c, const int* nv,
                                float* out, int B, int N, int M,
                                void* stream) {
  return launch<true>(a, c, nv, out, B, N, M, stream);
}

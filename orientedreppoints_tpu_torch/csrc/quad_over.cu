// Rotated-NMS suppression mask as a bitmask, one thread per (i, j) pair.
//
// Replaces: orientedreppoints_tpu/ops/pallas_quad_iou.py,
// _make_quad_over_kernel (batched entry quad_over_matrix_batch_pallas; the
// single-image entry quad_over_matrix_pallas is a batch-1 launch).
// For score-sorted quads, bit j of row i is set iff IoU(i, j) > thr
// (strict), j > i, and i, j < nv[b].  IoU is quad_clip.cuh's quad_iou of
// subject i and clip quad j, the function the f32 IoU-matrix kernels
// (quad_iou.cu) evaluate, so a bit here is exactly (f32 IoU > thr) there.
//
// Output: (B, N, W) uint64 words, W = ceil(N / 64); bit t of word w is
// column 64 w + t (the mmcv rnms layout).  A block is 64 columns (one
// word) x 4 rows; each warp's __ballot_sync packs 32 pair results into the
// low or high half of the word, so no atomics are needed.
//
// Bound on the H100: arithmetic.  A pair is up to ~200 f32 operations of
// clipping (~50 on average over NMS candidates, most of them disjoint) on
// 64 bytes of inputs that stay in L1/L2; the output is 1 bit a pair.  Blocks
// that lie wholly past the valid prefix or on/below the diagonal write
// zeros and skip the IoU, which drops more than half of the N^2 pairs.
// The clip lists live in small local arrays with dynamic indexing; that
// and the per-pair divergence in vertex counts are what a later tuned
// version would remove.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quad_clip.cuh"

namespace {

constexpr int ROWS = 4;

__global__ void quad_over_kernel(const float* __restrict__ quads,
                                 const int* __restrict__ nv,
                                 uint32_t* __restrict__ out, int n, int words,
                                 float thr) {
  const int b = blockIdx.z;
  const int word = blockIdx.x;
  const int row0 = blockIdx.y * ROWS;
  const int col0 = word * 64;
  const int i = row0 + threadIdx.y;
  const int j = col0 + threadIdx.x;
  const int n_valid = nv[b];
  const bool block_live =
      (col0 + 63 > row0) && (row0 < n_valid) && (col0 < n_valid);
  bool over = false;
  if (block_live && j > i && i < n_valid && j < n_valid) {
    const float* base = quads + (size_t)b * n * 8;
    over = quad_iou(base + (size_t)i * 8, base + (size_t)j * 8) > thr;
  }
  const uint32_t bits = __ballot_sync(0xffffffffu, over);
  if (i < n && (threadIdx.x & 31) == 0)
    out[(((size_t)b * n + i) * words + word) * 2 + (threadIdx.x >> 5)] = bits;
}

}  // namespace

// quads (B, N, 8) f32, nv (B,) i32 -> out (B, N, ceil(N/64)) uint64 words.
extern "C" int orp_quad_over_mask(const float* quads, const int* nv, void* out,
                                  int batch, int n, int words, float thr,
                                  void* stream) {
  if (batch > 0 && n > 0) {
    const dim3 block(64, ROWS);
    const dim3 grid(words, (n + ROWS - 1) / ROWS, batch);
    quad_over_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        quads, nv, (uint32_t*)out, n, words, thr);
  }
  return (int)cudaGetLastError();
}

// Rotated-NMS suppression mask as a bitmask: one thread per row, walking
// the 64 columns of one output word.
//
// Replaces: orientedreppoints_tpu/ops/pallas_quad_iou.py,
// _make_quad_over_kernel (batched entry quad_over_matrix_batch_pallas; the
// single-image entry quad_over_matrix_pallas is a batch-1 launch).
// For score-sorted quads, bit j of row i is set iff IoU(i, j) > thr
// (strict), j > i, and i, j < nv[b].  IoU is clip_ring.cuh's pair IoU with
// subject = row i (a hull of count 4 in V = 4 slots) and clip quad =
// column j, the pair function that the f32 IoU-matrix kernels
// (quad_iou.cu) evaluate too, so a bit here is exactly (f32 IoU > thr)
// there.
//
// Output: (B, N, W) uint64 words, W = ceil(N / 64); bit t of word w is
// column 64 w + t (the mmcv rnms layout).
//
// Bound on the H100: arithmetic, ~50 f32 operations a live pair on
// average (chip_smoke.py's count over NMS candidates, most of them
// disjoint) against 32 bytes of input a quad and 1 bit of output a pair.
// What the design does about it:
//   - a block is a 64 x 64 tile: 64 rows (one a thread) by the 64 columns
//     of one output word.  The grid walks only the tiles on or above the
//     diagonal (W (W + 1) / 2 an image), and a tile whose columns start at
//     or past nv returns at once; the launcher zero-fills the output first
//     (one memset), so no dead word costs a thread;
//   - the clip quads of the tile (vertex 0, the oriented corners, the
//     edges, the area) are staged once a block in shared memory and read
//     as a broadcast: the warp walks the columns in step, a lane skipping
//     those at or left of its row;
//   - each thread builds its row's word in a register and stores it once;
//     the 64 stores of a block are 8-byte writes W words apart, 0.5M of
//     them at B 4 x N 4096 against 33.5M pairs, merged in L2;
//   - the clip lists live in a [slot][thread] ring in shared memory and
//     the loops run over the live count only; a pair ends at its first
//     empty clip stage, where its IoU is +0 bit for bit (clip_ring.cuh).
//     No bounding-box pre-test: it would need a proof that the f32 path
//     gives IoU <= thr for every pair it drops.

#include <cuda_runtime.h>
#include <limits.h>

#include "clip_ring.cuh"
#include "device.cuh"

namespace {

constexpr int V = 4;           // a quad is a hull of count 4
constexpr int TILE = 64;       // rows and columns of a block
constexpr int RING_A = V + 3;  // stage 0 and 2 outputs: 5 and 7 slots
constexpr int RING_B = V + 4;  // stage 1 and 3 outputs: 6 and 8 slots

__global__ void __launch_bounds__(TILE)
    quad_over_kernel(const float* __restrict__ quads,
                     const int* __restrict__ nv,
                     unsigned long long* __restrict__ out, int n, int words,
                     float thr) {
  __shared__ ClipQuad s_q[TILE];
  __shared__ float s_ax[RING_A][TILE], s_ay[RING_A][TILE];
  __shared__ float s_bx[RING_B][TILE], s_by[RING_B][TILE];
  // tile k of the upper triangle: column word w, row tile r <= w
  const long long k = blockIdx.x;
  int w = (int)((sqrtf(8.f * (float)k + 1.f) - 1.f) * 0.5f);
  while ((long long)w * (w + 1) / 2 > k) --w;
  while ((long long)(w + 1) * (w + 2) / 2 <= k) ++w;
  const int r = (int)(k - (long long)w * (w + 1) / 2);
  const int b = blockIdx.y;
  const int n_valid = min(nv[b], n);
  const int col0 = w * TILE;
  if (col0 >= n_valid) return;  // every bit 0: the launcher's memset
  const int tid = threadIdx.x;
  const int cols = min(TILE, n_valid - col0);
  const float* base = quads + (size_t)b * n * 8;
  if (tid < cols) s_q[tid] = clip_quad_of(base + (size_t)(col0 + tid) * 8);
  __syncthreads();
  const int i = r * TILE + tid;
  if (i >= n_valid) return;

  float a[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) a[c] = base[(size_t)i * 8 + c];
  unsigned long long word = 0ull;
  for (int t = 0; t < cols; ++t) {
    if (col0 + t <= i) continue;
    const ClipQuad& q = s_q[t];
    float hx[V], hy[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      hx[c] = a[2 * c] - q.ox;
      hy[c] = a[2 * c + 1] - q.oy;
    }
    const float iou = pair_iou<V, TILE>(hx, hy, V, q, &s_ax[0][tid],
                                        &s_ay[0][tid], &s_bx[0][tid],
                                        &s_by[0][tid]);
    if (iou > thr) word |= 1ull << t;
  }
  out[((size_t)b * n + i) * words + w] = word;
}

}  // namespace

// quads (B, N, 8) f32, nv (B,) i32 -> out (B, N, ceil(N/64)) uint64 words.
extern "C" int orp_quad_over_mask(const float* quads, const int* nv, void* out,
                                  int batch, int n, float thr, int device,
                                  void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  const int words = (n + TILE - 1) / TILE;
  const long long tiles = (long long)words * (words + 1) / 2;
  if (batch > 65535 || tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  if (batch > 0 && n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t err = cudaMemsetAsync(
        out, 0, (size_t)batch * n * words * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return (int)err;
    quad_over_kernel<<<dim3((unsigned)tiles, batch), TILE, 0, s>>>(
        quads, nv, (unsigned long long*)out, n, words, thr);
  }
  return (int)cudaGetLastError();
}

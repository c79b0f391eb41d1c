// IoU of point-set hulls (<= 9 vertices) with gt quads, batched over images,
// with the refine assigner's validity masks.
//
// Replaces: orientedreppoints_tpu/ops/pallas_quad_iou.py, _hull_kernel
// (entry hull_quad_iou_matrix_pallas), the refine assigner's convex IoU,
// together with the mask the assigner applies right after it (a pair whose
// gt or point set is not valid is -1).  The pair IoU is clip_ring.cuh's
// (hull slots V = 9, clip stages of 10, 11, 12 and 13 slots), the Pallas
// tile's arithmetic operation for operation.  The assigner compares IoUs
// for exact equality, so this kernel and its plain version
// (ops/hull_iou.py) must give the same bits.
//
// Bound on the H100: at the training shape (batch 2, N 37,606 point sets,
// G 512 gts of which 150 valid) the bytes of the (B, G, N) f32 output,
// 154 MB: the live pairs are about a fifth of all, and most of them are
// disjoint, losing every vertex in the first one or two clip stages (~64
// operations a live pair, chip_smoke.py's count).  What the design does
// about it:
//   - one thread per hull, walking the gts of its block's tile; a warp's 32
//     hulls are neighbouring feature-map locations, so they tend to leave
//     the clip together, and its store of one gt's IoUs is one 128-byte
//     line of the (B, G, N) output;
//   - everything that depends on the quad alone (vertex 0, the oriented
//     corners, the edges, the area, the valid flag) is staged once a block
//     in shared memory and read as a broadcast; a padded gt is skipped by
//     the whole warp at once, an invalid point set by its thread;
//   - the clip rings in shared memory and the exact exit at the first
//     empty stage (clip_ring.cuh).

#include <cuda_runtime.h>

#include "clip_ring.cuh"
#include "device.cuh"

namespace {

constexpr int V = 9;          // hull slots
constexpr int THREADS = 128;  // hulls per block, one a thread
constexpr int GT_TILE = 64;   // gts per block
constexpr int RING_A = V + 3;  // stage 0 and 2 outputs: 10 and 12 slots
constexpr int RING_B = V + 4;  // stage 1 and 3 outputs: 11 and 13 slots

__global__ void __launch_bounds__(THREADS)
    hull_quad_iou_kernel(const float* __restrict__ hulls,
                         const int* __restrict__ counts,
                         const float* __restrict__ quads,
                         const unsigned char* __restrict__ gt_valid,
                         const unsigned char* __restrict__ rows_valid,
                         float* __restrict__ out, int N, int G) {
  __shared__ ClipQuad s_q[GT_TILE];
  __shared__ unsigned char s_valid[GT_TILE];
  __shared__ float s_ax[RING_A][THREADS], s_ay[RING_A][THREADS];
  __shared__ float s_bx[RING_B][THREADS], s_by[RING_B][THREADS];
  const int b = blockIdx.z;
  const int g0 = blockIdx.y * GT_TILE;
  const int tile = min(GT_TILE, G - g0);
  const int tid = threadIdx.x;
  const int n = blockIdx.x * THREADS + tid;

  if (tid < tile) {  // the quad side, once a block
    const int g = g0 + tid;
    s_q[tid] = clip_quad_of(quads + ((size_t)b * G + g) * 8);
    s_valid[tid] = gt_valid == nullptr || gt_valid[(size_t)b * G + g];
  }
  __syncthreads();
  if (n >= N) return;

  // the hull side, once a thread
  const size_t row = (size_t)b * N + n;
  const bool row_live = rows_valid == nullptr || rows_valid[row];
  float hull[2 * V];
#pragma unroll
  for (int k = 0; k < 2 * V; ++k) hull[k] = hulls[row * 2 * V + k];
  const int cnt0 = counts[row];

  float* dst = out + ((size_t)b * G + g0) * N + n;
  for (int gi = 0; gi < tile; ++gi, dst += N) {
    const ClipQuad& q = s_q[gi];
    if (!s_valid[gi] || !row_live) {
      *dst = -1.f;
      continue;
    }
    float hx[V], hy[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      hx[k] = hull[2 * k] - q.ox;
      hy[k] = hull[2 * k + 1] - q.oy;
    }
    *dst = pair_iou<V, THREADS>(hx, hy, cnt0, q, &s_ax[0][tid],
                                &s_ay[0][tid], &s_bx[0][tid], &s_by[0][tid]);
  }
}

}  // namespace

// hulls (B, N, 9, 2) f32 (padding repeats vertex 0), counts (B, N) i32,
// quads (B, G, 8) f32, gt_valid (B, G) and rows_valid (B, N) bool or null
// (all valid) -> out (B, G, N) f32, -1 where the gt or the row is not valid.
extern "C" int orp_hull_quad_iou(const float* hulls, const int* counts,
                                 const float* quads,
                                 const unsigned char* gt_valid,
                                 const unsigned char* rows_valid, float* out,
                                 int B, int N, int G, int device,
                                 void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  if ((G + GT_TILE - 1) / GT_TILE > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B > 0 && N > 0 && G > 0) {
    const dim3 grid((N + THREADS - 1) / THREADS, (G + GT_TILE - 1) / GT_TILE,
                    B);
    hull_quad_iou_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        hulls, counts, quads, gt_valid, rows_valid, out, N, G);
  }
  return (int)cudaGetLastError();
}

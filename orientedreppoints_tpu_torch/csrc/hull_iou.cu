// IoU of point-set hulls (<= 9 vertices) with gt quads, batched over images.
//
// Replaces: orientedreppoints_tpu/ops/pallas_quad_iou.py, _hull_kernel
// (entry hull_quad_iou_matrix_pallas), the refine assigner's convex IoU.
// Same arithmetic as the Pallas tile, operation for operation: recentre
// the pair on the quad's vertex 0, the hull's signed area by the masked
// shoelace over its 9 slots, orient the quad counter-clockwise (a
// clockwise quad is read as vertices 0, 3, 2, 1), Sutherland-Hodgman clip
// by its four half-planes into 10, 11, 12 and 13 slots (positions beyond a
// stage's cap dropped, its count not capped), then
// inter / max(area_a + area_b - inter, 1e-8).  The assigner compares IoUs
// for exact equality, so this kernel and its plain version
// (ops/hull_iou.py) must give the same bits; both keep this order and the
// library is built with -fmad=false.
//
// Bound on the H100: arithmetic.  A pair reads nothing new from memory in
// the inner loop and writes 4 bytes, but runs four clip stages of ~10
// edges whose compaction into fixed slots is a chain of selects (~3k
// instructions a pair; at batch 2, N 37,606 point sets, G 512 gts:
// 38.5M pairs, 154 MB of output).  The design: one thread per pair, every
// loop unrolled with static trip counts so that the slots stay in
// registers (no local memory); a thread keeps its gt quad and everything
// that depends on the quad alone (recentred corners, orientation, edges,
// area) in registers and walks HULLS_PER_BLOCK hulls, which the block
// stages once in shared memory and every thread then reads as a broadcast.
// Consecutive threads take consecutive gts, so the output rows are written
// coalesced.  Skipping padded gts is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int V = 9;                // hull slots
constexpr int THREADS = 128;        // gts per block
constexpr int HULLS_PER_BLOCK = 32;  // hulls a block walks

// signed 2x area over the first cnt of N slots, the ring wrapping at cnt
template <int N>
__device__ __forceinline__ float shoelace_slots(const float (&vx)[N],
                                                const float (&vy)[N],
                                                int cnt) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int jn = (j + 1) % N;
    const bool wrap = cnt == j + 1;
    const float nx = wrap ? vx[0] : vx[jn];
    const float ny = wrap ? vy[0] : vy[jn];
    const float term = vx[j] * ny - nx * vy[j];
    s = s + (cnt > j ? term : 0.f);
  }
  return s;
}

// keep the part of the IN-slot polygon left of the edge e0 -> e0 + e;
// crossings and kept vertices go to the OUT slots in order
template <int IN, int OUT>
__device__ __forceinline__ int clip_stage(const float (&vx)[IN],
                                          const float (&vy)[IN], int cnt,
                                          float ex, float ey, float e0x,
                                          float e0y, float (&ox)[OUT],
                                          float (&oy)[OUT]) {
  float side[IN];
#pragma unroll
  for (int j = 0; j < IN; ++j)
    side[j] = ex * (vy[j] - e0y) - ey * (vx[j] - e0x);
#pragma unroll
  for (int j = 0; j < OUT; ++j) {
    ox[j] = 0.f;
    oy[j] = 0.f;
  }
  int pos = 0;
#pragma unroll
  for (int j = 0; j < IN; ++j) {
    const int jn = (j + 1) % IN;
    const bool wrap = cnt == j + 1;
    const float nx = wrap ? vx[0] : vx[jn];
    const float ny = wrap ? vy[0] : vy[jn];
    const float s_nxt = wrap ? side[0] : side[jn];
    const bool valid = cnt > j;
    const bool in_cur = side[j] >= 0.f;
    const bool in_nxt = s_nxt >= 0.f;
    const float denom = side[j] - s_nxt;
    const float t = side[j] / (fabsf(denom) < 1e-12f ? 1.f : denom);
    const float ix = vx[j] + t * (nx - vx[j]);
    const float iy = vy[j] + t * (ny - vy[j]);
    const bool emit0 = valid && (in_cur != in_nxt);
#pragma unroll
    for (int o = 0; o < OUT; ++o) {
      if (emit0 && pos == o) {
        ox[o] = ix;
        oy[o] = iy;
      }
    }
    pos += emit0 ? 1 : 0;
    const bool emit1 = valid && in_nxt;
#pragma unroll
    for (int o = 0; o < OUT; ++o) {
      if (emit1 && pos == o) {
        ox[o] = nx;
        oy[o] = ny;
      }
    }
    pos += emit1 ? 1 : 0;
  }
  return pos;
}

__global__ void __launch_bounds__(THREADS)
    hull_quad_iou_kernel(const float* __restrict__ hulls,
                         const int* __restrict__ counts,
                         const float* __restrict__ quads,
                         float* __restrict__ out, int N, int G) {
  __shared__ float s_hull[HULLS_PER_BLOCK][2 * V];
  __shared__ int s_cnt[HULLS_PER_BLOCK];
  const int b = blockIdx.z;
  const int n0 = blockIdx.y * HULLS_PER_BLOCK;
  const int g = blockIdx.x * THREADS + threadIdx.x;
  const int rows = min(HULLS_PER_BLOCK, N - n0);

  const float* hsrc = hulls + ((size_t)b * N + n0) * 2 * V;
  for (int i = threadIdx.x; i < rows * 2 * V; i += THREADS)
    s_hull[i / (2 * V)][i % (2 * V)] = hsrc[i];
  for (int i = threadIdx.x; i < rows; i += THREADS)
    s_cnt[i] = counts[(size_t)b * N + n0 + i];
  __syncthreads();
  if (g >= G) return;

  // the quad side, once per thread
  const float* q = quads + ((size_t)b * G + g) * 8;
  const float qox = q[0], qoy = q[1];
  float bx[4], by[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bx[k] = q[2 * k] - qox;
    by[k] = q[2 * k + 1] - qoy;
  }
  float area2_b = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int kn = (k + 1) % 4;
    area2_b = area2_b + (bx[k] * by[kn] - bx[kn] * by[k]);
  }
  const bool flip = area2_b < 0.f;
  float cx[4], cy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cx[k] = flip ? bx[(4 - k) % 4] : bx[k];
    cy[k] = flip ? by[(4 - k) % 4] : by[k];
  }
  float ex[4], ey[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ex[e] = cx[(e + 1) % 4] - cx[e];
    ey[e] = cy[(e + 1) % 4] - cy[e];
  }
  const float area_b = 0.5f * fabsf(area2_b);

  float* dst = out + ((size_t)b * N + n0) * G + g;
  for (int r = 0; r < rows; ++r) {
    float hx[V], hy[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      hx[k] = s_hull[r][2 * k] - qox;
      hy[k] = s_hull[r][2 * k + 1] - qoy;
    }
    const int cnt0 = s_cnt[r];
    const float area2 = shoelace_slots<V>(hx, hy, cnt0);

    float x1[V + 1], y1[V + 1], x2[V + 2], y2[V + 2];
    float x3[V + 3], y3[V + 3], x4[V + 4], y4[V + 4];
    int c = clip_stage<V, V + 1>(hx, hy, cnt0, ex[0], ey[0], cx[0], cy[0],
                                 x1, y1);
    c = clip_stage<V + 1, V + 2>(x1, y1, c, ex[1], ey[1], cx[1], cy[1], x2,
                                 y2);
    c = clip_stage<V + 2, V + 3>(x2, y2, c, ex[2], ey[2], cx[2], cy[2], x3,
                                 y3);
    c = clip_stage<V + 3, V + 4>(x3, y3, c, ex[3], ey[3], cx[3], cy[3], x4,
                                 y4);
    const float inter = 0.5f * fabsf(shoelace_slots<V + 4>(x4, y4, c));
    const float area_a = 0.5f * fabsf(area2);
    const float uni = fmaxf(area_a + area_b - inter, 1e-8f);
    dst[(size_t)r * G] = inter / uni;
  }
}

}  // namespace

// hulls (B, N, 9, 2) f32 (padding repeats vertex 0), counts (B, N) i32,
// quads (B, G, 8) f32 -> out (B, N, G) f32.
extern "C" int orp_hull_quad_iou(const float* hulls, const int* counts,
                                 const float* quads, float* out, int B, int N,
                                 int G, void* stream) {
  if ((N + HULLS_PER_BLOCK - 1) / HULLS_PER_BLOCK > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B > 0 && N > 0 && G > 0) {
    const dim3 grid((G + THREADS - 1) / THREADS,
                    (N + HULLS_PER_BLOCK - 1) / HULLS_PER_BLOCK, B);
    hull_quad_iou_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        hulls, counts, quads, out, N, G);
  }
  return (int)cudaGetLastError();
}

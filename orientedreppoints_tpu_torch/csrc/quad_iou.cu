// Full f32 IoU matrix of two batched quad sets, and its upper-triangle
// variant with a valid-prefix skip: one thread per subject row over a
// 64 x 64 tile of clip quads staged in shared memory.
//
// Replaces: orientedreppoints_tpu/ops/pallas_quad_iou.py, _quad_kernel
// (entries quad_iou_matrix_pallas and quad_iou_matrix_batch_pallas) as
// orp_quad_iou_full, and _make_quad_kernel_tri (the same entries with
// upper_tri=True) as orp_quad_iou_tri.  out[b, i, j] is clip_ring.cuh's
// pair IoU of subject a[b, i] (a hull of count 4) and clip quad c[b, j],
// the over-mask kernel's function (quad_over.cu), so (tri > thr) gives the
// over-mask's bits.  The tri variant writes it where j > i and i, j <
// nv[b], and 0 elsewhere.
//
// Bound on the H100: operations for the full matrix (~50 f32 operations a
// pair on NMS candidates, most of them disjoint, against 4 bytes of output
// a pair; the library is built with -fmad=false so that the plain
// version's bits come out), bytes for the tri variant (its whole (B, N, M)
// output is written, while only the live pairs of the triangle are
// clipped: 13.4M of 67M at B 4 x 4096 with nv 4096/3000/1000/0).  What the
// design does about it, as the over-mask's:
//   - a block is a 64 x 64 tile, one thread a subject row; the tile's clip
//     quads (ClipQuad: origin, oriented corners, edges, area) are computed
//     once a block into shared memory and read as a broadcast;
//   - the clip lists are [slot][thread] rings in shared memory, the loops
//     run over the live count only, and a pair ends at its first empty
//     clip stage, where its IoU is +0 bit for bit (clip_ring.cuh);
//   - a thread keeps 8 neighbouring results of its row in registers and
//     stores them as two float4, one whole 32-byte sector a thread (rows
//     that are ragged or not 16-byte aligned store scalars);
//   - full: the grid is every (column tile, row tile) of the (N, M) output.
//     Nothing is mirrored: IoU(i, j) and IoU(j, i) are recentred on
//     different vertices and differ in the last bits;
//   - tri: the launcher zero-fills the output first (one memset, the byte
//     bound), then the grid walks only the tiles whose column tile is at or
//     right of their row tile; a tile whose rows or columns start at or
//     past nv returns at once, and a group of 8 columns with no live pair
//     of its row is neither clipped nor stored.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "clip_ring.cuh"
#include "device.cuh"

namespace {

constexpr int V = 4;           // a quad is a hull of count 4
constexpr int TILE = 64;       // rows and columns of a block
constexpr int GROUP = 8;       // results a thread stores at once: 32 bytes
constexpr int RING_A = V + 3;  // stage 0 and 2 outputs: 5 and 7 slots
constexpr int RING_B = V + 4;  // stage 1 and 3 outputs: 6 and 8 slots

// Tile k of the tri variant's walk over R row tiles and W column tiles,
// with P = min(R, W): first the P (P + 1) / 2 tiles r <= w < P, then the
// (W - P) P tiles of the columns w >= P.  Row tiles r >= W hold no pair
// with j > i.
__device__ __forceinline__ void tri_tile(long long k, int P, int& r, int& w) {
  const long long head = (long long)P * (P + 1) / 2;
  if (k >= head) {
    w = P + (int)((k - head) / P);
    r = (int)((k - head) % P);
    return;
  }
  w = (int)((sqrtf(8.f * (float)k + 1.f) - 1.f) * 0.5f);
  while ((long long)w * (w + 1) / 2 > k) --w;
  while ((long long)(w + 1) * (w + 2) / 2 <= k) ++w;
  r = (int)(k - (long long)w * (w + 1) / 2);
}

template <bool TRI>
__global__ void __launch_bounds__(TILE)
    quad_iou_kernel(const float* __restrict__ a, const float* __restrict__ c,
                    const int* __restrict__ nv, float* __restrict__ out,
                    int N, int M, int P, bool vec) {
  __shared__ ClipQuad s_q[TILE];
  __shared__ float s_ax[RING_A][TILE], s_ay[RING_A][TILE];
  __shared__ float s_bx[RING_B][TILE], s_by[RING_B][TILE];
  int r, w, b, row_end = N, col_end = M;
  if (TRI) {
    tri_tile(blockIdx.x, P, r, w);
    b = blockIdx.y;
    row_end = min(nv[b], N);
    col_end = min(nv[b], M);
  } else {
    w = blockIdx.x;
    r = blockIdx.y;
    b = blockIdx.z;
  }
  const int col0 = w * TILE, row0 = r * TILE;
  // the tri variant's dead tiles keep the launcher's zeros
  if (TRI && (col0 >= col_end || row0 >= row_end)) return;
  const int tid = threadIdx.x;
  const int cols = min(TILE, col_end - col0);
  if (tid < cols)
    s_q[tid] = clip_quad_of(c + ((size_t)b * M + col0 + tid) * 8);
  __syncthreads();
  const int i = row0 + tid;
  if (i >= row_end) return;

  float av[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) av[k] = a[((size_t)b * N + i) * 8 + k];
  float* dst = out + ((size_t)b * N + i) * M + col0;
  // the row's first live column in the tile: right of the diagonal
  const int t0 = TRI ? max(0, i + 1 - col0) : 0;
  for (int g = t0 / GROUP * GROUP; g < cols; g += GROUP) {
    float v[GROUP] = {};
#pragma unroll 1
    for (int k = 0; k < GROUP; ++k) {
      const int t = g + k;
      float iou = 0.f;
      if (t >= t0 && t < cols) {
        const ClipQuad& q = s_q[t];
        float hx[V], hy[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          hx[e] = av[2 * e] - q.ox;
          hy[e] = av[2 * e + 1] - q.oy;
        }
        iou = pair_iou<V, TILE>(hx, hy, V, q, &s_ax[0][tid], &s_ay[0][tid],
                                &s_bx[0][tid], &s_by[0][tid]);
      }
      // shift the group left: v stays in registers, v[k] is column g + k
#pragma unroll
      for (int s = 0; s + 1 < GROUP; ++s) v[s] = v[s + 1];
      v[GROUP - 1] = iou;
    }
    if (vec && g + GROUP <= cols) {
      float4* d = reinterpret_cast<float4*>(dst + g);
      d[0] = make_float4(v[0], v[1], v[2], v[3]);
      d[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int k = 0; k < GROUP; ++k)
        if (g + k < cols) dst[g + k] = v[k];
    }
  }
}

template <bool TRI>
int launch(const float* a, const float* c, const int* nv, float* out, int B,
           int N, int M, void* stream) {
  const int R = (N + TILE - 1) / TILE, W = (M + TILE - 1) / TILE;
  const int P = R < W ? R : W;
  const long long tiles =
      TRI ? (long long)P * (P + 1) / 2 + (long long)(W - P) * P : W;
  if (B > 65535 || (!TRI && R > 65535) || tiles > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (B > 0 && N > 0 && M > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    // every row of out starts 16-byte aligned
    const bool vec = M % 4 == 0 && (uintptr_t)out % 16 == 0;
    if (TRI) {
      const cudaError_t err =
          cudaMemsetAsync(out, 0, (size_t)B * N * M * sizeof(float), s);
      if (err != cudaSuccess) return (int)err;
      quad_iou_kernel<true><<<dim3((unsigned)tiles, B), TILE, 0, s>>>(
          a, c, nv, out, N, M, P, vec);
    } else {
      quad_iou_kernel<false><<<dim3(W, R, B), TILE, 0, s>>>(
          a, c, nv, out, N, M, P, vec);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a (B, N, 8) f32 subjects, c (B, M, 8) f32 clip quads -> out (B, N, M) f32.
extern "C" int orp_quad_iou_full(const float* a, const float* c, float* out,
                                 int B, int N, int M, int device,
                                 void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  return launch<false>(a, c, nullptr, out, B, N, M, stream);
}

// As orp_quad_iou_full, with nv (B,) i32: 0 unless j > i and i, j < nv[b].
extern "C" int orp_quad_iou_tri(const float* a, const float* c, const int* nv,
                                float* out, int B, int N, int M, int device,
                                void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  return launch<true>(a, c, nv, out, B, N, M, stream);
}

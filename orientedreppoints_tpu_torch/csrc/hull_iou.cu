// IoU of point-set hulls (<= 9 vertices) with gt quads, batched over images,
// with the refine assigner's validity masks.
//
// Replaces: orientedreppoints_tpu/ops/pallas_quad_iou.py, _hull_kernel
// (entry hull_quad_iou_matrix_pallas), the refine assigner's convex IoU,
// together with the mask the assigner applies right after it (a pair whose
// gt or point set is not valid is -1).  Same arithmetic as the Pallas tile,
// operation for operation: recentre the pair on the quad's vertex 0, the
// hull's signed area by the shoelace over its first count slots, orient the
// quad counter-clockwise (a clockwise quad is read as vertices 0, 3, 2, 1),
// Sutherland-Hodgman clip by its four half-planes into 10, 11, 12 and 13
// slots (positions beyond a stage's cap dropped, its count not capped, the
// next vertex of the last slot read is slot 0), then
// inter / max(area_a + area_b - inter, 1e-8).  The assigner compares IoUs
// for exact equality, so this kernel and its plain version
// (ops/hull_iou.py) must give the same bits; both keep this order and the
// library is built with -fmad=false.
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
//   - the clip stages emit each vertex straight to its slot of a ring in
//     shared memory laid out [slot][thread] (no bank conflicts) and loop
//     over the live count only; the sums over a ring add the first count
//     terms from slot 0, which gives the bits of the masked sum over every
//     slot (a sum that starts at +0 never becomes -0, so adding +0 changes
//     nothing);
//   - a stage that leaves no vertex ends the pair: every later stage leaves
//     none, the intersection is 0.5 |+0| = +0 and the union is at least
//     1e-8 (fmaxf drops a NaN), so the IoU is +0 bit for bit.  The hull's
//     own area is taken only for pairs whose clip is not empty.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int V = 9;          // hull slots
constexpr int THREADS = 128;  // hulls per block, one a thread
constexpr int GT_TILE = 64;   // gts per block
constexpr int RING_A = V + 3;  // stage 0 and 2 outputs: 10 and 12 slots
constexpr int RING_B = V + 4;  // stage 1 and 3 outputs: 11 and 13 slots

struct Quad {  // what depends on the gt quad alone
  float ox, oy;        // vertex 0, the pair's origin
  float cx[4], cy[4];  // recentred corners, counter-clockwise
  float ex[4], ey[4];  // edges c[e] -> c[e + 1]
  float area;          // 0.5 |signed area|
  int valid;
};

// signed 2x area over the first cnt of N register slots, the ring wrapping
// at cnt
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

__device__ __forceinline__ float side_of(float ex, float ey, float e0x,
                                         float e0y, float x, float y) {
  return ex * (y - e0y) - ey * (x - e0x);
}

// Emit the crossing of the edge cur -> nxt and then nxt, as the stage's
// rules say, to the ring slots out[pos * THREADS]; returns the new count.
__device__ __forceinline__ int emit_edge(float cx, float cy, float sc,
                                         float nx, float ny, float sn,
                                         int pos, int cap,
                                         float* __restrict__ ox,
                                         float* __restrict__ oy) {
  const bool in_cur = sc >= 0.f;
  const bool in_nxt = sn >= 0.f;
  if (in_cur != in_nxt) {
    const float denom = sc - sn;
    const float t = sc / (fabsf(denom) < 1e-12f ? 1.f : denom);
    if (pos < cap) {
      ox[pos * THREADS] = cx + t * (nx - cx);
      oy[pos * THREADS] = cy + t * (ny - cy);
    }
    ++pos;
  }
  if (in_nxt) {
    if (pos < cap) {
      ox[pos * THREADS] = nx;
      oy[pos * THREADS] = ny;
    }
    ++pos;
  }
  return pos;
}

// Keep the part of the ring polygon (its first min(cnt, in_cap) slots) left
// of the edge e0 -> e0 + e; returns the uncapped count of emitted vertices.
__device__ __forceinline__ int clip_ring(const float* __restrict__ ix,
                                         const float* __restrict__ iy,
                                         int cnt, int in_cap, float ex,
                                         float ey, float e0x, float e0y,
                                         float* __restrict__ ox,
                                         float* __restrict__ oy,
                                         int out_cap) {
  const int n = min(cnt, in_cap);
  float cx = ix[0], cy = iy[0];
  float sc = side_of(ex, ey, e0x, e0y, cx, cy);
  int pos = 0;
  for (int j = 0; j < n; ++j) {
    const int jn = j + 1 == n ? 0 : j + 1;
    const float nx = ix[jn * THREADS], ny = iy[jn * THREADS];
    const float sn = side_of(ex, ey, e0x, e0y, nx, ny);
    pos = emit_edge(cx, cy, sc, nx, ny, sn, pos, out_cap, ox, oy);
    cx = nx;
    cy = ny;
    sc = sn;
  }
  return pos;
}

__global__ void __launch_bounds__(THREADS)
    hull_quad_iou_kernel(const float* __restrict__ hulls,
                         const int* __restrict__ counts,
                         const float* __restrict__ quads,
                         const unsigned char* __restrict__ gt_valid,
                         const unsigned char* __restrict__ rows_valid,
                         float* __restrict__ out, int N, int G) {
  __shared__ Quad s_q[GT_TILE];
  __shared__ float s_ax[RING_A][THREADS], s_ay[RING_A][THREADS];
  __shared__ float s_bx[RING_B][THREADS], s_by[RING_B][THREADS];
  const int b = blockIdx.z;
  const int g0 = blockIdx.y * GT_TILE;
  const int tile = min(GT_TILE, G - g0);
  const int tid = threadIdx.x;
  const int n = blockIdx.x * THREADS + tid;

  if (tid < tile) {  // the quad side, once a block
    const int g = g0 + tid;
    const float* q = quads + ((size_t)b * G + g) * 8;
    Quad& s = s_q[tid];
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
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s.cx[e] = cx[e];
      s.cy[e] = cy[e];
      s.ex[e] = cx[(e + 1) % 4] - cx[e];
      s.ey[e] = cy[(e + 1) % 4] - cy[e];
    }
    s.ox = qox;
    s.oy = qoy;
    s.area = 0.5f * fabsf(area2_b);
    s.valid = gt_valid == nullptr || gt_valid[(size_t)b * G + g];
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
  const int n0 = min(cnt0, V);
  float* const ax = &s_ax[0][tid];
  float* const ay = &s_ay[0][tid];
  float* const bx = &s_bx[0][tid];
  float* const by = &s_by[0][tid];

  float* dst = out + ((size_t)b * G + g0) * N + n;
  for (int gi = 0; gi < tile; ++gi, dst += N) {
    const Quad& q = s_q[gi];
    if (!q.valid || !row_live) {
      *dst = -1.f;
      continue;
    }
    float hx[V], hy[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      hx[k] = hull[2 * k] - q.ox;
      hy[k] = hull[2 * k + 1] - q.oy;
    }
    // stage 0 reads the recentred hull from registers (static slots)
    int c = 0;
    {
      const float ex = q.ex[0], ey = q.ey[0], e0x = q.cx[0], e0y = q.cy[0];
      float sc = side_of(ex, ey, e0x, e0y, hx[0], hy[0]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (j >= n0) break;
        const bool wrap = j + 1 == n0;
        const float nx = wrap ? hx[0] : hx[(j + 1) % V];
        const float ny = wrap ? hy[0] : hy[(j + 1) % V];
        const float sn = side_of(ex, ey, e0x, e0y, nx, ny);
        c = emit_edge(hx[j], hy[j], sc, nx, ny, sn, c, V + 1, ax, ay);
        sc = sn;
      }
    }
    if (c > 0)
      c = clip_ring(ax, ay, c, V + 1, q.ex[1], q.ey[1], q.cx[1], q.cy[1], bx,
                    by, V + 2);
    if (c > 0)
      c = clip_ring(bx, by, c, V + 2, q.ex[2], q.ey[2], q.cx[2], q.cy[2], ax,
                    ay, V + 3);
    if (c > 0)
      c = clip_ring(ax, ay, c, V + 3, q.ex[3], q.ey[3], q.cx[3], q.cy[3], bx,
                    by, V + 4);
    if (c == 0) {  // an empty stage: the IoU is +0 (see the note above)
      *dst = 0.f;
      continue;
    }
    const int m = min(c, V + 4);
    float s = 0.f;
    for (int j = 0; j < m; ++j) {
      const int jn = j + 1 == m ? 0 : j + 1;
      s = s + (bx[j * THREADS] * by[jn * THREADS] -
               bx[jn * THREADS] * by[j * THREADS]);
    }
    const float inter = 0.5f * fabsf(s);
    const float area_a = 0.5f * fabsf(shoelace_slots<V>(hx, hy, cnt0));
    const float uni = fmaxf(area_a + q.area - inter, 1e-8f);
    *dst = inter / uni;
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
                                 int B, int N, int G, void* stream) {
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

// The pair IoU of a subject polygon (a hull of up to V vertices, or a quad
// with V = 4) and a convex clip quad, for kernels that run one thread per
// subject over a tile of clip quads staged in shared memory: the hull IoU
// (hull_iou.cu, V = 9), the NMS over-mask (quad_over.cu, V = 4) and the f32
// IoU matrices (quad_iou.cu, V = 4).
//
// Same arithmetic as the Pallas tile (orientedreppoints_tpu/ops/
// pallas_quad_iou.py, _quad_tile), operation for operation: recentre the
// pair on the quad's vertex 0 (class-offset NMS coordinates reach ~3e4,
// where f32 cross products of raw coordinates lose the overlap), the
// subject's signed area by the shoelace over its first count slots, orient
// the quad counter-clockwise (a clockwise quad is read as vertices 0, 3, 2,
// 1), Sutherland-Hodgman clip by its four half-planes into V + 1 .. V + 4
// slots (positions beyond a stage's cap dropped, its count not capped, the
// next vertex of the last slot read is slot 0), then
// inter / max(area_a + area_b - inter, 1e-8).  The kernels are built with
// -fmad=false, so the plain versions (ops/hull_iou.py) give the same bits.
//
// What makes it cheap:
//   - everything that depends on the quad alone (ClipQuad) is computed once
//     a block and read from shared memory as a broadcast;
//   - the clip stages emit each vertex straight to its slot of a ring in
//     shared memory laid out [slot][thread] (STRIDE threads, no bank
//     conflicts) and loop over the live count only; the sums over a ring
//     add the first count terms from slot 0, which gives the bits of the
//     masked sum over every slot (a sum that starts at +0 never becomes -0,
//     so adding +0 changes nothing);
//   - a stage that leaves no vertex ends the pair: every later stage leaves
//     none, the intersection is 0.5 |+0| = +0 and the union is at least
//     1e-8 (fmaxf drops a NaN), so the IoU is +0 bit for bit.  The
//     subject's own area is taken only for pairs whose clip is not empty.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct ClipQuad {  // what depends on the clip quad alone
  float ox, oy;        // vertex 0, the pair's origin
  float cx[4], cy[4];  // recentred corners, counter-clockwise
  float ex[4], ey[4];  // edges c[e] -> c[e + 1]
  float area;          // 0.5 |signed area|
};

// q: (8,) x/y interleaved
__device__ __forceinline__ ClipQuad clip_quad_of(const float* __restrict__ q) {
  ClipQuad s;
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
  return s;
}

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
// rules say, to the ring slots out[pos * STRIDE]; returns the new count.
template <int STRIDE>
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
      ox[pos * STRIDE] = cx + t * (nx - cx);
      oy[pos * STRIDE] = cy + t * (ny - cy);
    }
    ++pos;
  }
  if (in_nxt) {
    if (pos < cap) {
      ox[pos * STRIDE] = nx;
      oy[pos * STRIDE] = ny;
    }
    ++pos;
  }
  return pos;
}

// Keep the part of the ring polygon (its first min(cnt, in_cap) slots) left
// of the edge e0 -> e0 + e; returns the uncapped count of emitted vertices.
template <int STRIDE>
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
    const float nx = ix[jn * STRIDE], ny = iy[jn * STRIDE];
    const float sn = side_of(ex, ey, e0x, e0y, nx, ny);
    pos = emit_edge<STRIDE>(cx, cy, sc, nx, ny, sn, pos, out_cap, ox, oy);
    cx = nx;
    cy = ny;
    sc = sn;
  }
  return pos;
}

// IoU of the subject (hx, hy: V slots recentred on q's vertex 0, the first
// cnt0 live) and the clip quad q.  The rings are this thread's slot 0 of
// [V + 3][STRIDE] (a) and [V + 4][STRIDE] (b) arrays in shared memory.
template <int V, int STRIDE>
__device__ __forceinline__ float pair_iou(const float (&hx)[V],
                                          const float (&hy)[V], int cnt0,
                                          const ClipQuad& q,
                                          float* __restrict__ ax,
                                          float* __restrict__ ay,
                                          float* __restrict__ bx,
                                          float* __restrict__ by) {
  const int n0 = min(cnt0, V);
  // stage 0 reads the subject from registers (static slots)
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
      c = emit_edge<STRIDE>(hx[j], hy[j], sc, nx, ny, sn, c, V + 1, ax, ay);
      sc = sn;
    }
  }
  if (c > 0)
    c = clip_ring<STRIDE>(ax, ay, c, V + 1, q.ex[1], q.ey[1], q.cx[1],
                          q.cy[1], bx, by, V + 2);
  if (c > 0)
    c = clip_ring<STRIDE>(bx, by, c, V + 2, q.ex[2], q.ey[2], q.cx[2],
                          q.cy[2], ax, ay, V + 3);
  if (c > 0)
    c = clip_ring<STRIDE>(ax, ay, c, V + 3, q.ex[3], q.ey[3], q.cx[3],
                          q.cy[3], bx, by, V + 4);
  if (c == 0) return 0.f;  // an empty stage: the IoU is +0 (see above)
  const int m = min(c, V + 4);
  float s = 0.f;
  for (int j = 0; j < m; ++j) {
    const int jn = j + 1 == m ? 0 : j + 1;
    s = s + (bx[j * STRIDE] * by[jn * STRIDE] -
             bx[jn * STRIDE] * by[j * STRIDE]);
  }
  const float inter = 0.5f * fabsf(s);
  const float area_a = 0.5f * fabsf(shoelace_slots<V>(hx, hy, cnt0));
  const float uni = fmaxf(area_a + q.area - inter, 1e-8f);
  return inter / uni;
}

}  // namespace

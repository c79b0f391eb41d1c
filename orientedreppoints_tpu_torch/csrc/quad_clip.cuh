// Exact IoU of two convex quads, for the f32 IoU-matrix kernels
// (quad_iou.cu).  The over-mask kernel (quad_over.cu) evaluates the same
// arithmetic through clip_ring.cuh, so that an over-mask bit is exactly
// (f32 IoU > thr) of the same pair.
//
// The arithmetic of the Pallas tile (orientedreppoints_tpu/ops/
// pallas_quad_iou.py, _quad_tile), operation for operation: recentre the
// pair on the clip quad's vertex 0 (class-offset NMS coordinates reach
// ~3e4, where f32 cross products of raw coordinates lose the overlap), the
// subject's signed area by the shoelace, turn the clip quad counter-
// clockwise (a clockwise quad is read as vertices 0, 3, 2, 1), Sutherland-
// Hodgman clip of the subject by its four half-planes keeping at most 5, 6,
// 7 and 8 vertices, the shoelace of the clipped polygon, then
// inter / max(area_a + area_b - inter, 1e-8).  The plain PyTorch version
// (ops/quad_iou.py::quad_iou_pairs) keeps this order, and the library is
// built with -fmad=false, so the two give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAXV = 8;
constexpr float EPS = 1e-8f;

__device__ __forceinline__ float shoelace4(const float* x, const float* y) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int kn = (k + 1) & 3;
    s += x[k] * y[kn] - x[kn] * y[k];
  }
  return s;
}

// IoU of subject quad a and clip quad b, both (8,) x/y interleaved.
__device__ float quad_iou(const float* __restrict__ a,
                          const float* __restrict__ b) {
  const float ox = b[0], oy = b[1];
  float ax[4], ay[4], bx[4], by[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ax[k] = a[2 * k] - ox;
    ay[k] = a[2 * k + 1] - oy;
    bx[k] = b[2 * k] - ox;
    by[k] = b[2 * k + 1] - oy;
  }
  const float area2_a = shoelace4(ax, ay);
  const float area2_b = shoelace4(bx, by);
  const bool flip = area2_b < 0.f;
  float cxq[4], cyq[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int src = flip ? ((4 - k) & 3) : k;
    cxq[k] = bx[src];
    cyq[k] = by[src];
  }

  float vx[MAXV], vy[MAXV], wx[MAXV], wy[MAXV], side[MAXV];
  int cnt = 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    vx[k] = ax[k];
    vy[k] = ay[k];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int en = (e + 1) & 3;
    const float ex = cxq[en] - cxq[e], ey = cyq[en] - cyq[e];
    const float e0x = cxq[e], e0y = cyq[e];
    const int cap = 5 + e;
    for (int j = 0; j < cnt; ++j)
      side[j] = ex * (vy[j] - e0y) - ey * (vx[j] - e0x);
    int out = 0;
    for (int j = 0; j < cnt; ++j) {
      const int jn = (j + 1 == cnt) ? 0 : j + 1;
      const bool in_cur = side[j] >= 0.f;
      const bool in_nxt = side[jn] >= 0.f;
      if (in_cur != in_nxt) {
        const float denom = side[j] - side[jn];
        const float t = side[j] / (fabsf(denom) < 1e-12f ? 1.f : denom);
        if (out < cap) {
          wx[out] = vx[j] + t * (vx[jn] - vx[j]);
          wy[out] = vy[j] + t * (vy[jn] - vy[j]);
        }
        ++out;
      }
      if (in_nxt) {
        if (out < cap) {
          wx[out] = vx[jn];
          wy[out] = vy[jn];
        }
        ++out;
      }
    }
    cnt = out < cap ? out : cap;
    for (int j = 0; j < cnt; ++j) {
      vx[j] = wx[j];
      vy[j] = wy[j];
    }
  }
  float s = 0.f;
  for (int j = 0; j < cnt; ++j) {
    const int jn = (j + 1 == cnt) ? 0 : j + 1;
    s += vx[j] * vy[jn] - vx[jn] * vy[j];
  }
  const float inter = 0.5f * fabsf(s);
  const float uni =
      fmaxf(0.5f * fabsf(area2_a) + 0.5f * fabsf(area2_b) - inter, EPS);
  return inter / uni;
}

}  // namespace

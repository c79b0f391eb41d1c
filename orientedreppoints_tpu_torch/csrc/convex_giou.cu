// Aligned convex GIoU of each 9-point set's hull with its gt quad, and its
// gradient in the points: one thread a row.
//
// Replaces no TPU kernel: the JAX package leaves this function
// (orientedreppoints_tpu/ops/geometry.py, convex_giou) to XLA, which fuses
// it.  Run eagerly, its plain version (ops/geometry.py convex_giou, with
// autograd for the gradient) is ~780 launches a call and ~1,060 with the
// gradient, and a training step calls it 8 times: the six GIoU loss terms
// (value and gradient: core/losses.py) and APAA's two quality terms (value:
// core/apaa.py).  Those launches, not the card's work, set the loss's pace.
//
// Per row, the plain version's arithmetic in its order: the points and the
// quad shifted by the quad's mean; the gift-wrapping hull of the 9 points
// (geometry.convex_hull's selection rules: centroid-relative coordinates,
// scale-relative epsilons, the rank score * 1e9 - dist2 and its first-index
// ties); its Sutherland-Hodgman clip by the quad oriented counter-clockwise
// (a clockwise quad read in reverse: vertices 3, 2, 1, 0, where
// clip_ring.cuh reads 0, 3, 2, 1), 13 slots at every stage, positions
// beyond them dropped and counts not capped; the shoelace areas relative to
// vertex 0; the hull of all 13 points; GIoU = IoU - (C - U) / C with U and
// C clamped at 1e-8.  The gradient entry then runs a reverse pass through
// the same arithmetic inside the thread: the hulls' vertex choices carry no
// gradient (the hulls are gathers at chosen indices); each clip stage's
// intersections v + t (w - v), t = side(v) / (side(v) - side(w)), are
// differentiated in v and w from stage 3 back to stage 0; then the
// shoelace sums, the division and the clamps, scaled by the row's weight.
// Sums run in another order than PyTorch's, so values and gradients agree
// with the plain version to rounding, not bit for bit.  Built with
// -fmad=false like every kernel here; no atomics, so a run repeats bit for
// bit.
//
// Bound on the H100: operations.  A row reads 26 or 27 floats and writes 1
// or 19; its work is ~10^4 f32 operations, most of it the enclosing hull's
// 12 steps of 13 x 13 cross products.  At a training step's ~82,000 rows
// (R-50, batch 16) that is under 1 GFLOP, ~30 us at 33.5 T op/s.  A call
// is short and latency-bound: one long dependent chain a thread, a few
// warps an SM.  What the design does about it: the hull loops are unrolled
// over registers with the current vertex tracked by value; only the clip
// rings and the sources of their vertices, which the reverse pass reads
// again, live in local memory; blocks of 64 threads spread a call's rows
// over every SM; the forward-only entry (a template flag) skips the
// records and the reverse pass.

#include <cuda_runtime.h>
#include <math.h>

#include "clip_ring.cuh"  // side_of
#include "device.cuh"

namespace {

constexpr int K = 9;        // points a set
constexpr int KQ = K + 4;   // and the quad's corners: the enclosing hull's
constexpr int CAP = K + 4;  // clip ring slots at every stage
constexpr int THREADS = 64;
constexpr unsigned char CROSSING = 0x80;  // a source's flag: an intersection

// geometry.convex_hull of P points: the hull's point indices in scan order
// from the least x (first index on ties) into idx; returns their count.
// Not minarearect.cu's walk: that one keeps convex_hull_plain's rules (an
// absolute floor under the duplicate epsilon, the walk ends near the start
// by distance), this one geometry.convex_hull's (it ends on the start's
// index).
template <int P>
__device__ __forceinline__ int gift_wrap(const float (&x)[P],
                                         const float (&y)[P], int (&idx)[P]) {
  float sx = 0.f, sy = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    sx = sx + x[k];
    sy = sy + y[k];
  }
  const float mx = sx / (float)P, my = sy / (float)P;
  float cx[P], cy[P];
  float scale2 = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    cx[k] = x[k] - mx;
    cy[k] = y[k] - my;
    scale2 = fmaxf(scale2, cx[k] * cx[k] + cy[k] * cy[k]);
  }
  scale2 = fmaxf(scale2, 1e-12f);
  const float left_eps = 1e-6f * scale2, dup_eps = 1e-12f * scale2;
  int start = 0;
  float ux = cx[0], uy = cy[0];  // the current vertex, by value
#pragma unroll
  for (int k = 1; k < P; ++k) {
    if (cx[k] < ux) {
      start = k;
      ux = cx[k];
      uy = cy[k];
    }
  }
  idx[0] = start;
  int count = 1;
  for (int step = 1; step < P; ++step) {
    float dx[P], dy[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      dx[k] = cx[k] - ux;
      dy[k] = cy[k] - uy;
    }
    float best_rank = INFINITY, bx = 0.f, by = 0.f;
    int best = 0;
    bool any = false;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float d2 = dx[i] * dx[i] + dy[i] * dy[i];
      const bool ok = d2 > dup_eps;
      any = any || ok;
      int score = 0;
#pragma unroll
      for (int j = 0; j < P; ++j)
        score += (dx[i] * dy[j] - dy[i] * dx[j]) > left_eps;
      const float rank = ok ? (float)score * 1e9f - d2 : INFINITY;
      if (rank < best_rank) {
        best_rank = rank;
        best = i;
        bx = cx[i];
        by = cy[i];
      }
    }
    // no candidate, or back at the start: the walk is done
    if (!any || best == start) break;
    idx[count++] = best;
    ux = bx;
    uy = by;
  }
  return count;
}

// twice the signed area of the first n slots, relative to slot 0
__device__ __forceinline__ float shoelace2(const float* x, const float* y,
                                           int n) {
  const float x0 = x[0], y0 = y[0];
  float s = 0.f;
  for (int j = 0; j < n; ++j) {
    const int jn = j + 1 == n ? 0 : j + 1;
    const float px = x[j] - x0, py = y[j] - y0;
    const float qx = x[jn] - x0, qy = y[jn] - y0;
    s = s + (px * qy - qx * py);
  }
  return s;
}

__device__ __forceinline__ float sign_of(float v) {
  return (float)(v > 0.f) - (float)(v < 0.f);
}

// add c * d(shoelace2)/d(vertex) of the first n slots to gx, gy (c is the
// gradient of the sum; abs's sign and the 0.5 folded in by the caller)
__device__ __forceinline__ void shoelace2_grad(const float* x,
                                               const float* y, int n,
                                               float c, float* gx,
                                               float* gy) {
  for (int j = 0; j < n; ++j) {
    const int jn = j + 1 == n ? 0 : j + 1;
    const int jp = j == 0 ? n - 1 : j - 1;
    gx[j] = gx[j] + c * (y[jn] - y[jp]);
    gy[j] = gy[j] + c * (x[jp] - x[jn]);
  }
}

template <bool GRAD>
__global__ void __launch_bounds__(THREADS)
    convex_giou_kernel(const float* __restrict__ points,
                       const float* __restrict__ quads,
                       const float* __restrict__ weight,
                       float* __restrict__ giou, float* __restrict__ dgiou,
                       int n) {
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= n) return;

  // the quad's mean, then every point and corner shifted by it
  const float* q8 = quads + (size_t)row * 8;
  const float* p18 = points + (size_t)row * 2 * K;
  float qx[4], qy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    qx[k] = q8[2 * k];
    qy[k] = q8[2 * k + 1];
  }
  const float mx = (((qx[0] + qx[1]) + qx[2]) + qx[3]) / 4.f;
  const float my = (((qy[0] + qy[1]) + qy[2]) + qy[3]) / 4.f;
  float ax[KQ], ay[KQ];  // the 9 points, then the quad's corners
  float px[K], py[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    px[k] = ax[k] = p18[2 * k] - mx;
    py[k] = ay[k] = p18[2 * k + 1] - my;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    qx[k] = ax[K + k] = qx[k] - mx;
    qy[k] = ay[K + k] = qy[k] - my;
  }

  // the quad's area and orientation
  float s2q = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int kn = (k + 1) % 4;
    const float bx = qx[k] - qx[0], by = qy[k] - qy[0];
    const float nx = qx[kn] - qx[0], ny = qy[kn] - qy[0];
    s2q = s2q + (bx * ny - nx * by);
  }
  const float area_q = fabsf(0.5f * s2q);
  const bool flip = s2q < 0.f;
  float ox[4], oy[4];  // counter-clockwise corners
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ox[k] = flip ? qx[3 - k] : qx[k];
    oy[k] = flip ? qy[3 - k] : qy[k];
  }

  // the points' hull: ring 0 of the clip
  float rx[5][CAP], ry[5][CAP];  // ring s: the input of clip stage s
  int cnt[5];                    // each ring's uncapped count
  unsigned char src[4][CAP];     // stage s's output slot: its input edge
  int hidx[K];
  const int hn = gift_wrap<K>(px, py, hidx);
  for (int j = 0; j < hn; ++j) {
    rx[0][j] = px[hidx[j]];
    ry[0][j] = py[hidx[j]];
  }
  cnt[0] = hn;
  const float s2p = shoelace2(rx[0], ry[0], hn);
  const float area_p = fabsf(0.5f * s2p);

  // the clip, by the four half-planes left of the edges o[s] -> o[s + 1]
  for (int s = 0; s < 4; ++s) {
    const int n_in = min(cnt[s], s == 0 ? K : CAP);
    const float ex = ox[(s + 1) % 4] - ox[s], ey = oy[(s + 1) % 4] - oy[s];
    const float* ix = rx[s];
    const float* iy = ry[s];
    int pos = 0;
    if (n_in > 0) {
      float sc = side_of(ex, ey, ox[s], oy[s], ix[0], iy[0]);
      const float s0 = sc;
      for (int j = 0; j < n_in; ++j) {
        const int jn = j + 1 == n_in ? 0 : j + 1;
        const float sn =
            jn == 0 ? s0 : side_of(ex, ey, ox[s], oy[s], ix[jn], iy[jn]);
        const bool in_cur = sc >= 0.f, in_nxt = sn >= 0.f;
        if (in_cur != in_nxt) {
          const float denom = sc - sn;
          const float t = sc / (fabsf(denom) < 1e-12f ? 1.f : denom);
          if (pos < CAP) {
            rx[s + 1][pos] = ix[j] + t * (ix[jn] - ix[j]);
            ry[s + 1][pos] = iy[j] + t * (iy[jn] - iy[j]);
            if (GRAD) src[s][pos] = (unsigned char)j | CROSSING;
          }
          ++pos;
        }
        if (in_nxt) {
          if (pos < CAP) {
            rx[s + 1][pos] = ix[jn];
            ry[s + 1][pos] = iy[jn];
            if (GRAD) src[s][pos] = (unsigned char)j;
          }
          ++pos;
        }
        sc = sn;
      }
    }
    cnt[s + 1] = pos;
  }
  const int m4 = min(cnt[4], CAP);
  const float s2i = m4 > 0 ? shoelace2(rx[4], ry[4], m4) : 0.f;
  const float inter = fabsf(0.5f * s2i);

  // the hull of all 13 points
  int eidx[KQ];
  const int en = gift_wrap<KQ>(ax, ay, eidx);
  float hx[KQ], hy[KQ];
  for (int j = 0; j < en; ++j) {
    hx[j] = ax[eidx[j]];
    hy[j] = ay[eidx[j]];
  }
  const float s2c = shoelace2(hx, hy, en);
  const float c_area = fabsf(0.5f * s2c);

  const float uni = area_p + area_q - inter;
  const float uc = fmaxf(uni, 1e-8f), cc = fmaxf(c_area, 1e-8f);
  const float iou = inter / uc;
  const float r = (c_area - uni) / cc;
  giou[row] = iou - r;
  if (!GRAD) return;

  // ---- the reverse pass, from the row's weight ---------------------------
  const float w = weight[row];
  const float g_uc = -w * (iou / uc);  // iou = inter / uc
  const float g_num = -w / cc;         // r = (c_area - uni) / cc
  const float g_cc = w * (r / cc);
  const float g_c = g_num + (c_area >= 1e-8f ? g_cc : 0.f);
  const float g_u = -g_num + (uni >= 1e-8f ? g_uc : 0.f);
  const float g_inter = w / uc - g_u;  // uni = area_p + area_q - inter
  const float g_ap = g_u;

  float gpx[K], gpy[K];
#pragma unroll
  for (int k = 0; k < K; ++k) gpx[k] = gpy[k] = 0.f;

  // the enclosing hull's area -> its vertices among the points
  {
    float gx[KQ], gy[KQ];
    for (int j = 0; j < en; ++j) gx[j] = gy[j] = 0.f;
    shoelace2_grad(hx, hy, en, 0.5f * sign_of(s2c) * g_c, gx, gy);
    for (int j = 0; j < en; ++j) {
      const int k = eidx[j];
      if (k < K) {
        gpx[k] = gpx[k] + gx[j];
        gpy[k] = gpy[k] + gy[j];
      }
    }
  }

  // the intersection's area -> ring 4, then each clip stage in reverse
  float gx[CAP], gy[CAP], hgx[CAP], hgy[CAP];
  for (int j = 0; j < CAP; ++j) gx[j] = gy[j] = 0.f;
  if (m4 > 0)
    shoelace2_grad(rx[4], ry[4], m4, 0.5f * sign_of(s2i) * g_inter, gx, gy);
  for (int s = 3; s >= 0; --s) {
    const int n_in = min(cnt[s], s == 0 ? K : CAP);
    const int m = min(cnt[s + 1], CAP);
    const float ex = ox[(s + 1) % 4] - ox[s], ey = oy[(s + 1) % 4] - oy[s];
    const float* ix = rx[s];
    const float* iy = ry[s];
    for (int j = 0; j < CAP; ++j) hgx[j] = hgy[j] = 0.f;
    for (int o = 0; o < m; ++o) {
      const int j = src[s][o] & ~CROSSING;
      const int jn = j + 1 == n_in ? 0 : j + 1;
      if (!(src[s][o] & CROSSING)) {  // a copy of the edge's next vertex
        hgx[jn] = hgx[jn] + gx[o];
        hgy[jn] = hgy[jn] + gy[o];
        continue;
      }
      const float vx = ix[j], vy = iy[j], wx = ix[jn], wy = iy[jn];
      const float sc = side_of(ex, ey, ox[s], oy[s], vx, vy);
      const float sn = side_of(ex, ey, ox[s], oy[s], wx, wy);
      const float denom = sc - sn;
      const bool small = fabsf(denom) < 1e-12f;
      const float t = sc / (small ? 1.f : denom);
      const float g_t = gx[o] * (wx - vx) + gy[o] * (wy - vy);
      // t = sc / denom, denom = sc - sn (a constant 1 when small)
      const float g_den = small ? 0.f : -g_t * (t / denom);
      const float g_sc = g_t / (small ? 1.f : denom) + g_den;
      const float g_sn = -g_den;
      // side(v) = ex (v.y - a.y) - ey (v.x - a.x)
      hgx[j] = hgx[j] + (gx[o] - t * gx[o]) - g_sc * ey;
      hgy[j] = hgy[j] + (gy[o] - t * gy[o]) + g_sc * ex;
      hgx[jn] = hgx[jn] + t * gx[o] - g_sn * ey;
      hgy[jn] = hgy[jn] + t * gy[o] + g_sn * ex;
    }
    for (int j = 0; j < CAP; ++j) {
      gx[j] = hgx[j];
      gy[j] = hgy[j];
    }
  }
  // ring 0 is the points' hull: its own area too, then to the points
  shoelace2_grad(rx[0], ry[0], hn, 0.5f * sign_of(s2p) * g_ap, gx, gy);
  for (int j = 0; j < hn; ++j) {
    const int k = hidx[j];
    gpx[k] = gpx[k] + gx[j];
    gpy[k] = gpy[k] + gy[j];
  }
  float* d = dgiou + (size_t)row * 2 * K;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    d[2 * k] = gpx[k];
    d[2 * k + 1] = gpy[k];
  }
}

}  // namespace

// points (n, 18) f32, quads (n, 8) f32 -> giou (n,) f32; with weight (n,)
// f32 and dgiou (n, 18) f32 not null, also dgiou = weight * d giou / d
// points (weight and dgiou both null: the forward alone).
extern "C" int orp_convex_giou(const float* points, const float* quads,
                               const float* weight, float* giou,
                               float* dgiou, int n, int device,
                               void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  if ((weight == nullptr) != (dgiou == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    if (dgiou != nullptr)
      convex_giou_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
          points, quads, weight, giou, dgiou, n);
    else
      convex_giou_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
          points, quads, weight, giou, dgiou, n);
  }
  return (int)cudaGetLastError();
}

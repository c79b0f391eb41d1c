// Minimum-area enclosing rectangle of 9-point sets, 16 lanes a set.
//
// Replaces: orientedreppoints_tpu/ops/pallas_minarearect.py, _mar_kernel
// (entry min_area_rect_pallas via _run).  Same algorithm step for step:
// recentre on the centroid, gift-wrap the hull with scale-relative eps
// tests for duplicate and collinear points (value-tracked, first best
// wins), rotating calipers over the hull edges, rotate back.  A degenerate
// set (no usable edge) emits its point 4x.
//
// One deliberate difference: box areas within a relative TIE_RTOL of the
// least count as equal, and the first such hull edge wins.  Exact ties are
// common (when three hull points support the box, two edges give the same
// area, twice the triangle's), and in the JAX package rounding alone
// decides them, so two formulations would pick different, equally small
// boxes.  The plain version (ops/geometry.py::min_area_rect) applies the
// same rule, so the kernel and it pick the same box.
//
// Bound on the H100: latency.  Each set is ~700 cross products of
// register-resident floats against 72 bytes in and 140 bytes out, and at
// the decode's ~25k sets one thread a set fills about 6 warps of an SM's
// 64, each walking thousands of dependent operations.  So a set is spread
// over 4 lanes (8 sets a warp, 32 a block of 128 threads), which keeps the
// work that every lane repeats small:
//   - every lane loads the set (a broadcast) and computes the centroid,
//     the scale and the start point as one thread did, so all lanes hold
//     the same bits;
//   - gift wrapping: lane j ranks candidates j, j + 4, j + 8 in that order
//     (each with its 9 cross products), and two xor shuffles resolve the
//     first best (lowest rank, then lowest index); lane j keeps hull
//     vertices j, j + 4, j + 8, every lane the mask of valid ones;
//   - rotating calipers: every lane gathers the hull by shuffles, lane j
//     takes edges j, j + 4, j + 8 (9 rotations and extents each); shuffles
//     give the least area and the first edge within TIE_RTOL of it;
//   - lane j writes rect corner j and hull vertices j, j + 4, j + 8.
// Each candidate's and each edge's arithmetic is the one-thread version's,
// operation for operation, so the hull, count and rect keep its bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int K = 9;
constexpr float BIG = 1e20f;
constexpr float TIE_RTOL = 1e-5f;  // keep equal to geometry.py's TIE_RTOL

constexpr int LANES = 4;  // lanes a set
constexpr int SLOTS = 3;  // candidates, vertices and edges a lane: j + 4 k
constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float pick(const float (&v)[SLOTS], int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}

// 6 blocks an SM (85 registers a thread): the 24 warps an SM that the
// decode's 25k sets need, in one wave
__global__ void __launch_bounds__(THREADS, 6)
    mar_kernel(const float* __restrict__ pts, float* __restrict__ rect,
               float* __restrict__ hull, int* __restrict__ count, int n) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (LANES - 1);
  const int s = (int)((blockIdx.x * (size_t)THREADS + threadIdx.x) / LANES);
  // lanes past n compute set 0 and write nothing: every lane takes part in
  // the shuffles
  const bool active = s < n;
  const float2* p =
      reinterpret_cast<const float2*>(pts) + (size_t)(active ? s : 0) * K;
  float px[K], py[K];
  float cx = 0.f, cy = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float2 v = p[k];
    px[k] = v.x;
    py[k] = v.y;
    cx += px[k];
    cy += py[k];
  }
  cx /= K;
  cy /= K;
  float scale2 = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    px[k] -= cx;
    py[k] -= cy;
    scale2 = fmaxf(scale2, px[k] * px[k] + py[k] * py[k]);
  }
  const float left_eps = 1e-6f * scale2;
  const float dup_eps = 1e-12f * scale2 + 1e-30f;

  // start: min-x point (first on ties)
  float sx = px[0], sy = py[0];
#pragma unroll
  for (int k = 1; k < K; ++k) {
    if (px[k] < sx) {
      sx = px[k];
      sy = py[k];
    }
  }
  // this lane's candidates sub + 4 k
  float ox[SLOTS], oy[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    ox[k] = 0.f;
    oy[k] = 0.f;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      if (c == sub + LANES * k) {
        ox[k] = px[c];
        oy[k] = py[c];
      }
    }
  }

  // gift wrapping; lane j keeps hull vertices j + 4 k in hvx[k], hvy[k]
  float hvx[SLOTS] = {sx, sx, sx}, hvy[SLOTS] = {sy, sy, sy};
  unsigned vmask = 1u;  // valid hull vertices
  float curx = sx, cury = sy;
  bool done = false;
#pragma unroll 1
  for (int step = 1; step < K; ++step) {
    float best_rank = INFINITY, bx = curx, by = cury;
    int best = K;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int c = sub + LANES * k;
      const float dxc = ox[k] - curx;
      const float dyc = oy[k] - cury;
      const float d2 = dxc * dxc + dyc * dyc;
      float score = 0.f;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const float crs = dxc * (py[q] - cury) - dyc * (px[q] - curx);
        score += crs > left_eps ? 1.f : 0.f;
      }
      const float rank = c < K && d2 > dup_eps ? score * 1e9f - d2 : INFINITY;
      if (rank < best_rank) {
        best_rank = rank;
        best = c;
        bx = ox[k];
        by = oy[k];
      }
    }
#pragma unroll
    for (int d = LANES / 2; d > 0; d >>= 1) {
      const float r = __shfl_xor_sync(FULL, best_rank, d, LANES);
      const int b = __shfl_xor_sync(FULL, best, d, LANES);
      const float x = __shfl_xor_sync(FULL, bx, d, LANES);
      const float y = __shfl_xor_sync(FULL, by, d, LANES);
      if (r < best_rank || (r == best_rank && b < best)) {
        best_rank = r;
        best = b;
        bx = x;
        by = y;
      }
    }
    // no finite rank: the current vertex, as one thread leaves it
    if (!(best_rank < INFINITY)) {
      bx = best < K ? bx : curx;
      by = best < K ? by : cury;
    }
    const bool none_found = !isfinite(best_rank);
    const bool back = (bx - sx) * (bx - sx) + (by - sy) * (by - sy) <= dup_eps;
    done = done || none_found || back;
    const bool emit = !done;
    if (sub == (step & (LANES - 1))) {
      const int k = step / LANES;
      const float vx = emit ? bx : sx, vy = emit ? by : sy;
      if (k == 0) {
        hvx[0] = vx;
        hvy[0] = vy;
      } else if (k == 1) {
        hvx[1] = vx;
        hvy[1] = vy;
      } else {
        hvx[2] = vx;
        hvy[2] = vy;
      }
    }
    vmask |= (emit ? 1u : 0u) << step;
    if (emit) {
      curx = bx;
      cury = by;
    }
  }
  const int cnt = __popc(vmask);

  // the hull in every lane
  float hx[K], hy[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    hx[j] = __shfl_sync(FULL, hvx[j / LANES], j % LANES, LANES);
    hy[j] = __shfl_sync(FULL, hvy[j / LANES], j % LANES, LANES);
  }
  // rotating calipers: this lane's edges sub + 4 k, from vertex i to the
  // next valid one (vertex 0 after the last)
  float e_area[SLOTS], e_ct[SLOTS], e_st[SLOTS], e_x0[SLOTS], e_x1[SLOTS],
      e_y0[SLOTS], e_y1[SLOTS];
  float least = INFINITY;
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int i = sub + LANES * k;
    // vertex i + 1 is lane (sub + 1) & 3's slot k, or k + 1 after lane 3
    const float n0x = __shfl_sync(FULL, hvx[k], (sub + 1) & (LANES - 1), LANES);
    const float n0y = __shfl_sync(FULL, hvy[k], (sub + 1) & (LANES - 1), LANES);
    const float n1x = __shfl_sync(FULL, hvx[k < SLOTS - 1 ? k + 1 : k],
                                  (sub + 1) & (LANES - 1), LANES);
    const float n1y = __shfl_sync(FULL, hvy[k < SLOTS - 1 ? k + 1 : k],
                                  (sub + 1) & (LANES - 1), LANES);
    const bool next_ok = i + 1 < K && ((vmask >> (i + 1)) & 1u);
    const float nx = next_ok ? (sub == LANES - 1 ? n1x : n0x) : hx[0];
    const float ny = next_ok ? (sub == LANES - 1 ? n1y : n0y) : hy[0];
    const float ex = nx - hvx[k];
    const float ey = ny - hvy[k];
    const float elen = sqrtf(ex * ex + ey * ey);
    const bool e_ok = i < K && ((vmask >> i) & 1u) && elen > 1e-9f && cnt > 1;
    const float ct = e_ok ? ex / fmaxf(elen, 1e-9f) : 1.f;
    const float st = e_ok ? ey / fmaxf(elen, 1e-9f) : 0.f;
    float xmin = INFINITY, xmax = -INFINITY, ymin = INFINITY, ymax = -INFINITY;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float rx = ct * hx[j] + st * hy[j];
      const float ry = -st * hx[j] + ct * hy[j];
      const float big = (vmask >> j) & 1u ? 0.f : BIG;
      xmin = fminf(xmin, rx + big);
      xmax = fmaxf(xmax, rx - big);
      ymin = fminf(ymin, ry + big);
      ymax = fmaxf(ymax, ry - big);
    }
    e_area[k] = e_ok ? (xmax - xmin) * (ymax - ymin) : INFINITY;
    e_ct[k] = ct;
    e_st[k] = st;
    e_x0[k] = xmin;
    e_x1[k] = xmax;
    e_y0[k] = ymin;
    e_y1[k] = ymax;
    least = fminf(least, e_area[k]);
  }
#pragma unroll
  for (int d = LANES / 2; d > 0; d >>= 1)
    least = fminf(least, __shfl_xor_sync(FULL, least, d, LANES));
  // the first edge whose area is within TIE_RTOL of the least
  const float cut = least * (1.f + TIE_RTOL);
  int first = K;
#pragma unroll
  for (int k = SLOTS - 1; k >= 0; --k)
    if (sub + LANES * k < K && e_area[k] <= cut) first = sub + LANES * k;
#pragma unroll
  for (int d = LANES / 2; d > 0; d >>= 1)
    first = min(first, __shfl_xor_sync(FULL, first, d, LANES));
  const int fk = first < K ? first / LANES : 0;
  const int fl = first < K ? first % LANES : 0;
  const float b_ct = __shfl_sync(FULL, pick(e_ct, fk), fl, LANES);
  const float b_st = __shfl_sync(FULL, pick(e_st, fk), fl, LANES);
  const float b_x0 = __shfl_sync(FULL, pick(e_x0, fk), fl, LANES);
  const float b_x1 = __shfl_sync(FULL, pick(e_x1, fk), fl, LANES);
  const float b_y0 = __shfl_sync(FULL, pick(e_y0, fk), fl, LANES);
  const float b_y1 = __shfl_sync(FULL, pick(e_y1, fk), fl, LANES);
  if (!active) return;

  const bool degenerate = !isfinite(least);
  {  // corner sub of the rect
    const float rxs = sub == 0 || sub == 3 ? b_x0 : b_x1;
    const float rys = sub < 2 ? b_y0 : b_y1;
    float gx = b_ct * rxs - b_st * rys + cx;
    float gy = b_st * rxs + b_ct * rys + cy;
    if (degenerate) {
      gx = hx[0] + cx;
      gy = hy[0] + cy;
    }
    reinterpret_cast<float2*>(rect)[(size_t)s * 4 + sub] = make_float2(gx, gy);
  }
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {  // hull vertices sub + 4 k, padded by 0
    const int i = sub + LANES * k;
    if (i < K) {
      const bool ok = (vmask >> i) & 1u;
      reinterpret_cast<float2*>(hull)[(size_t)s * K + i] =
          make_float2((ok ? hvx[k] : hx[0]) + cx, (ok ? hvy[k] : hy[0]) + cy);
    }
  }
  if (sub == 0) count[s] = cnt;
}

}  // namespace

// points (n, 18) f32 -> rect (n, 8) f32, hull (n, 9, 2) f32, count (n,) i32.
extern "C" int orp_min_area_rect(const float* points, float* rect, float* hull,
                                 int* count, int n, void* stream) {
  if (n > 0) {
    const long long threads = (long long)n * LANES;
    mar_kernel<<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0,
                 (cudaStream_t)stream>>>(points, rect, hull, count, n);
  }
  return (int)cudaGetLastError();
}

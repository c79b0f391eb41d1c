// Backward of the paired deformable-conv sampling over an FPN pyramid.
//
// Replaces: orientedreppoints_tpu/ops/deform_conv.py, _pair_core_bwd (the
// default "combined" scatter; XLA in the JAX package, not a Pallas kernel).
// Given the f32 grads of the two (rows, K*C) im2col buffers (gs_a, gs_b,
// which the autograd node makes from the output grads and the DCN weights
// with an f32 result, as the JAX package's einsum with
// preferred_element_type=f32 does), it writes
//   * the grads of both feature tables into an f32 (rows, NT*C) scratch
//     (instance a in the first C columns, b in the last C), which the
//     wrapper rounds once to the table dtype.  Each value is the f32 sum,
//     from +0.0 and one term after another, of its contributions: lerp
//     weight x gs, with gs first rounded to the table dtype (JAX's
//     gs_a_dt), in the order of the plain version's scatter
//     (ops/deform_conv.py, _sample_backward_plain: corner 0..3, then
//     sample = row * K + tap ascending).  So the table grads are the plain
//     version's bit for bit, and the same from run to run;
//   * the grads of the shared (dy, dx) offsets: per sample, the f32 sum over
//     channels and both instances of the f32 gs x d(sample)/d(coordinate),
//     in a fixed order of their own (the plain version's reduction cannot
//     spell it, so they agree within rounding).
// The bilinear plan is recomputed from the offsets exactly as the forward
// (deform_sample.cu) computes it, and the corner values are read again
// from the tables: the JAX package keeps 8 corner residuals instead
// (2.8 GB at batch 2, 1344^2, C 256 in bf16), this kernel keeps none.
//
// The table grads are gathered by destination, with no float atomic and no
// order that an atomic decides.  An entry is a corner that lands on the map
// with a nonzero weight; its key is corner * S + sample (S = rows * K), so
// ascending keys are the plain version's order:
//   1. count: one thread a sample computes its plan, keeps each entry's
//      weight at its key and counts the entries of each destination row
//      (an integer atomic counts; the count does not depend on the order);
//   2. scan: an exclusive scan of the counts gives each row its segment;
//   3. place: each entry writes its key into its row's segment (an integer
//      atomic picks the slot);
//   4. sort: a segment longer than SHORT is sorted by one block (a bitonic
//      network, in shared memory where it fits, else in place in global
//      memory); a shorter one is ranked in registers by step 5;
//   5. sum: one warp a destination row, lanes across its NT*C columns
//      (16-byte loads and stores where C is a multiple of 4 and the
//      pointers are aligned), walks the keys in ascending order and adds
//      weight x rounded grad; every row is written once (+0.0 where it
//      has no entry).
// A segment's keys are distinct, so its sorted order, and with it every
// sum, is the same whatever slots step 3 gave them.
//
// The offset grads: for K = 9, C a multiple of CS and 16-byte aligned
// pointers, one block (1024 threads, one an SM) a tile of TH x TW pixels of
// one image and level: phase 0, once a block, every sample's plan (weights,
// corner, and a code a corner: window pixel, far or off the map; the window
// is the tile and a halo of HALO pixels) into shared memory; then per slice
// of CS channels (32 bytes of a table row) of one table, the next slice's
// grads and window rows staged by cp.async while this one is worked on,
// one barrier a slice; phase 1, sample-major: a group of CS / 4 lanes a
// sample (4 channels a lane) sums the offset grads' share of the slice from
// the f32 grads and the corners (the window's rows from shared memory, a far
// corner from global memory), in registers kept across the slices.
// Otherwise a scalar kernel (one warp a row, lanes walk single channels)
// with the same plan and arithmetic.
//
// Every kernel is a template on the table count NT, launched under one name
// a count (deform_sample_pair_bwd_*, deform_sample_bwd_*): NT = 1 is the
// backward of the single DCNv1 (JAX's autodiff of bilinear_gather under
// deform_conv2d / deform_conv2d_pyramid), with a (rows, C) scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int MAX_LEVELS = 8;
constexpr unsigned FULL = 0xffffffffu;
// tile kernel
constexpr int TH = 8, TW = 16, HALO = 4;
constexpr int WH = TH + 2 * HALO, WW = TW + 2 * HALO, NW = WH * WW;
constexpr int THREADS = 1024;
// scalar kernel
constexpr int WARPS = 8;
// table grads: threads a block of the count and place passes, of the scan
// (SCAN_ITEMS counts a thread), of the sort; the sum's warps a block, and
// its columns a lane and pass (SUM_U single ones, or SUM_VEC groups of 4);
// the longest segment the sum ranks itself; the keys a sort block holds in
// shared memory
constexpr int ENTRY_THREADS = 256;
constexpr int SCAN_THREADS = 1024, SCAN_ITEMS = 4;
constexpr int SCAN_CHUNK = SCAN_THREADS * SCAN_ITEMS;
constexpr int SORT_THREADS = 1024;
constexpr int SUM_WARPS = 8, SUM_U = 8, SUM_VEC = 2;
constexpr int SHORT = 64;
constexpr int SORT_SMEM = 10240;  // 40 KB of static shared memory

struct Levels {
  int start[MAX_LEVELS + 1];  // first row of each level, then total rows
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int tile_start[MAX_LEVELS + 1];  // first tile of each level, then total
  int tiles_x[MAX_LEVELS];         // tiles along x of one image
  int tiles_img[MAX_LEVELS];       // tiles of one image
  int count;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive table channels: one 8-byte (bf16) or 16-byte (f32) load.
template <typename T>
struct Quad;
template <>
struct Quad<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[4]) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xffff0000u);
  }
};
template <>
struct Quad<float> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
};

// The forward's plan of one sample, operation for operation: the integer
// corner (y0, x0) and the weights (wy, wx).
struct Plan {
  int y0, x0;
  float wy, wx;
};

__device__ __forceinline__ Plan plan_of(float dy, float dx, int k, int ks,
                                        int y, int x, int h, int w) {
  const int pad = (ks - 1) / 2;
  const float py = (dy + (float)(k / ks - pad)) + (float)y;
  const float px = (dx + (float)(k % ks - pad)) + (float)x;
  const float y0f = floorf(py), x0f = floorf(px);
  Plan p;
  p.wy = py - y0f;
  p.wx = px - x0f;
  // clamp before the int conversion; anything outside [-1, h] is a zero
  // corner either way
  p.y0 = (int)fminf(fmaxf(y0f, -2.f), (float)h + 1.f);
  p.x0 = (int)fminf(fmaxf(x0f, -2.f), (float)w + 1.f);
  return p;
}

// (1 - wy or wy) x (1 - wx or wx) of corner c = 2 dy + dx
__device__ __forceinline__ float corner_weight(float wy, float wx, int c) {
  return ((c & 2) ? wy : 1.f - wy) * ((c & 1) ? wx : 1.f - wx);
}

// ---------------------------------------------------------------------------
// The tile kernel, for the 3 x 3 DCN (K = 9): the offset grads.  A slice is
// CS channels (32 bytes of a table row) of one table; slices run table a's
// channel blocks, then table b's.  Shared memory (dynamic), for NS = TH * TW
// * K samples:
//   gsf    2 x NS x CS  float   the slice's f32 grads, double-buffered
//   tw     2 x NW x CS  T       the slice's table rows of the window
//   pw     NS           float2  (wy, wx); wy < 0 marks a sample off the map
//   pyx    NS           short2  (y0, x0)
//   code   NS x 4       u16     each corner: its window pixel, FAR (on the
//                               map, outside the window) or OFF (off it)
constexpr int TK = 9;
constexpr int NS = TH * TW * TK;
constexpr uint16_t FAR = 0xfffe, OFF = 0xffff;

template <typename T>
struct Tile {
  static constexpr int CS = 32 / sizeof(T);  // channels of a slice
  static constexpr int LPS = CS / 4;         // lanes a sample
  static constexpr int GROUPS = THREADS / LPS;
  static constexpr int ITERS = (NS + GROUPS - 1) / GROUPS;  // samples a group
  static constexpr size_t SMEM =
      2 * (size_t)NS * CS * sizeof(float) + 2 * (size_t)NW * CS * sizeof(T) +
      (size_t)NS * (8 + 4 + 8);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Four consecutive channels of T in f32 from shared memory.
__device__ __forceinline__ void quad_smem(const __nv_bfloat16* p,
                                          float (&v)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(r.x << 16);
  v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16);
  v[3] = __uint_as_float(r.y & 0xffff0000u);
}
__device__ __forceinline__ void quad_smem(const float* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}

template <typename T, int NT>
__device__ __forceinline__ void bwd_tile(
    const T* __restrict__ table_a, const T* __restrict__ table_b,
    const T* __restrict__ offsets, const float* __restrict__ grad_a,
    const float* __restrict__ grad_b, const Levels& lv, T* __restrict__ goff,
    int C) {
  using Cfg = Tile<T>;
  constexpr int CS = Cfg::CS, LPS = Cfg::LPS, GROUPS = Cfg::GROUPS;
  constexpr int ITERS = Cfg::ITERS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* gsf = reinterpret_cast<float*>(smem);
  T* tw = reinterpret_cast<T*>(gsf + 2 * NS * CS);
  float2* pw = reinterpret_cast<float2*>(tw + 2 * NW * CS);
  short2* pyx = reinterpret_cast<short2*>(pw + NS);
  uint2* code = reinterpret_cast<uint2*>(pyx + NS);  // 4 x u16 a sample

  // the block's level, image and tile
  int l = 0;
  while (l + 1 < lv.count && (int)blockIdx.x >= lv.tile_start[l + 1]) ++l;
  const int h = lv.h[l], w = lv.w[l];
  const int t = blockIdx.x - lv.tile_start[l];
  const int img = t / lv.tiles_img[l];
  const int ti = t - img * lv.tiles_img[l];
  const int ty0 = (ti / lv.tiles_x[l]) * TH, tx0 = (ti % lv.tiles_x[l]) * TW;
  const int wy0 = ty0 - HALO, wx0 = tx0 - HALO;
  const int img_base = lv.start[l] + img * h * w;
  const int tid = threadIdx.x, lane = tid & 31;
  const int blocks_c = C / CS, slices = NT * blocks_c;
  // sample s = pixel * K + tap; its grad row (row * K + tap) or -1
  auto grad_row = [&](int s) {
    const int p = s / TK;
    const int y = ty0 + p / TW, x = tx0 + p % TW;
    return y < h && x < w ? (img_base + y * w + x) * TK + (s - p * TK) : -1;
  };

  // stage slice j (grads and the window's table rows) into buffer j & 1
  auto stage = [&](int j) {
    const int tab = j / blocks_c, c0 = (j % blocks_c) * CS;
    const float* g = tab ? grad_b : grad_a;
    const T* tb = tab ? table_b : table_a;
    float* gdst = gsf + (j & 1) * NS * CS;
    T* tdst = tw + (j & 1) * NW * CS;
    constexpr int GCH = CS / 4;               // 16-byte chunks of grads
    constexpr int TCH = CS * sizeof(T) / 16;  // 16-byte chunks of a table row
    for (int i = tid; i < NS * GCH; i += THREADS) {
      const int s = i / GCH, q = i - s * GCH;
      const int gr = grad_row(s);
      if (gr >= 0)
        cp_async16(gdst + s * CS + 4 * q, g + (size_t)gr * C + c0 + 4 * q);
    }
    for (int i = tid; i < NW * TCH; i += THREADS) {
      const int p = i / TCH, q = i - p * TCH;
      const int y = wy0 + p / WW, x = wx0 + p % WW;
      if (y >= 0 && y < h && x >= 0 && x < w)
        cp_async16(reinterpret_cast<char*>(tdst + p * CS) + 16 * q,
                   reinterpret_cast<const char*>(
                       tb + (size_t)(img_base + y * w + x) * C + c0) +
                       16 * q);
    }
    cp_async_commit();
  };

  // phase 0: plans and corner codes
  stage(0);
  for (int s = tid; s < NS; s += THREADS) {
    const int gr = grad_row(s);
    if (gr < 0) {
      pw[s] = make_float2(-1.f, 0.f);
      continue;
    }
    const int row = gr / TK, k = gr - row * TK;
    const int rem = row - img_base, y = rem / w, x = rem - y * w;
    const Plan pl = plan_of(to_f32(offsets[2 * (size_t)gr]),
                            to_f32(offsets[2 * (size_t)gr + 1]), k, 3, y, x,
                            h, w);
    pw[s] = make_float2(pl.wy, pl.wx);
    pyx[s] = make_short2((short)pl.y0, (short)pl.x0);
    unsigned cd[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int yy = pl.y0 + (c >> 1), xx = pl.x0 + (c & 1);
      const int ry = yy - wy0, rx = xx - wx0;
      const bool inside = ry >= 0 && ry < WH && rx >= 0 && rx < WW;
      cd[c] = !(yy >= 0 && yy < h && xx >= 0 && xx < w)
                  ? OFF
                  : (inside ? (unsigned)(ry * WW + rx) : FAR);
    }
    code[s] = make_uint2(cd[0] | (cd[1] << 16), cd[2] | (cd[3] << 16));
  }

  // lane group g (LPS lanes, 4 channels each) takes samples g + i GROUPS,
  // their offset grads kept in registers across the slices
  const int grp = tid / LPS, q = lane % LPS;
  float sy[ITERS], sx[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) sy[it] = sx[it] = 0.f;

  for (int j = 0; j < slices; ++j) {
    // slice j is in buffer j & 1 once every thread's copies have landed;
    // the barrier also frees buffer (j + 1) & 1 of slice j - 1 (and, at
    // j = 0, publishes phase 0)
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < slices) stage(j + 1);
    const int tab = j / blocks_c, c0 = (j % blocks_c) * CS;
    const float* gs = gsf + (j & 1) * NS * CS;
    const T* tws = tw + (j & 1) * NW * CS;
    const T* table = tab ? table_b : table_a;

    // phase 1, sample-major: the offset grads' share of the slice
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int s = grp + it * GROUPS;
      float py = 0.f, px = 0.f;
      const float2 wyx = s < NS ? pw[s] : make_float2(-1.f, 0.f);
      if (wyx.x >= 0.f) {
        const float4 g =
            *reinterpret_cast<const float4*>(gs + s * CS + 4 * q);
        const uint2 cd = code[s];
        const unsigned cds[4] = {cd.x & 0xffffu, cd.x >> 16, cd.y & 0xffffu,
                                 cd.y >> 16};
        float v[4][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (cds[c] < NW) {
            quad_smem(tws + cds[c] * CS + 4 * q, v[c]);
          } else if (cds[c] == FAR) {
            const short2 yx = pyx[s];
            Quad<T>::load(table + (size_t)(img_base + (yx.x + (c >> 1)) * w +
                                           yx.y + (c & 1)) *
                                      C +
                              c0 + 4 * q,
                          v[c]);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) v[c][i] = 0.f;
          }
        }
        const float one_wy = 1.f - wyx.x, one_wx = 1.f - wyx.y;
        const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ddy =
              (v[2][i] - v[0][i]) * one_wx + (v[3][i] - v[1][i]) * wyx.y;
          const float ddx =
              (v[1][i] - v[0][i]) * one_wy + (v[3][i] - v[2][i]) * wyx.x;
          py += gv[i] * ddy;
          px += gv[i] * ddx;
        }
      }
#pragma unroll
      for (int d = LPS >> 1; d > 0; d >>= 1) {
        py += __shfl_xor_sync(FULL, py, d);
        px += __shfl_xor_sync(FULL, px, d);
      }
      sy[it] += py;
      sx[it] += px;
    }
  }
  if (q == 0) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int s = grp + it * GROUPS;
      const int gr = s < NS ? grad_row(s) : -1;
      if (gr < 0) continue;
      goff[2 * (size_t)gr] = from_f32<T>(sy[it]);
      goff[2 * (size_t)gr + 1] = from_f32<T>(sx[it]);
    }
  }
}

// ---------------------------------------------------------------------------
// The scalar kernel (any K, any C, any alignment): the offset grads, one
// warp a row, lanes walk single channels.
template <typename T, int NT>
__device__ __forceinline__ void bwd_scalar(
    const T* __restrict__ table_a, const T* __restrict__ table_b,
    const T* __restrict__ offsets, const float* __restrict__ grad_a,
    const float* __restrict__ grad_b, const Levels& lv, T* __restrict__ goff,
    int rows, int C, int K, int ks) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform over the warp
  int l = 0;
  while (l + 1 < lv.count && row >= lv.start[l + 1]) ++l;
  const int h = lv.h[l], w = lv.w[l];
  const int local = row - lv.start[l];
  const int img = local / (h * w);
  const int rem = local - img * h * w;
  const int y = rem / w, x = rem - y * w;
  const int img_base = lv.start[l] + img * h * w;
  for (int k = 0; k < K; ++k) {
    const size_t o = (size_t)row * 2 * K + 2 * k;
    const Plan pl = plan_of(to_f32(offsets[o]), to_f32(offsets[o + 1]), k,
                            ks, y, x, h, w);
    int crow[4];
    bool ok[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int yy = pl.y0 + (c >> 1), xx = pl.x0 + (c & 1);
      ok[c] = yy >= 0 && yy < h && xx >= 0 && xx < w;
      crow[c] = ok[c] ? img_base + yy * w + xx : 0;
    }
    const float one_wy = 1.f - pl.wy, one_wx = 1.f - pl.wx;
    const size_t g_row = ((size_t)row * K + k) * C;
    float sy = 0.f, sx = 0.f;
    for (int ch = lane; ch < C; ch += 32) {
      const float ga = grad_a[g_row + ch];
      const float gb = NT == 2 ? grad_b[g_row + ch] : 0.f;
      float va[4], vb[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        va[c] = ok[c] ? to_f32(table_a[(size_t)crow[c] * C + ch]) : 0.f;
        vb[c] = ok[c] && NT == 2 ? to_f32(table_b[(size_t)crow[c] * C + ch])
                                 : 0.f;
      }
      const float ddy_a = (va[2] - va[0]) * one_wx + (va[3] - va[1]) * pl.wx;
      const float ddx_a = (va[1] - va[0]) * one_wy + (va[3] - va[2]) * pl.wy;
      if constexpr (NT == 2) {
        const float ddy_b =
            (vb[2] - vb[0]) * one_wx + (vb[3] - vb[1]) * pl.wx;
        const float ddx_b =
            (vb[1] - vb[0]) * one_wy + (vb[3] - vb[2]) * pl.wy;
        sy += ga * ddy_a + gb * ddy_b;
        sx += ga * ddx_a + gb * ddx_b;
      } else {
        sy += ga * ddy_a;
        sx += ga * ddx_a;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      sy += __shfl_xor_sync(FULL, sy, d);
      sx += __shfl_xor_sync(FULL, sx, d);
    }
    if (lane == 0) {
      goff[o] = from_f32<T>(sy);
      goff[o + 1] = from_f32<T>(sx);
    }
  }
}

// ---------------------------------------------------------------------------
// The table grads (steps 1-5 of the header).

// Sample s's four corners: the destination row of each, or -1 where the
// corner is off the map or its weight is 0 (it adds nothing), and weights.
template <typename T>
__device__ __forceinline__ void sample_corners(const T* __restrict__ offsets,
                                               const Levels& lv, int s, int K,
                                               int ks, int (&dest)[4],
                                               float (&cw)[4]) {
  const int row = s / K, k = s - row * K;
  int l = 0;
  while (l + 1 < lv.count && row >= lv.start[l + 1]) ++l;
  const int h = lv.h[l], w = lv.w[l];
  const int local = row - lv.start[l];
  const int img = local / (h * w);
  const int rem = local - img * h * w;
  const int y = rem / w, x = rem - y * w;
  const int img_base = lv.start[l] + img * h * w;
  const Plan pl = plan_of(to_f32(offsets[2 * (size_t)s]),
                          to_f32(offsets[2 * (size_t)s + 1]), k, ks, y, x,
                          h, w);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int yy = pl.y0 + (c >> 1), xx = pl.x0 + (c & 1);
    cw[c] = corner_weight(pl.wy, pl.wx, c);
    dest[c] = yy >= 0 && yy < h && xx >= 0 && xx < w && cw[c] != 0.f
                  ? img_base + yy * w + xx
                  : -1;
  }
}

// 1. count: each entry's weight at its key, the entries of each row
template <typename T>
__global__ void __launch_bounds__(ENTRY_THREADS)
    tg_count(const T* __restrict__ offsets, Levels lv, int S, int K, int ks,
             float* __restrict__ wgt, int* __restrict__ cnt) {
  const int s = blockIdx.x * ENTRY_THREADS + threadIdx.x;
  if (s >= S) return;
  int dest[4];
  float cw[4];
  sample_corners(offsets, lv, s, K, ks, dest, cw);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (dest[c] < 0) continue;
    wgt[(size_t)c * S + s] = cw[c];
    atomicAdd(&cnt[dest[c]], 1);
  }
}

// The sum of v over the block (SCAN_THREADS threads), in every thread.
__device__ __forceinline__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  int t = lane < SCAN_THREADS / 32 ? red[lane] : 0;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) t += __shfl_xor_sync(FULL, t, d);
  __syncthreads();  // red may be written again
  return t;
}

// 2a. scan: the sum of each chunk of SCAN_CHUNK counts (the counts of rows
// 0 .. R - 1, then a 0 for row R)
__global__ void __launch_bounds__(SCAN_THREADS)
    tg_chunk_sums(const int* __restrict__ cnt, int R, int* __restrict__ bsum) {
  __shared__ int red[32];
  const int base = blockIdx.x * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS;
  int v = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i)
    v += base + i < R ? cnt[base + i] : 0;
  v = block_sum(v, red);
  if (threadIdx.x == 0) bsum[blockIdx.x] = v;
}

// 2b. scan: seg[i] = the counts of rows before i, for i = 0 .. R
__global__ void __launch_bounds__(SCAN_THREADS)
    tg_chunk_scan(const int* __restrict__ cnt, int R,
                  const int* __restrict__ bsum, int* __restrict__ seg) {
  __shared__ int red[32];
  __shared__ int warp_tot[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int pre = 0;  // the chunks before this one
  for (int j = threadIdx.x; j < (int)blockIdx.x; j += SCAN_THREADS)
    pre += bsum[j];
  pre = block_sum(pre, red);
  const int base = blockIdx.x * SCAN_CHUNK + threadIdx.x * SCAN_ITEMS;
  int v[SCAN_ITEMS], tot = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    v[i] = base + i < R ? cnt[base + i] : 0;
    tot += v[i];
  }
  // exclusive scan of the threads' totals: within the warp, then the warps
  int incl = tot;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_tot[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int x = lane < SCAN_THREADS / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x += u;
    }
    warp_tot[lane] = x;  // inclusive over the warps
  }
  __syncthreads();
  int run = pre + (wid ? warp_tot[wid - 1] : 0) + incl - tot;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    if (base + i <= R) seg[base + i] = run;
    run += v[i];
  }
}

// 3. place: each entry's key into its row's segment; cnt counts down to 0
template <typename T>
__global__ void __launch_bounds__(ENTRY_THREADS)
    tg_place(const T* __restrict__ offsets, Levels lv, int S, int K, int ks,
             const int* __restrict__ seg, int* __restrict__ cnt,
             unsigned* __restrict__ keys) {
  const int s = blockIdx.x * ENTRY_THREADS + threadIdx.x;
  if (s >= S) return;
  int dest[4];
  float cw[4];
  sample_corners(offsets, lv, s, K, ks, dest, cw);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (dest[c] < 0) continue;
    const int slot = seg[dest[c]] + atomicSub(&cnt[dest[c]], 1) - 1;
    keys[slot] = (unsigned)c * (unsigned)S + (unsigned)s;
  }
}

// Sort a[0 .. n) ascending with the block's threads: a bitonic network
// whose every comparator puts the smaller key at the lower index (each
// merge starts with the flip), so the keys past n (the padding to a power
// of two) act as +inf that never moves and are left out.
__device__ void bitonic_sort(unsigned* a, int n) {
  int p = 1;
  while (p < n) p <<= 1;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (p >> 1); i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = j == (k >> 1) ? (lo ^ (k - 1)) : lo + j;
        if (hi < n) {
          const unsigned x = a[lo], y = a[hi];
          if (x > y) {
            a[lo] = y;
            a[hi] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// 4. sort: the segments longer than SHORT among this block's rows
__global__ void __launch_bounds__(SORT_THREADS)
    tg_sort_long(const int* __restrict__ seg, int R,
                 unsigned* __restrict__ keys) {
  __shared__ unsigned sk[SORT_SMEM];
  __shared__ int rows_long[SORT_THREADS];
  __shared__ int n_long;
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
  const int r = blockIdx.x * SORT_THREADS + threadIdx.x;
  if (r < R && seg[r + 1] - seg[r] > SHORT)
    rows_long[atomicAdd(&n_long, 1)] = r;
  __syncthreads();
  for (int i = 0; i < n_long; ++i) {
    const int a = seg[rows_long[i]], n = seg[rows_long[i] + 1] - a;
    unsigned* g = keys + a;
    if (n <= SORT_SMEM) {
      for (int e = threadIdx.x; e < n; e += SORT_THREADS) sk[e] = g[e];
      __syncthreads();
      bitonic_sort(sk, n);
      for (int e = threadIdx.x; e < n; e += SORT_THREADS) g[e] = sk[e];
      __syncthreads();
    } else {
      bitonic_sort(g, n);
    }
  }
}

// 5. sum: one warp a destination row, its keys in ascending order
template <typename T, int NT>
__device__ __forceinline__ void tg_sum_row(
    const float* __restrict__ grad_a, const float* __restrict__ grad_b,
    const int* __restrict__ seg, const unsigned* __restrict__ keys,
    const float* __restrict__ wgt, int R, int C, int S, int vec,
    float* __restrict__ gtab) {
  __shared__ unsigned ranked[SUM_WARPS][SHORT];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int d = blockIdx.x * SUM_WARPS + wid;
  if (d >= R) return;  // uniform over the warp
  const int a = seg[d], n = seg[d + 1] - a;
  const unsigned* order = keys + a;
  if (n <= SHORT) {
    // rank the (distinct) keys: each lane's key goes to slot = the number
    // of smaller ones
    const unsigned k0 = lane < n ? keys[a + lane] : 0xffffffffu;
    const unsigned k1 = lane + 32 < n ? keys[a + lane + 32] : 0xffffffffu;
    int r0 = 0, r1 = 0;
    for (int j = 0; j < n; ++j) {
      const unsigned u0 = __shfl_sync(FULL, k0, j & 31);
      const unsigned u1 = __shfl_sync(FULL, k1, j & 31);
      const unsigned kj = j < 32 ? u0 : u1;
      r0 += kj < k0;
      r1 += kj < k1;
    }
    if (lane < n) ranked[wid][r0] = k0;
    if (lane + 32 < n) ranked[wid][r1] = k1;
    __syncwarp();
    order = ranked[wid];
  }
  const int cols = NT * C;
  const unsigned su = (unsigned)S;
  float* out = gtab + (size_t)d * cols;
  if (vec) {  // SUM_VEC float4 groups of columns a lane and pass
    for (int base = 0; base < cols; base += 128 * SUM_VEC) {
      const float* src[SUM_VEC];
      float acc[SUM_VEC][4];
#pragma unroll
      for (int v = 0; v < SUM_VEC; ++v) {
        const int col = base + 4 * (lane + 32 * v);
        const bool b = NT == 2 && col >= C;
        src[v] = col < cols ? (b ? grad_b + (col - C) : grad_a + col) : nullptr;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[v][i] = 0.f;
      }
#pragma unroll 2
      for (int e = 0; e < n; ++e) {
        const unsigned key = order[e];
        const unsigned c = (key >= su) + (key >= 2 * su) + (key >= 3 * su);
        const size_t s = key - c * su;
        const float cw = wgt[key];
#pragma unroll
        for (int v = 0; v < SUM_VEC; ++v)
          if (src[v]) {
            const float4 g =
                __ldg(reinterpret_cast<const float4*>(src[v] + s * C));
            acc[v][0] += to_f32(from_f32<T>(g.x)) * cw;
            acc[v][1] += to_f32(from_f32<T>(g.y)) * cw;
            acc[v][2] += to_f32(from_f32<T>(g.z)) * cw;
            acc[v][3] += to_f32(from_f32<T>(g.w)) * cw;
          }
      }
#pragma unroll
      for (int v = 0; v < SUM_VEC; ++v) {
        const int col = base + 4 * (lane + 32 * v);
        if (col < cols)
          *reinterpret_cast<float4*>(out + col) =
              make_float4(acc[v][0], acc[v][1], acc[v][2], acc[v][3]);
      }
    }
    return;
  }
  for (int base = 0; base < cols; base += 32 * SUM_U) {  // one column a lane
    const float* src[SUM_U];
    float acc[SUM_U];
#pragma unroll
    for (int u = 0; u < SUM_U; ++u) {
      const int col = base + lane + 32 * u;
      const bool b = NT == 2 && col >= C;
      src[u] = col < cols ? (b ? grad_b + (col - C) : grad_a + col) : nullptr;
      acc[u] = 0.f;
    }
    for (int e = 0; e < n; ++e) {
      const unsigned key = order[e];
      const unsigned c = (key >= su) + (key >= 2 * su) + (key >= 3 * su);
      const size_t s = key - c * su;
      const float cw = wgt[key];
#pragma unroll
      for (int u = 0; u < SUM_U; ++u)
        if (src[u])
          acc[u] += to_f32(from_f32<T>(src[u][s * C])) * cw;
    }
#pragma unroll
    for (int u = 0; u < SUM_U; ++u) {
      const int col = base + lane + 32 * u;
      if (col < cols) out[col] = acc[u];
    }
  }
}

// The kernels of one table count: one __global__ name a count and kernel,
// so that a trace tells the pair's launches from the single table's.
#define ORP_BWD_KERNELS(PREFIX, NT)                                           \
  template <typename T>                                                       \
  __global__ void __launch_bounds__(THREADS, 1) PREFIX##_tile(                \
      const T* __restrict__ table_a, const T* __restrict__ table_b,           \
      const T* __restrict__ offsets, const float* __restrict__ grad_a,        \
      const float* __restrict__ grad_b, Levels lv, T* __restrict__ goff,      \
      int C) {                                                                \
    bwd_tile<T, NT>(table_a, table_b, offsets, grad_a, grad_b, lv, goff, C);  \
  }                                                                           \
  template <typename T>                                                       \
  __global__ void __launch_bounds__(WARPS * 32) PREFIX##_scalar(              \
      const T* __restrict__ table_a, const T* __restrict__ table_b,           \
      const T* __restrict__ offsets, const float* __restrict__ grad_a,        \
      const float* __restrict__ grad_b, Levels lv, T* __restrict__ goff,      \
      int rows, int C, int K, int ks) {                                       \
    bwd_scalar<T, NT>(table_a, table_b, offsets, grad_a, grad_b, lv, goff,    \
                      rows, C, K, ks);                                        \
  }                                                                           \
  template <typename T>                                                       \
  __global__ void __launch_bounds__(SUM_WARPS * 32) PREFIX##_sum(             \
      const float* __restrict__ grad_a, const float* __restrict__ grad_b,     \
      const int* __restrict__ seg, const unsigned* __restrict__ keys,         \
      const float* __restrict__ wgt, int R, int C, int S, int vec,            \
      float* __restrict__ gtab) {                                             \
    tg_sum_row<T, NT>(grad_a, grad_b, seg, keys, wgt, R, C, S, vec, gtab);    \
  }

ORP_BWD_KERNELS(deform_sample_pair_bwd, 2)
ORP_BWD_KERNELS(deform_sample_bwd, 1)

template <typename T, int NT>
auto tile_kernel() {
  if constexpr (NT == 2)
    return deform_sample_pair_bwd_tile<T>;
  else
    return deform_sample_bwd_tile<T>;
}

template <typename T, int NT>
auto scalar_kernel() {
  if constexpr (NT == 2)
    return deform_sample_pair_bwd_scalar<T>;
  else
    return deform_sample_bwd_scalar<T>;
}

template <typename T, int NT>
auto sum_kernel() {
  if constexpr (NT == 2)
    return deform_sample_pair_bwd_sum<T>;
  else
    return deform_sample_bwd_sum<T>;
}

bool aligned(const void* p, uintptr_t n) { return ((uintptr_t)p % n) == 0; }

size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// The workspace of the table grads, in bytes, and where each part starts:
// cnt (R ints), seg (R + 1), bsum (one a scan chunk), keys (4 S u32), wgt
// (4 S f32), each 16-byte aligned (ops/deform_conv.py, _bwd_work_bytes,
// computes the same size).
struct Work {
  size_t cnt, seg, bsum, keys, wgt, bytes;
};

Work work_layout(long long rows, long long K) {
  const size_t R = (size_t)rows, E = 4 * (size_t)rows * (size_t)K;
  const size_t chunks = (R + 1 + SCAN_CHUNK - 1) / SCAN_CHUNK;
  Work w;
  w.cnt = 0;
  w.seg = align16(w.cnt + R * sizeof(int));
  w.bsum = align16(w.seg + (R + 1) * sizeof(int));
  w.keys = align16(w.bsum + chunks * sizeof(int));
  w.wgt = align16(w.keys + E * sizeof(unsigned));
  w.bytes = align16(w.wgt + E * sizeof(float));
  return w;
}

template <typename T, int NT>
int launch(const void* table_a, const void* table_b, const void* offsets,
           const float* grad_a, const float* grad_b, const int* levels,
           float* gtab, void* goff, void* work, long long work_bytes,
           int rows, int C, int K, int num_levels, int device, void* stream) {
  if (num_levels < 1 || num_levels > MAX_LEVELS || K < 1 || rows < 0)
    return (int)cudaErrorInvalidValue;
  // the keys (corner * S + sample) and the segment starts (int) must fit
  if (4 * (long long)rows * K >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const Work wl = work_layout(rows, K);
  if ((unsigned long long)work_bytes < wl.bytes)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.count = num_levels;
  lv.tile_start[0] = 0;
  for (int l = 0; l < num_levels; ++l) {
    lv.start[l] = levels[3 * l];
    lv.h[l] = levels[3 * l + 1];
    lv.w[l] = levels[3 * l + 2];
    const int next = l + 1 < num_levels ? levels[3 * l + 3] : rows;
    const int hw = lv.h[l] * lv.w[l];
    const int images = hw > 0 ? (next - lv.start[l]) / hw : 0;
    lv.tiles_x[l] = (lv.w[l] + TW - 1) / TW;
    lv.tiles_img[l] = lv.tiles_x[l] * ((lv.h[l] + TH - 1) / TH);
    lv.tile_start[l + 1] = lv.tile_start[l] + images * lv.tiles_img[l];
  }
  lv.start[num_levels] = rows;
  int ks = 1;
  while (ks * ks < K) ++ks;
  if (rows == 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;

  // the offset grads
  using Cfg = Tile<T>;
  int max_smem = 0;
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  const bool tile = K == TK && C % Cfg::CS == 0 &&
                    Cfg::SMEM + 64 <= (size_t)max_smem &&
                    aligned(table_a, 16) && aligned(grad_a, 16) &&
                    (NT == 1 ||
                     (aligned(table_b, 16) && aligned(grad_b, 16)));
  if (tile) {
    const auto kernel = tile_kernel<T, NT>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<lv.tile_start[num_levels], THREADS, Cfg::SMEM, st>>>(
        (const T*)table_a, (const T*)table_b, (const T*)offsets, grad_a,
        grad_b, lv, (T*)goff, C);
  } else {
    const auto kernel = scalar_kernel<T, NT>();
    kernel<<<(unsigned)((rows + WARPS - 1) / WARPS), WARPS * 32, 0, st>>>(
        (const T*)table_a, (const T*)table_b, (const T*)offsets, grad_a,
        grad_b, lv, (T*)goff, rows, C, K, ks);
  }

  // the table grads
  char* base = (char*)work;
  int* cnt = (int*)(base + wl.cnt);
  int* seg = (int*)(base + wl.seg);
  int* bsum = (int*)(base + wl.bsum);
  unsigned* keys = (unsigned*)(base + wl.keys);
  float* wgt = (float*)(base + wl.wgt);
  const int S = rows * K;
  cudaError_t err = cudaMemsetAsync(cnt, 0, (size_t)rows * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const unsigned entry_blocks = (unsigned)((S + ENTRY_THREADS - 1) /
                                           ENTRY_THREADS);
  const unsigned chunks = (unsigned)((rows + 1 + SCAN_CHUNK - 1) /
                                     SCAN_CHUNK);
  tg_count<T><<<entry_blocks, ENTRY_THREADS, 0, st>>>(
      (const T*)offsets, lv, S, K, ks, wgt, cnt);
  tg_chunk_sums<<<chunks, SCAN_THREADS, 0, st>>>(cnt, rows, bsum);
  tg_chunk_scan<<<chunks, SCAN_THREADS, 0, st>>>(cnt, rows, bsum, seg);
  tg_place<T><<<entry_blocks, ENTRY_THREADS, 0, st>>>(
      (const T*)offsets, lv, S, K, ks, seg, cnt, keys);
  tg_sort_long<<<(unsigned)((rows + SORT_THREADS - 1) / SORT_THREADS),
                 SORT_THREADS, 0, st>>>(seg, rows, keys);
  const int vec = C % 4 == 0 && aligned(grad_a, 16) && aligned(gtab, 16) &&
                  (NT == 1 || aligned(grad_b, 16));
  const auto sum = sum_kernel<T, NT>();
  sum<<<(unsigned)((rows + SUM_WARPS - 1) / SUM_WARPS), SUM_WARPS * 32, 0,
        st>>>(grad_a, grad_b, seg, keys, wgt, rows, C, S, vec, gtab);
  return (int)cudaGetLastError();
}

}  // namespace

// table_a, table_b (R, C); offsets (R, 2K); grad_a, grad_b (R, K*C) f32;
// levels: host int array of (first row, h, w) per level (rows of a level
// are image-major, then y, then x); gtab (R, NT*C) f32, every value
// written; goff (R, 2K) in the table dtype; work: work_bytes of device
// memory, 16-byte aligned, for the table grads' entries (work_layout; a
// smaller one is refused).  The single-table entries (NT =
// 1) take table_a and grad_a only.
#define ORP_DEFORM_SAMPLE_BWD(NAME, T, NT)                                   \
  extern "C" int NAME(const void* table_a, const void* table_b,             \
                      const void* offsets, const void* grad_a,              \
                      const void* grad_b, const int* levels, float* gtab,   \
                      void* goff, void* work, long long work_bytes,         \
                      int rows, int C, int K, int num_levels, int device,   \
                      void* stream) {                                       \
    const DeviceScope scope(device);                                         \
    if (scope.error() != cudaSuccess) return (int)scope.error();            \
    return launch<T, NT>(table_a, table_b, offsets, (const float*)grad_a,   \
                         (const float*)grad_b, levels, gtab, goff, work,    \
                         work_bytes, rows, C, K, num_levels, device,        \
                         stream);                                           \
  }

ORP_DEFORM_SAMPLE_BWD(orp_deform_sample_pair_bwd_f32, float, 2)
ORP_DEFORM_SAMPLE_BWD(orp_deform_sample_pair_bwd_bf16, __nv_bfloat16, 2)
ORP_DEFORM_SAMPLE_BWD(orp_deform_sample_bwd_f32, float, 1)
ORP_DEFORM_SAMPLE_BWD(orp_deform_sample_bwd_bf16, __nv_bfloat16, 1)

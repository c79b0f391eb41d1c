// Backward of the paired deformable-conv sampling over an FPN pyramid.
//
// Replaces: orientedreppoints_tpu/ops/deform_conv.py, _pair_core_bwd (the
// default "combined" scatter; XLA in the JAX package, not a Pallas kernel).
// Given the f32 grads of the two (rows, K*C) im2col buffers (gs_a, gs_b,
// which the autograd node makes from the output grads and the DCN weights
// with an f32 result, as the JAX package's einsum with
// preferred_element_type=f32 does), it writes
//   * the grads of both feature tables: every corner of every sample adds
//     lerp weight x gs, with gs first rounded to the table dtype (JAX's
//     gs_a_dt), into an f32 (rows, 2C) scratch (instance a in the first C
//     columns, b in the last C), zeroed by the wrapper, which then rounds it
//     once to the table dtype;
//   * the grads of the shared (dy, dx) offsets: per sample, the f32 sum over
//     channels and both instances of the f32 gs x d(sample)/d(coordinate).
// The bilinear plan is recomputed from the offsets exactly as the forward
// (deform_sample.cu) computes it, and the corner values are read again
// from the tables: the JAX package keeps 8 corner residuals instead
// (2.8 GB at batch 2, 1344^2, C 256 in bf16), this kernel keeps none.
//
// Bound on the H100.  At batch 2, 1344^2, C 256 with bf16 tables (75,212
// rows, 677k samples) it must read the two f32 grads (1.39 GB of the ~1.55
// GB it moves, 0.46 ms at 3.35 TB/s).  What held the first design (one
// warp a sample, one f32 atomic a channel and corner: ~1.4G atomics into
// L2) is the scatter: the card's L2 reductions run at ~0.6G f32 values a
// millisecond whether they come as scalars or as red.global.add.v4.f32,
// and f32 atomics on shared memory are a compare-and-swap loop.  So this
// design cuts the number of values that reach L2 (tools/profile_torch_dcn.py
// splits its time):
//   - one block (1024 threads, one an SM) a tile of TH x TW pixels of one
//     image and level; its samples' corners land, all but a few, in the
//     window of the tile and a halo of HALO pixels;
//   - phase 0, once a block: every sample's plan (weights, corner, and a
//     code a corner: window pixel, far or off the map) into shared memory,
//     and a counting sort of the corner entries by window pixel (integer
//     shared atomics, which are native) with each entry's weight; corners
//     outside the window go to a short list of far entries;
//   - then per slice of CS channels (32 bytes of a table row) of one table,
//     the next slice's grads and window rows staged by cp.async while this
//     one is worked on, with one barrier a slice:
//       phase 1, sample-major: a group of CS / 4 lanes a sample (4 channels
//       a lane) sums the offset grads' share of the slice from the f32
//       grads and the corners (the window's rows from shared memory, a far
//       corner from global memory), in registers kept across the slices;
//       phase 2, window-major: a group a window pixel sums weight x grad
//       (rounded to the table dtype) over its entries in registers and
//       issues one red.global.add.v4.f32 a pixel and 4 channels; far
//       entries issue theirs directly.
//   A table value takes one global reduction from each tile whose window
//   covers it (up to 9) and one from each far corner, instead of one a
//   corner (~36).  The offset grads are summed in a fixed order and
//   written once.
// The order of the atomics changes from run to run, so the table grads
// vary in the last bits of their f32 sums.  For K other than 9, C not a
// multiple of CS or a pointer not 16-byte aligned, the launcher takes a
// scalar kernel instead (one warp a row, lanes walk single channels, f32
// atomics straight to the scratch), with the same plan and arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr unsigned FULL = 0xffffffffu;
// tile kernel
constexpr int TH = 8, TW = 16, HALO = 4;
constexpr int WH = TH + 2 * HALO, WW = TW + 2 * HALO, NW = WH * WW;
constexpr int THREADS = 1024;
// scalar kernel
constexpr int WARPS = 8;

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
// The tile kernel, for the 3 x 3 DCN (K = 9).  A slice is CS channels (32
// bytes of a table row) of one table; slices run table a's channel blocks,
// then table b's.  Shared memory (dynamic), for NS = TH * TW * K samples:
//   gsf    2 x NS x CS  float   the slice's f32 grads, double-buffered
//   tw     2 x NW x CS  T       the slice's table rows of the window
//   pw     NS           float2  (wy, wx); wy < 0 marks a sample off the map
//   pyx    NS           short2  (y0, x0)
//   code   NS x 4       u16     each corner: its window pixel, FAR (on the
//                               map, outside the window) or OFF (off it)
//   start  NW + 1       int     first entry of each window pixel
//   cur    NW           int     counts, then fill cursors
//   ew     4 NS         float   each entry's lerp weight
//   ent    4 NS         u16     window entries from the front, far ones
//                               from the back; entry = sample * 4 + corner
constexpr int TK = 9;
constexpr int NS = TH * TW * TK;
constexpr uint16_t FAR = 0xfffe, OFF = 0xffff;

template <typename T>
struct Tile {
  static constexpr int CS = 32 / sizeof(T);  // channels of a slice
  static constexpr int LPS = CS / 4;         // lanes a sample or pixel
  static constexpr int GROUPS = THREADS / LPS;
  static constexpr int ITERS = (NS + GROUPS - 1) / GROUPS;  // samples a group
  static constexpr size_t SMEM =
      2 * (size_t)NS * CS * sizeof(float) + 2 * (size_t)NW * CS * sizeof(T) +
      (size_t)NS * (8 + 4 + 8) + (2 * NW + 1) * sizeof(int) +
      (size_t)NS * 4 * (sizeof(float) + sizeof(uint16_t));
};

// Four f32 atomic adds to p[0..3] in one reduction (p 16-byte aligned).
__device__ __forceinline__ void red_v4(float* p, float a, float b, float c,
                                       float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

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

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    deform_sample_pair_bwd_tile(const T* __restrict__ table_a,
                                const T* __restrict__ table_b,
                                const T* __restrict__ offsets,
                                const float* __restrict__ grad_a,
                                const float* __restrict__ grad_b, Levels lv,
                                float* __restrict__ gtab,
                                T* __restrict__ goff, int C) {
  using Cfg = Tile<T>;
  constexpr int CS = Cfg::CS, LPS = Cfg::LPS, GROUPS = Cfg::GROUPS;
  constexpr int ITERS = Cfg::ITERS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* gsf = reinterpret_cast<float*>(smem);
  T* tw = reinterpret_cast<T*>(gsf + 2 * NS * CS);
  float2* pw = reinterpret_cast<float2*>(tw + 2 * NW * CS);
  short2* pyx = reinterpret_cast<short2*>(pw + NS);
  uint2* code = reinterpret_cast<uint2*>(pyx + NS);  // 4 x u16 a sample
  int* start = reinterpret_cast<int*>(code + NS);
  int* cur = start + NW + 1;
  float* ew = reinterpret_cast<float*>(cur + NW);
  uint16_t* ent = reinterpret_cast<uint16_t*>(ew + 4 * NS);
  constexpr int CAP = 4 * NS;
  __shared__ int n_far;

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
  const int blocks_c = C / CS, slices = 2 * blocks_c;
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

  // phase 0: plans and corner codes, then the counting sort of the entries
  for (int i = tid; i < NW; i += THREADS) cur[i] = 0;
  if (tid == 0) n_far = 0;
  __syncthreads();
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
      const float cw = corner_weight(pl.wy, pl.wx, c);
      if (cd[c] == OFF || cw == 0.f) continue;
      if (inside) {
        atomicAdd(&cur[cd[c]], 1);
      } else {
        const int e = CAP - 1 - atomicAdd(&n_far, 1);
        ent[e] = (uint16_t)(s * 4 + c);
        ew[e] = cw;
      }
    }
    code[s] = make_uint2(cd[0] | (cd[1] << 16), cd[2] | (cd[3] << 16));
  }
  __syncthreads();
  if (tid < 32) {  // exclusive scan of the counts
    constexpr int per = (NW + 31) / 32;
    int sum = 0;
    for (int i = lane * per; i < min(NW, (lane + 1) * per); ++i) sum += cur[i];
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    int run = incl - sum;
    for (int i = lane * per; i < min(NW, (lane + 1) * per); ++i) {
      const int n = cur[i];
      start[i] = run;
      cur[i] = run;
      run += n;
    }
    if (lane == 31) start[NW] = incl;
  }
  __syncthreads();
  for (int s = tid; s < NS; s += THREADS) {
    const float2 wyx = pw[s];
    if (wyx.x < 0.f) continue;
    const uint2 cd = code[s];
    const unsigned cds[4] = {cd.x & 0xffffu, cd.x >> 16, cd.y & 0xffffu,
                             cd.y >> 16};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float cw = corner_weight(wyx.x, wyx.y, c);
      if (cds[c] < NW && cw != 0.f) {
        const int e = atomicAdd(&cur[cds[c]], 1);
        ent[e] = (uint16_t)(s * 4 + c);
        ew[e] = cw;
      }
    }
  }

  // lane group g (LPS lanes, 4 channels each) takes samples g + i GROUPS in
  // phase 1, its samples' offset grads kept in registers across the
  // slices, and window pixels g + i GROUPS in phase 2
  const int grp = tid / LPS, q = lane % LPS;
  float sy[ITERS], sx[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) sy[it] = sx[it] = 0.f;

  for (int j = 0; j < slices; ++j) {
    // slice j is in buffer j & 1 once every thread's copies have landed;
    // the barrier also frees buffer (j + 1) & 1 of slice j - 1
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < slices) stage(j + 1);
    const int nfar = n_far;
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
    // phase 2, window-major: the grads rounded to the table dtype, one
    // reduction a pixel and 4 channels (far entries one each)
    float* gcol = gtab + (size_t)tab * C + c0 + 4 * q;
    for (int i = grp; i < NW; i += GROUPS) {
      const int e0 = start[i], e1 = start[i + 1];
      if (e0 == e1) continue;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int e = e0; e < e1; ++e) {
        const float cw = ew[e];
        const float4 g = *reinterpret_cast<const float4*>(
            gs + (ent[e] >> 2) * CS + 4 * q);
        acc[0] += to_f32(from_f32<T>(g.x)) * cw;
        acc[1] += to_f32(from_f32<T>(g.y)) * cw;
        acc[2] += to_f32(from_f32<T>(g.z)) * cw;
        acc[3] += to_f32(from_f32<T>(g.w)) * cw;
      }
      const int row = img_base + (wy0 + i / WW) * w + wx0 + i % WW;
      red_v4(gcol + (size_t)row * 2 * C, acc[0], acc[1], acc[2], acc[3]);
    }
    for (int i = grp; i < nfar; i += GROUPS) {
      const int e = CAP - 1 - i;
      const int v = ent[e], s = v >> 2, c = v & 3;
      const float cw = ew[e];
      const short2 yx = pyx[s];
      const int row = img_base + (yx.x + (c >> 1)) * w + yx.y + (c & 1);
      const float4 g = *reinterpret_cast<const float4*>(gs + s * CS + 4 * q);
      red_v4(gcol + (size_t)row * 2 * C, to_f32(from_f32<T>(g.x)) * cw,
             to_f32(from_f32<T>(g.y)) * cw, to_f32(from_f32<T>(g.z)) * cw,
             to_f32(from_f32<T>(g.w)) * cw);
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
// The scalar kernel (any C, any alignment): one warp a row, lanes walk
// single channels, f32 atomics straight into the scratch.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    deform_sample_pair_bwd_scalar(const T* __restrict__ table_a,
                                  const T* __restrict__ table_b,
                                  const T* __restrict__ offsets,
                                  const float* __restrict__ grad_a,
                                  const float* __restrict__ grad_b,
                                  Levels lv, float* __restrict__ gtab,
                                  T* __restrict__ goff, int rows, int C,
                                  int K, int ks) {
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
    float cw[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int yy = pl.y0 + (c >> 1), xx = pl.x0 + (c & 1);
      ok[c] = yy >= 0 && yy < h && xx >= 0 && xx < w;
      crow[c] = ok[c] ? img_base + yy * w + xx : 0;
      cw[c] = corner_weight(pl.wy, pl.wx, c);
    }
    const float one_wy = 1.f - pl.wy, one_wx = 1.f - pl.wx;
    const size_t g_row = ((size_t)row * K + k) * C;
    float sy = 0.f, sx = 0.f;
    for (int ch = lane; ch < C; ch += 32) {
      const float ga = grad_a[g_row + ch], gb = grad_b[g_row + ch];
      const float ra = to_f32(from_f32<T>(ga)), rb = to_f32(from_f32<T>(gb));
      float va[4], vb[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        va[c] = ok[c] ? to_f32(table_a[(size_t)crow[c] * C + ch]) : 0.f;
        vb[c] = ok[c] ? to_f32(table_b[(size_t)crow[c] * C + ch]) : 0.f;
        if (ok[c] && cw[c] != 0.f) {
          atomicAdd(gtab + (size_t)crow[c] * 2 * C + ch, ra * cw[c]);
          atomicAdd(gtab + (size_t)crow[c] * 2 * C + C + ch, rb * cw[c]);
        }
      }
      const float ddy_a = (va[2] - va[0]) * one_wx + (va[3] - va[1]) * pl.wx;
      const float ddx_a = (va[1] - va[0]) * one_wy + (va[3] - va[2]) * pl.wy;
      const float ddy_b = (vb[2] - vb[0]) * one_wx + (vb[3] - vb[1]) * pl.wx;
      const float ddx_b = (vb[1] - vb[0]) * one_wy + (vb[3] - vb[2]) * pl.wy;
      sy += ga * ddy_a + gb * ddy_b;
      sx += ga * ddx_a + gb * ddx_b;
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

bool aligned(const void* p, uintptr_t n) { return ((uintptr_t)p % n) == 0; }

template <typename T>
int launch(const void* table_a, const void* table_b, const void* offsets,
           const float* grad_a, const float* grad_b, const int* levels,
           float* gtab, void* goff, int rows, int C, int K, int num_levels,
           void* stream) {
  if (num_levels < 1 || num_levels > MAX_LEVELS || K < 1)
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
  using Cfg = Tile<T>;
  int max_smem = 0;
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         0);
  const bool tile = K == TK && C % Cfg::CS == 0 &&
                    Cfg::SMEM + 64 <= (size_t)max_smem &&
                    aligned(table_a, 16) && aligned(table_b, 16) &&
                    aligned(grad_a, 16) && aligned(grad_b, 16);
  if (tile) {
    cudaError_t err = cudaFuncSetAttribute(
        deform_sample_pair_bwd_tile<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::SMEM);
    if (err != cudaSuccess) return (int)err;
    deform_sample_pair_bwd_tile<T><<<lv.tile_start[num_levels], THREADS,
                                     Cfg::SMEM, (cudaStream_t)stream>>>(
        (const T*)table_a, (const T*)table_b, (const T*)offsets, grad_a,
        grad_b, lv, gtab, (T*)goff, C);
  } else {
    deform_sample_pair_bwd_scalar<T>
        <<<(unsigned)((rows + WARPS - 1) / WARPS), WARPS * 32, 0,
           (cudaStream_t)stream>>>((const T*)table_a, (const T*)table_b,
                                   (const T*)offsets, grad_a, grad_b, lv,
                                   gtab, (T*)goff, rows, C, K, ks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// table_a, table_b (R, C); offsets (R, 2K); grad_a, grad_b
// (R, K*C) f32; levels: host int array of (first row, h, w) per level
// (rows of a level are image-major, then y, then x); gtab (R, 2C) f32,
// zeroed by the caller; goff (R, 2K) in the table dtype.
extern "C" int orp_deform_sample_pair_bwd_f32(
    const void* table_a, const void* table_b, const void* offsets,
    const void* grad_a, const void* grad_b, const int* levels, float* gtab,
    void* goff, int rows, int C, int K, int num_levels, void* stream) {
  return launch<float>(table_a, table_b, offsets, (const float*)grad_a,
                       (const float*)grad_b, levels, gtab, goff, rows, C, K,
                       num_levels, stream);
}

extern "C" int orp_deform_sample_pair_bwd_bf16(
    const void* table_a, const void* table_b, const void* offsets,
    const void* grad_a, const void* grad_b, const int* levels, float* gtab,
    void* goff, int rows, int C, int K, int num_levels, void* stream) {
  return launch<__nv_bfloat16>(table_a, table_b, offsets,
                               (const float*)grad_a, (const float*)grad_b,
                               levels, gtab, goff, rows, C, K, num_levels,
                               stream);
}

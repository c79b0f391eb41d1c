// Paired deformable-conv sampling (DCNv1 im2col) over a whole FPN pyramid.
//
// Replaces: orientedreppoints_tpu/ops/deform_conv.py, the forward of
// deform_conv2d_pyramid_pair (_pair_core_fwd_impl with the plan of
// _pyramid_plan_ext).  In JAX that is XLA gathers, not a Pallas kernel;
// PyTorch has no deformable conv, so the port needs its own.  The head's
// cls and refine DCNs sample at the same locations over two feature
// tables, so the bilinear plan (level, image, pixel, corners, weights) is
// computed once per (row, k) and both tables are gathered with it.
// Coordinates are f32 whatever the table dtype; corners outside the map
// read zero; the lerp is done in f32 in corner order 0..3, skipping a
// corner of weight 0, and rounded once to the table dtype, so the result
// has the bits of the plain version (ops/deform_conv.py).  The two
// (rows, K*C) im2col buffers are then multiplied by their (K*C, Cout)
// weights with torch.matmul outside this kernel, as the JAX package leaves
// that einsum to XLA.
//
// The work is a template on the table count NT, launched under one kernel
// name a count (deform_sample_pair_kernel, deform_sample_kernel), so that
// a trace tells them apart.  NT = 1 is the single DCNv1 (deform_conv2d /
// deform_conv2d_pyramid, the sampling of JAX's bilinear_gather and its
// _pyramid_plan takes): one table, one buffer,
// half the pair's gathers and stores, the same plan and arithmetic.
//
// Bound on the H100: memory.  At 1344^2, batch 4, C = 256 in bf16 (150,424
// rows, 1.35M samples) it writes two 693 MB im2col buffers, 1.39 GB of the
// 1.55 GB it must move (0.461 ms at 3.35 TB/s), and gathers 4 corners x 2
// tables x 512 B a sample (~5.5 GB, mostly L2 hits).  The design:
//   - one warp per row: the row's level, image, y and x are found once,
//     and its 2K offsets are read by one coalesced load and handed to the
//     lanes with __shfl_sync;
//   - 16-byte accesses: a lane owns 8 bf16 (or 4 f32) channels, so at
//     C = 256 bf16 a tap costs one uint4 load per corner and table and one
//     uint4 store per table, and a warp writes 512 contiguous bytes; where
//     C / 8 (C / 4) is below 32 the warp's lanes split over several taps;
//   - a lane issues its eight loads of a tap before the lerps, and the
//     kernel keeps to 85 registers (3 blocks an SM) so that 24 warps an SM
//     keep loads in flight: more warps, not more loads a warp, set the
//     gather rate;
//   - the im2col buffers are stored with the streaming hint (__stcs): they
//     are far beyond the 50 MB L2 and should not evict the tables.
// What holds it now is the gather: tools/profile_torch_dcn.py times the
// kernel beside builds of this source with the stores or the loads
// dropped, and the loads alone take about the kernel's time while the
// stores alone run near HBM's rate (PERF.md).  Fewer gather bytes
// need the table staged in shared memory by tiles of the map (later work).
// Where C does not split evenly into 16-byte chunks over the lanes, or a
// pointer is not 16-byte aligned, the launcher takes the scalar loop of the
// same kernel (lanes walk single channels of one tap), with the same plan
// and arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int WARPS = 8;        // rows per block
constexpr int MIN_BLOCKS = 3;   // blocks an SM: caps registers at 85
constexpr unsigned FULL = 0xffffffffu;

struct Levels {
  int start[MAX_LEVELS + 1];  // first row of each level, then total rows
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
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

// E consecutive channels of a table row: Raw is what one load moves,
// get(raw, i) its channel i in f32, store writes E lerped values.
template <typename T, int E>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ float get(const Raw& r, int i) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
    const unsigned u = w[i >> 1];  // little-endian: channel 2j low half
    return __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j + 1]))
              << 16);
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};

template <>
struct Chunk<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float get(const Raw& r, int i) {
    return i == 0 ? r.x : (i == 1 ? r.y : (i == 2 ? r.z : r.w));
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <typename T>
struct Chunk<T, 1> {  // the scalar loop
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ float get(const Raw& r, int) {
    return to_f32(r);
  }
  static __device__ __forceinline__ void store(T* p, const float (&v)[1]) {
    *p = from_f32<T>(v[0]);
  }
};

struct Tap {
  int row[4];  // table rows of the four corners (clamped into the map)
  float cw[4];  // their weights, 0 outside the map
  bool live;    // k < K
};

// The bilinear plan of tap k of the row at (img_base, y, x) on an h x w
// map; every lane of the warp calls it (the shuffles need all of them).
__device__ __forceinline__ Tap plan_tap(int k, int K, int ks, float off,
                                        int img_base, int y, int x, int h,
                                        int w) {
  Tap t;
  t.live = k < K;
  const int kk = t.live ? k : K - 1;
  const float dy = __shfl_sync(FULL, off, 2 * kk);
  const float dx = __shfl_sync(FULL, off, 2 * kk + 1);
  const int pad = (ks - 1) / 2;
  const float py = (dy + (float)(kk / ks - pad)) + (float)y;
  const float px = (dx + (float)(kk % ks - pad)) + (float)x;
  const float y0f = floorf(py), x0f = floorf(px);
  const float wy = py - y0f, wx = px - x0f;
  // clamp before the int conversion; anything outside [-1, h] is a zero
  // corner either way
  const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)h + 1.f);
  const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)w + 1.f);
  const float wys[2] = {1.f - wy, wy};
  const float wxs[2] = {1.f - wx, wx};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int yy = y0 + (c >> 1), xx = x0 + (c & 1);
    const bool ok = yy >= 0 && yy < h && xx >= 0 && xx < w;
    const int yc = yy < 0 ? 0 : (yy > h - 1 ? h - 1 : yy);
    const int xc = xx < 0 ? 0 : (xx > w - 1 ? w - 1 : xx);
    t.row[c] = img_base + yc * w + xc;
    t.cw[c] = ok ? wys[c >> 1] * wxs[c & 1] : 0.f;
  }
  return t;
}

// One warp per row.  The lanes split into 32 / lanes_per_tap groups of
// lanes_per_tap lanes; group i takes taps i, i + groups, ...; its lanes
// walk the tap's C / E chunks of E channels.
template <typename T, int E, int NT>
__device__ __forceinline__ void sample_rows(
    const T* __restrict__ table_a, const T* __restrict__ table_b,
    const T* __restrict__ offsets, const Levels& lv, T* __restrict__ out_a,
    T* __restrict__ out_b, int rows, int C, int K, int ks,
    int lanes_per_tap) {
  using Ch = Chunk<T, E>;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform over the warp

  int l = 0;
  while (l + 1 < lv.count && row >= lv.start[l + 1]) ++l;
  const int h = lv.h[l], w = lv.w[l];
  const int local = row - lv.start[l];
  const int hw = h * w;
  const int img = local / hw;
  const int rem = local - img * hw;
  const int y = rem / w, x = rem - y * w;
  const int img_base = lv.start[l] + img * hw;
  // the row's (dy, dx) pairs, lane j holding value j
  const float off =
      lane < 2 * K ? to_f32(offsets[(size_t)row * 2 * K + lane]) : 0.f;

  const int groups = 32 / lanes_per_tap;
  const int group = lane / lanes_per_tap;
  const int sub = lane - group * lanes_per_tap;
  const int chunks = C / E;
  const size_t out_row = (size_t)row * K * C;
  for (int kb = 0; kb < K; kb += groups) {
    const int k = kb + group;
    const Tap t = plan_tap(k, K, ks, off, img_base, y, x, h, w);
    if (!t.live) continue;
    for (int ch = sub; ch < chunks; ch += lanes_per_tap) {
      // the eight loads first, then the lerps
      typename Ch::Raw ra[4], rb[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const size_t at = (size_t)t.row[c] * C + (size_t)ch * E;
        ra[c] = Ch::load(table_a + at);
        if constexpr (NT == 2) rb[c] = Ch::load(table_b + at);
      }
      float va[E], vb[E];
#pragma unroll
      for (int i = 0; i < E; ++i) {
        va[i] = 0.f;
        vb[i] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (t.cw[c] != 0.f) {
#pragma unroll
          for (int i = 0; i < E; ++i) {
            va[i] += Ch::get(ra[c], i) * t.cw[c];
            if constexpr (NT == 2) vb[i] += Ch::get(rb[c], i) * t.cw[c];
          }
        }
      }
      const size_t at = out_row + (size_t)k * C + (size_t)ch * E;
      Ch::store(out_a + at, va);
      if constexpr (NT == 2) Ch::store(out_b + at, vb);
    }
  }
}

// The kernels: one __global__ name a table count.
#define ORP_SAMPLE_KERNEL(NAME, NT)                                          \
  template <typename T, int E>                                               \
  __global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)                  \
      NAME(const T* __restrict__ table_a, const T* __restrict__ table_b,     \
           const T* __restrict__ offsets, Levels lv, T* __restrict__ out_a,  \
           T* __restrict__ out_b, int rows, int C, int K, int ks,            \
           int lanes_per_tap) {                                              \
    sample_rows<T, E, NT>(table_a, table_b, offsets, lv, out_a, out_b, rows, \
                          C, K, ks, lanes_per_tap);                          \
  }

ORP_SAMPLE_KERNEL(deform_sample_pair_kernel, 2)
ORP_SAMPLE_KERNEL(deform_sample_kernel, 1)

template <typename T, int E, int NT>
auto sample_kernel() {
  if constexpr (NT == 2)
    return deform_sample_pair_kernel<T, E>;
  else
    return deform_sample_kernel<T, E>;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T, int E, int NT>
int launch(const void* table_a, const void* table_b, const void* offsets,
           const int* levels, void* out_a, void* out_b, int rows, int C,
           int K, int num_levels, void* stream) {
  if (num_levels < 1 || num_levels > MAX_LEVELS || K < 1 || 2 * K > 32)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.count = num_levels;
  for (int l = 0; l < num_levels; ++l) {
    lv.start[l] = levels[3 * l];
    lv.h[l] = levels[3 * l + 1];
    lv.w[l] = levels[3 * l + 2];
  }
  lv.start[num_levels] = rows;
  int ks = 1;
  while (ks * ks < K) ++ks;
  if (rows > 0) {
    const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
    const int chunks = C / E;
    const bool vector = C % E == 0 && chunks > 0 &&
                        (chunks % 32 == 0 || 32 % chunks == 0) &&
                        aligned16(table_a) && aligned16(out_a) &&
                        (NT == 1 || (aligned16(table_b) && aligned16(out_b)));
    // the 16-byte path, or the scalar loop (E = 1, a lane a channel)
    const auto kernel = vector ? sample_kernel<T, E, NT>()
                               : sample_kernel<T, 1, NT>();
    kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const T*)table_a, (const T*)table_b, (const T*)offsets, lv,
        (T*)out_a, (T*)out_b, rows, C, K, ks,
        vector && chunks < 32 ? chunks : 32);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// table_a, table_b (R, C); offsets (R, 2K) (dy, dx) pairs relative to the
// base grid, 2K <= 32; levels: host int array of (first row, h, w) per
// level (rows of a level are image-major, then y, then x); out_a, out_b
// (R, K*C).  The single-table entries take table_a and out_a only.
#define ORP_DEFORM_SAMPLE(NAME, T, E, NT)                                    \
  extern "C" int NAME(const void* table_a, const void* table_b,             \
                      const void* offsets, const int* levels, void* out_a,  \
                      void* out_b, int rows, int C, int K, int num_levels,  \
                      int device, void* stream) {                           \
    const DeviceScope scope(device);                                         \
    if (scope.error() != cudaSuccess) return (int)scope.error();            \
    return launch<T, E, NT>(table_a, table_b, offsets, levels, out_a, out_b, \
                            rows, C, K, num_levels, stream);                 \
  }

ORP_DEFORM_SAMPLE(orp_deform_sample_pair_f32, float, 4, 2)
ORP_DEFORM_SAMPLE(orp_deform_sample_pair_bf16, __nv_bfloat16, 8, 2)
ORP_DEFORM_SAMPLE(orp_deform_sample_f32, float, 4, 1)
ORP_DEFORM_SAMPLE(orp_deform_sample_bf16, __nv_bfloat16, 8, 1)

// Backward of the paired deformable-conv sampling over an FPN pyramid.
//
// Replaces: orientedreppoints_tpu/ops/deform_conv.py, _pair_core_bwd (the
// default "combined" scatter; XLA in the JAX package, not a Pallas kernel).
// Given the grads of the two (rows, K*C) im2col buffers (gs_a, gs_b, which
// torch.matmul makes from the output grads and the DCN weights, as JAX
// leaves that einsum to XLA), it writes
//   * the grads of both feature tables: every corner of every sample adds
//     lerp weight x gs into an f32 (rows, 2C) scratch (instance a in the
//     first C columns, b in the last C), which the wrapper rounds once to
//     the table dtype;
//   * the grads of the shared (dy, dx) offsets: per sample, the f32 sum over
//     channels and both instances of gs x d(sample)/d(coordinate).
// The weight grads (cols^T @ g_out) are left to torch.matmul's autograd.
//
// The bilinear plan is recomputed from the offsets exactly as the forward
// (deform_sample.cu) computes it, and the corner values are read again
// from the tables: the JAX package keeps 8 corner residuals instead
// (2.8 GB at batch 2, 1344^2, C 256 in bf16), this kernel keeps none.
//
// Bound on the H100: memory and L2 atomics.  Per sample it reads 2 x C
// grads and 2 tables x 4 corners x C values and issues up to 8 x C f32
// atomic adds (at batch 2, 1344^2, C 256: 677k samples, ~1.4G atomics that
// land in L2, since neighbouring samples share corners).  The design gives
// one warp to one (row, k) sample, as the forward does: the lanes walk the
// channels, so every read and every atomic is one contiguous run of C
// values, and the offset grads are two warp reductions.  Corners outside
// the map or of zero weight issue no atomics.  The order of the atomics
// changes from run to run, so the table grads vary in the last bits of
// their f32 sums.  Vector atomics (float2/float4 on sm_90) and staging in
// shared memory are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_LEVELS = 8;

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

template <typename T>
__global__ void deform_sample_pair_bwd_kernel(
    const T* __restrict__ table_a, const T* __restrict__ table_b,
    const T* __restrict__ offsets, const T* __restrict__ grad_a,
    const T* __restrict__ grad_b, Levels lv, float* __restrict__ gtab,
    T* __restrict__ goff, int rows, int C, int K, int ks) {
  const int lane = threadIdx.x & 31;
  const long long sample =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (sample >= (long long)rows * K) return;
  const int row = (int)(sample / K);
  const int k = (int)(sample % K);

  // the forward's plan, operation for operation
  int l = 0;
  while (l + 1 < lv.count && row >= lv.start[l + 1]) ++l;
  const int h = lv.h[l], w = lv.w[l];
  const int local = row - lv.start[l];
  const int hw = h * w;
  const int img = local / hw;
  const int rem = local - img * hw;
  const int y = rem / w, x = rem - (rem / w) * w;

  const int pad = (ks - 1) / 2;
  const float base_y = (float)(k / ks - pad);
  const float base_x = (float)(k % ks - pad);
  const float py =
      (to_f32(offsets[(size_t)row * 2 * K + 2 * k]) + base_y) + (float)y;
  const float px =
      (to_f32(offsets[(size_t)row * 2 * K + 2 * k + 1]) + base_x) + (float)x;
  const float y0f = floorf(py), x0f = floorf(px);
  const float wy = py - y0f, wx = px - x0f;
  const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)h + 1.f);
  const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)w + 1.f);

  const size_t img_base = (size_t)lv.start[l] + (size_t)img * hw;
  size_t trow[4];
  bool ok[4];
  float cw[4];
  const float wys[2] = {1.f - wy, wy};
  const float wxs[2] = {1.f - wx, wx};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int yy = y0 + (c >> 1), xx = x0 + (c & 1);
    ok[c] = yy >= 0 && yy < h && xx >= 0 && xx < w;
    const int yc = yy < 0 ? 0 : (yy > h - 1 ? h - 1 : yy);
    const int xc = xx < 0 ? 0 : (xx > w - 1 ? w - 1 : xx);
    trow[c] = img_base + (size_t)yc * w + xc;
    cw[c] = wys[c >> 1] * wxs[c & 1];
  }
  const float one_wy = 1.f - wy, one_wx = 1.f - wx;

  const size_t g_off = (size_t)row * K * C + (size_t)k * C;
  float sy = 0.f, sx = 0.f;
  for (int ch = lane; ch < C; ch += 32) {
    const float ga = to_f32(grad_a[g_off + ch]);
    const float gb = to_f32(grad_b[g_off + ch]);
    float va[4], vb[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      va[c] = ok[c] ? to_f32(table_a[trow[c] * C + ch]) : 0.f;
      vb[c] = ok[c] ? to_f32(table_b[trow[c] * C + ch]) : 0.f;
      if (ok[c] && cw[c] != 0.f) {
        atomicAdd(gtab + trow[c] * 2 * C + ch, ga * cw[c]);
        atomicAdd(gtab + trow[c] * 2 * C + C + ch, gb * cw[c]);
      }
    }
    const float ddy_a = (va[2] - va[0]) * one_wx + (va[3] - va[1]) * wx;
    const float ddx_a = (va[1] - va[0]) * one_wy + (va[3] - va[2]) * wy;
    const float ddy_b = (vb[2] - vb[0]) * one_wx + (vb[3] - vb[1]) * wx;
    const float ddx_b = (vb[1] - vb[0]) * one_wy + (vb[3] - vb[2]) * wy;
    sy += ga * ddy_a + gb * ddy_b;
    sx += ga * ddx_a + gb * ddx_b;
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    sy += __shfl_xor_sync(0xffffffffu, sy, s);
    sx += __shfl_xor_sync(0xffffffffu, sx, s);
  }
  if (lane == 0) {
    goff[(size_t)row * 2 * K + 2 * k] = from_f32<T>(sy);
    goff[(size_t)row * 2 * K + 2 * k + 1] = from_f32<T>(sx);
  }
}

template <typename T>
int launch(const void* table_a, const void* table_b, const void* offsets,
           const void* grad_a, const void* grad_b, const int* levels,
           float* gtab, void* goff, int rows, int C, int K, int num_levels,
           void* stream) {
  if (num_levels < 1 || num_levels > MAX_LEVELS)
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
    const int warps = 8;
    const long long samples = (long long)rows * K;
    const long long blocks = (samples + warps - 1) / warps;
    deform_sample_pair_bwd_kernel<T><<<(unsigned)blocks, warps * 32, 0,
                                       (cudaStream_t)stream>>>(
        (const T*)table_a, (const T*)table_b, (const T*)offsets,
        (const T*)grad_a, (const T*)grad_b, lv, gtab, (T*)goff, rows, C, K,
        ks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// table_a, table_b (R, C); offsets (R, 2K); grad_a, grad_b (R, K*C);
// levels: host int array of (first row, h, w) per level; gtab (R, 2C) f32,
// zeroed by the caller; goff (R, 2K) in the table dtype.
extern "C" int orp_deform_sample_pair_bwd_f32(
    const void* table_a, const void* table_b, const void* offsets,
    const void* grad_a, const void* grad_b, const int* levels, float* gtab,
    void* goff, int rows, int C, int K, int num_levels, void* stream) {
  return launch<float>(table_a, table_b, offsets, grad_a, grad_b, levels,
                       gtab, goff, rows, C, K, num_levels, stream);
}

extern "C" int orp_deform_sample_pair_bwd_bf16(
    const void* table_a, const void* table_b, const void* offsets,
    const void* grad_a, const void* grad_b, const int* levels, float* gtab,
    void* goff, int rows, int C, int K, int num_levels, void* stream) {
  return launch<__nv_bfloat16>(table_a, table_b, offsets, grad_a, grad_b,
                               levels, gtab, goff, rows, C, K, num_levels,
                               stream);
}

// Greedy NMS suppression scan over a score-sorted bitmask, one block per
// image, resolving 64 rows (one mask word) at a time.
//
// Replaces: orientedreppoints_tpu/ops/nms.py, greedy_scan_sorted (an XLA
// lax.fori_loop over row blocks in JAX, not a Pallas kernel; PyTorch has no
// counterpart, and a host loop of per-row launches would make decode
// host-bound).  Row i is kept iff it is valid and no earlier kept row
// suppresses it; the rows 0 .. nv[b]-1 are walked in order and a kept row
// ORs its mask words into the "removed" bitmask, held in shared memory.
// Rows at or past nv[b] suppress nothing; they are kept iff valid and not
// removed, as in the JAX scan.
//
// Bound on the H100: latency.  The walk is a chain of nv dependent
// decisions; the bytes (the kept rows' mask words, ~2.6 MB at B 4 x N 4096)
// would take about a microsecond.  What the design does about it:
//   - warp 0 resolves a block of 64 rows (one mask word) in registers: the
//     block's live candidates (valid, not removed) are a 64-bit word, and a
//     kept row clears the later rows it suppresses, two integer
//     instructions a row on a 32-bit half, the rows' diagonal words read
//     from shared memory ahead of the chain.  This needs the mask's bits
//     left of the diagonal to be 0, as quad_over_mask gives them;
//   - what a block's kept rows set in their own word and in the next word
//     (block k's part of word k + 1, all that block k + 1 needs from it)
//     is OR-reduced across warp 0 (__reduce_or_sync) off the chain, the
//     latter carried in a register;
//   - the other 15 warps OR block k - 1's kept rows into words k + 1 and
//     later while warp 0 resolves block k: a thread takes a word of 8 rows,
//     a warp's loads of a row are 32 neighbouring words, and the ORs into
//     shared memory are atomics (at most 8 a word);
//   - warp 0 stages the words k and k + 1 of block k's rows in shared
//     memory by cp.async two blocks ahead, and the rows' valid flags are
//     packed into words once, so no global load is on the chain;
//   - one __syncthreads a block of rows: 65 for 4096 rows.

#include <cuda_runtime.h>

#include "device.cuh"

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 512;  // warp 0 resolves, the other 15 warps OR
constexpr int GROUP = 8;      // rows a helper thread ORs into one word
constexpr int RING = 3;       // row blocks staged for warp 0
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ u64 or_reduce(u64 x) {  // across the warp
  return ((u64)__reduce_or_sync(FULL, (unsigned)(x >> 32)) << 32) |
         __reduce_or_sync(FULL, (unsigned)x);
}

__device__ __forceinline__ void copy_async8(u64* dst, const u64* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Warp 0: stage the words k and k + 1 of block k's rows (zeros past
// `rows` or past the last word) into a ring slot, as one cp.async group.
__device__ __forceinline__ void stage_rows(u64 (*slot)[2],
                                           const u64* __restrict__ mb, int k,
                                           int rows, int words, int lane) {
  for (int h = lane; h < 64; h += 32) {
    const int i = 64 * k + h;
    if (i < rows) {
      copy_async8(&slot[h][0], mb + (size_t)i * words + k);
      if (k + 1 < words)
        copy_async8(&slot[h][1], mb + (size_t)i * words + k + 1);
      else
        slot[h][1] = 0ull;
    } else {
      slot[h][0] = slot[h][1] = 0ull;
    }
  }
  asm volatile("cp.async.commit_group;");
}

__global__ void __launch_bounds__(THREADS)
    nms_scan_kernel(const u64* __restrict__ mask,
                    const bool* __restrict__ valid,
                    const int* __restrict__ nv, bool* __restrict__ keep,
                    int n, int words) {
  extern __shared__ u64 smem[];
  u64* removed = smem;       // [words]
  u64* vbits = smem + words;  // [words]: valid rows below `rows`, a block
  __shared__ u64 s_rows[RING][64][2];
  __shared__ u64 s_keep[2];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool* vb = valid + (size_t)b * n;
  bool* kb = keep + (size_t)b * n;
  const u64* mb = mask + (size_t)b * n * words;
  const int rows = max(0, min(nv[b], n));
  const int blocks = (rows + 63) / 64;
  for (int w = tid; w < words; w += THREADS) removed[w] = 0ull;
  for (int i0 = 32 * warp; i0 < 64 * blocks; i0 += THREADS) {
    const int i = i0 + lane;
    const unsigned m = __ballot_sync(FULL, i < rows && vb[i]);
    if (lane == 0) reinterpret_cast<unsigned*>(vbits)[i0 / 32] = m;
  }
  if (warp == 0) {
    stage_rows(s_rows[0], mb, 0, rows, words, lane);
    stage_rows(s_rows[1], mb, 1, rows, words, lane);
  }
  u64 carry = 0ull;  // warp 0: block k - 1's part of word k
  __syncthreads();

  // Iteration k: warp 0 resolves block k; the others OR block k - 1 into
  // words k + 1 and later (word k came with the carry).
  for (int k = 0; k <= blocks; ++k) {
    if (warp == 0) {
      if (k < blocks) {
        stage_rows(s_rows[(k + 2) % RING], mb, k + 2, rows, words, lane);
        asm volatile("cp.async.wait_group 2;");  // block k's group is in
        __syncwarp();
        const u64(*slot)[2] = s_rows[k % RING];
        // the block's live candidates: valid and not removed; a kept row
        // clears the later rows it suppresses, two instructions a row
        const u64 rem = removed[k] | carry;
        unsigned alo = (unsigned)vbits[k] & ~(unsigned)rem;
        unsigned ahi = (unsigned)(vbits[k] >> 32) & ~(unsigned)(rem >> 32);
        unsigned d[32];
#pragma unroll
        for (int r = 0; r < 32; ++r) d[r] = (unsigned)slot[r][0];
#pragma unroll
        for (int r = 0; r < 32; ++r)
          if (alo & (1u << r)) alo &= ~d[r];
        const bool kept0 = (alo >> lane) & 1u;
        const u64 d0 = slot[lane][0], d1 = slot[lane + 32][0];
        ahi &= ~__reduce_or_sync(FULL, kept0 ? (unsigned)(d0 >> 32) : 0u);
#pragma unroll
        for (int r = 0; r < 32; ++r) d[r] = (unsigned)(slot[32 + r][0] >> 32);
#pragma unroll
        for (int r = 0; r < 32; ++r)
          if (ahi & (1u << r)) ahi &= ~d[r];
        const bool kept1 = (ahi >> lane) & 1u;
        const int i0 = 64 * k + lane;
        if (i0 < rows) kb[i0] = kept0;
        if (i0 + 32 < rows) kb[i0 + 32] = kept1;
        // the block's word with every kept row's bits, and the kept rows'
        // next word (block k's part of word k + 1), off the chain
        const u64 dk = (kept0 ? d0 : 0ull) | (kept1 ? d1 : 0ull);
        const u64 c = (kept0 ? slot[lane][1] : 0ull) |
                      (kept1 ? slot[lane + 32][1] : 0ull);
        const u64 done = rem | or_reduce(dk);
        carry = or_reduce(c);
        if (lane == 0) {
          removed[k] = done;
          s_keep[k & 1] = ((u64)ahi << 32) | alo;
        }
      } else if (lane == 0 && k < words) {
        removed[k] |= carry;
      }
    } else if (k >= 1) {
      const u64 kept = s_keep[(k - 1) & 1];
      const int w0 = k + 1;
      const int span = words - w0;
      if (kept != 0ull && span > 0) {
        const u64* blk = mb + (size_t)64 * (k - 1) * words;
        for (int h = tid - 32; h < span * (64 / GROUP); h += THREADS - 32) {
          const int w = w0 + h % span, g = h / span;
          const unsigned bits = (unsigned)(kept >> (g * GROUP)) & 0xffu;
          if (bits == 0u) continue;
          const u64* src = blk + (size_t)g * GROUP * words + w;
          u64 acc = 0ull;
#pragma unroll
          for (int r = 0; r < GROUP; ++r)
            if ((bits >> r) & 1u) acc |= src[(size_t)r * words];
          if (acc != 0ull) atomicOr(&removed[w], acc);
        }
      }
    }
    __syncthreads();
  }
  for (int i = rows + tid; i < n; i += THREADS)
    kb[i] = vb[i] && !((removed[i >> 6] >> (i & 63)) & 1ull);
}

}  // namespace

// mask (B, N, W) uint64, valid (B, N) bool, nv (B,) i32 -> keep (B, N) bool.
extern "C" int orp_nms_scan(const void* mask, const bool* valid, const int* nv,
                            bool* keep, int batch, int n, int device,
                            void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  if (batch > 0 && n > 0) {
    const int words = (n + 63) / 64;
    const size_t smem = 2 * (size_t)words * sizeof(u64);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    nms_scan_kernel<<<batch, THREADS, smem, (cudaStream_t)stream>>>(
        (const u64*)mask, valid, nv, keep, n, words);
  }
  return (int)cudaGetLastError();
}

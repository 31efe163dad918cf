// The pieces the bf16 attention kernels share (mha.cu, mha_bwd.cu): tile
// sizes, operand descriptors, the scores' product and mask, and the
// row reductions over the wgmma accumulator layout (hopper.cuh).
//
// A warpgroup owns 64 query rows and walks key tiles of 128. Tiles of q, k,
// v and g are one head's (rows, D) slice of the flat (N, L, H) tensor,
// loaded by TMA through a 3-D map over (N, L, H) whose box is (1, rows, D)
// at column h D: the head is sliced on the way in and rows past L read as
// zero. A row is 2 D bytes: 128 (D = 64, the 128-byte swizzle) or 64 (D =
// 32, the 64-byte swizzle).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace bft {
namespace attn {

using namespace bft::sm90;

constexpr int BM = 64;   // query rows of a warpgroup
constexpr int BN = 128;  // keys of a tile
constexpr unsigned NEG_BIG_BITS = 0xff7fffffu;  // finfo(f32).min = -FLT_MAX

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <int D>
struct Rows {
  static constexpr int ROW = 2 * D;        // bytes of a row
  static constexpr int R64 = 64 * ROW;     // a tile of 64 rows
  static constexpr int R128 = 128 * ROW;   // a tile of 128 rows
};

// A K-major operand (rows along M or N, D contiguous K values each) and an
// MN-major one (rows along K, D contiguous M or N values), at ``p``; a k16
// step moves a K-major descriptor 32 bytes and an MN-major one 16 rows.
template <int D>
__device__ __forceinline__ uint64_t kdesc(const void* p) {
  return D == 64 ? desc_sw128(p, 16, 1024) : desc_sw64(p, 16, 512);
}
template <int D>
__device__ __forceinline__ uint64_t ndesc(const void* p) {
  return D == 64 ? desc_sw128(p, 8192, 1024) : desc_sw64(p, 4096, 512);
}

// A P or dS tile in shared memory for the transposed products (dV = P^T g,
// dK = dS^T q): 128 query rows by 128 keys in bf16, as two 64-key chunks
// of 128 rows x 128 bytes with the 128-byte swizzle, so that chunk c is
// the MN-major A operand of keys 64 c .. 64 c + 63.
constexpr int PCHUNK = 128 * 128;  // bytes of a chunk
constexpr int PTILE = 2 * PCHUNK;

__device__ __forceinline__ uint64_t pdesc(const unsigned char* tile, int chunk, int kk) {
  return desc_sw128(tile + chunk * PCHUNK + kk * 2048, PCHUNK, 1024);
}

// d (64 x D) += or = a b, m64nDk16: both from shared memory (TA / TB: 1 for
// an MN-major operand) or A from registers (B MN-major).
template <int D, int TA, int TB>
__device__ __forceinline__ void mma_d(float (&d)[D / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (D == 64)
    wgmma_m64n64k16<TA, TB>(d, a, b, acc);
  else
    wgmma_m64n32k16<TA, TB>(d, a, b, acc);
}
template <int D>
__device__ __forceinline__ void mma_d_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  if constexpr (D == 64)
    wgmma_m64n64k16_rs<1>(d, a, b, acc);
  else
    wgmma_m64n32k16_rs<1>(d, a, b, acc);
}

// Issue s (64 rows of ``a`` by the 128 rows of ``b``) = a b^T, both K-major
// with D values a row, f32, unscaled; the caller commits and waits.
template <int D>
__device__ __forceinline__ void issue_rows_by_keys(float (&s)[64], const unsigned char* a,
                                                   const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n128k16<0, 0>(s, kdesc<D>(a + kk * 32), kdesc<D>(b + kk * 32), kk > 0);
}

// The masked f32 scores of the thread's elements of key tile t, as
// _mha_xla's: (acc * scale) + bias, then NEG_BIG above the diagonal (a
// select, after the bias), and -inf for keys past L, which then drop out
// of every max and sum. The thread's rows are queries qi0 and qi0 + 8, its
// columns 8 j + c0 and + 1 (hopper.cuh's accumulator layout).
template <bool CAUSAL>
__device__ __forceinline__ void mask_scores(float (&s)[64], const float* __restrict__ brow,
                                            int t, int c0, int qi0, int L, float scale) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = t * BN + 8 * j + c0 + (e & 1);
      const float b = __ldg(brow + (key < L ? key : L - 1));
      float x = __fadd_rn(__fmul_rn(s[4 * j + e], scale), b);
      if (CAUSAL) x = key > qi0 + 8 * (e >> 1) ? __int_as_float(NEG_BIG_BITS) : x;
      s[4 * j + e] = key < L ? x : neg_inf();
    }
    // keep later columns' bias loads from being hoisted above this group
    // (all 64 at once spilled the accumulators), 16 at a time
    if ((j & 3) == 3) asm volatile("" ::: "memory");
  }
}

// The max and sum over the quad (the four threads that hold a row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The thread's max over its half hf (0: row r, 1: row r + 8) of s.
__device__ __forceinline__ float row_max(const float (&s)[64], int hf) {
  float m = neg_inf();
#pragma unroll
  for (int j = 0; j < 16; ++j) m = fmaxf(m, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
  return m;
}

// Whether a row of max m over its causal prefix gets exactly zero from
// the keys past it: exp(NEG_BIG - m) is 0 in f32. Not on a row whose
// prefix is all masked (m = NEG_BIG), which stays uniform over all L keys.
__device__ __forceinline__ bool future_is_zero(float m) {
  return expf(__int_as_float(NEG_BIG_BITS) - m) == 0.0f;
}

// s (the accumulator of 128 keys) as the register A operands of the 8 k16
// steps of a product over those keys, in bf16 (hopper.cuh).
__device__ __forceinline__ void to_frags(const float (&s)[64], uint32_t (&a)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// The thread's elements of s in bf16 into a P / dS tile (PTILE layout) at
// row ``row0`` (and row0 + 8) of the 128.
__device__ __forceinline__ void store_ptile(unsigned char* tile, const float (&s)[64], int row0,
                                            int lane) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + 8 * hf;
      unsigned char* p = tile + (j >> 3) * PCHUNK + row * 128 +
                         ((((j & 7) ^ (row & 7))) << 4) + 4 * (lane & 3);
      *reinterpret_cast<uint32_t*>(p) = pack_bf16(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]);
    }
  }
}

// The thread's elements of a (64 x D) accumulator, times ``mul``, in bf16
// to rows row0 and row0 + 8 of the head's slice (rows < L only).
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out, const float (&o)[D / 2],
                                           int n, int h, int row0, int c0, int L, int H,
                                           float mul) {
#pragma unroll
  for (int jn = 0; jn < D / 8; ++jn) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + 8 * hf;
      __nv_bfloat16* dst =
          out + (static_cast<size_t>(n) * L + (r < L ? r : 0)) * H + h * D + 8 * jn + c0;
      st_b32(dst, pack_bf16(o[4 * jn + 2 * hf] * mul, o[4 * jn + 2 * hf + 1] * mul), r < L);
    }
  }
}

}  // namespace attn
}  // namespace bft

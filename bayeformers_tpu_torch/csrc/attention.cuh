// The pieces the bf16 attention kernels share (mha.cu, mha_bwd.cu): tile
// sizes, operand descriptors, the scores' product and mask, and the
// row reductions over the wgmma accumulator layout (hopper.cuh).
//
// A warpgroup owns 64 query rows and walks key tiles of 128 (64 at head
// width 256, key_tile). Tiles of q, k, v and g are one head's (rows, D)
// slice of the flat (N, L, H) tensor, loaded by TMA through a 3-D map over
// (N, L, H) whose box is (1, rows, min(D, 64)) at column h D: the head is
// sliced on the way in and rows past L read as zero. A row is 2 D bytes:
// 64 (D = 32, the 64-byte swizzle), 128 (D = 64, the 128-byte swizzle), or
// 256 and 512 (D = 128, 256), loaded as two or four 64-column boxes into
// chunks of their own, each with the 128-byte swizzle (Rows, tma_tile).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace bft {
namespace attn {

using namespace bft::sm90;

constexpr int BM = 64;   // query rows of a warpgroup
constexpr int BN = 128;  // keys of a tile up to head width 128; query rows of
                         // the backward's blocks and steps at every width
constexpr unsigned NEG_BIG_BITS = 0xff7fffffu;  // finfo(f32).min = -FLT_MAX

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// The key tile at head width D: 128 keys, or 64 at D = 256, where a
// warpgroup's O or dQ accumulator (64 x 256 f32, 128 registers a thread)
// leaves room for the scores of 64 keys only, and two stages of 128-key k
// and v tiles (256 KB) would not fit in shared memory.
template <int D>
__host__ __device__ constexpr int key_tile() {
  return D >= 256 ? 64 : BN;
}

template <int D>
struct Rows {
  static constexpr int ROW = 2 * D;        // bytes of a row
  static constexpr int R64 = 64 * ROW;     // a tile of 64 rows
  static constexpr int R128 = 128 * ROW;   // a tile of 128 rows
  // A row wider than 128 bytes (D = 128, 256) is stored as 64-column
  // chunks, each all of the tile's rows of 128 bytes (hopper.cuh): a row's
  // bytes in a chunk, the chunks, and the TMA box's columns.
  static constexpr int ROWB = D >= 64 ? 128 : ROW;
  static constexpr int CHUNKS = D >= 64 ? D / 64 : 1;
  static constexpr int BOX = D >= 64 ? 64 : D;
};

// A (R, D) tile of one head into shared memory by TMA: one box of R rows
// for each 64-column chunk, chunk c at c R ROWB bytes, all completing on
// ``bar``.
template <int D, int R>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col0, int row0, int n) {
#pragma unroll
  for (int c = 0; c < Rows<D>::CHUNKS; ++c)
    tma_load_3d(dst + c * R * Rows<D>::ROWB, map, bar, col0 + c * 64, row0, n);
}

// k16 step kk of a K-major operand (rows along M or N, D contiguous K
// values each) whose first row is at ``p`` in a tile of R rows: four steps
// of 32 bytes a 128-byte chunk, then the next chunk.
template <int D, int R>
__device__ __forceinline__ uint64_t kdesc(const unsigned char* p, int kk) {
  constexpr int STEPS = Rows<D>::ROWB / 32;
  p += (kk / STEPS) * R * Rows<D>::ROWB + (kk % STEPS) * 32;
  return D >= 64 ? desc_sw128(p, 16, 1024) : desc_sw64(p, 16, 512);
}
// An MN-major operand (rows along K, D contiguous M or N values) from row
// ``p`` of a tile of R rows; a k16 step moves it 16 rows (16 ROWB bytes).
// At D >= 128 its 64-wide blocks along M or N are the tile's chunks, R 128
// bytes apart.
template <int D, int R>
__device__ __forceinline__ uint64_t ndesc(const unsigned char* p) {
  if constexpr (D >= 128) return desc_sw128(p, R * 128, 1024);
  return D == 64 ? desc_sw128(p, 8192, 1024) : desc_sw64(p, 4096, 512);
}

// A P or dS tile in shared memory for the transposed products (dV = P^T g,
// dK = dS^T q): 128 query rows by 128 keys in bf16, as two 64-key chunks
// of 128 rows x 128 bytes with the 128-byte swizzle, so that chunk c is
// the MN-major A operand of keys 64 c .. 64 c + 63. A 64-key tile is
// chunk 0 alone.
constexpr int PCHUNK = 128 * 128;  // bytes of a chunk
constexpr int PTILE = 2 * PCHUNK;

__device__ __forceinline__ uint64_t pdesc(const unsigned char* tile, int chunk, int kk) {
  return desc_sw128(tile + chunk * PCHUNK + kk * 2048, PCHUNK, 1024);
}

// d (64 x N) += or = a b, m64nNk16: both from shared memory (TA / TB: 1 for
// an MN-major operand) or A from registers (B MN-major).
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_d(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 128)
    wgmma_m64n128k16<TA, TB>(d, a, b, acc);
  else if constexpr (N == 64)
    wgmma_m64n64k16<TA, TB>(d, a, b, acc);
  else
    wgmma_m64n32k16<TA, TB>(d, a, b, acc);
}
template <int N>
__device__ __forceinline__ void mma_d_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  if constexpr (N == 256)
    wgmma_m64n256k16_rs<1>(d, a, b, acc);
  else if constexpr (N == 128)
    wgmma_m64n128k16_rs<1>(d, a, b, acc);
  else if constexpr (N == 64)
    wgmma_m64n64k16_rs<1>(d, a, b, acc);
  else
    wgmma_m64n32k16_rs<1>(d, a, b, acc);
}

// Issue s (64 rows of ``a``, from a tile of RA rows, by the NK = 2 R rows
// of the key tile ``b``) = a b^T, both K-major with D values a row, f32,
// unscaled; the caller commits and waits.
template <int D, int RA, int R>
__device__ __forceinline__ void issue_rows_by_keys(float (&s)[R], const unsigned char* a,
                                                   const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    if constexpr (R == 64)
      wgmma_m64n128k16<0, 0>(s, kdesc<D, RA>(a, kk), kdesc<D, 2 * R>(b, kk), kk > 0);
    else
      wgmma_m64n64k16<0, 0>(s, kdesc<D, RA>(a, kk), kdesc<D, 2 * R>(b, kk), kk > 0);
  }
}

// The masked f32 scores of the thread's elements of key tile t (NK = 2 R
// keys), as _mha_xla's: (acc * scale) + bias, then NEG_BIG above the
// diagonal (a select, after the bias), and -inf for keys past L, which then
// drop out of every max and sum. The thread's rows are queries qi0 and
// qi0 + 8, its columns 8 j + c0 and + 1 (hopper.cuh's accumulator layout).
template <bool CAUSAL, int R>
__device__ __forceinline__ void mask_scores(float (&s)[R], const float* __restrict__ brow,
                                            int t, int c0, int qi0, int L, float scale) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = t * 2 * R + 8 * j + c0 + (e & 1);
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
template <int R>
__device__ __forceinline__ float row_max(const float (&s)[R], int hf) {
  float m = neg_inf();
#pragma unroll
  for (int j = 0; j < R / 4; ++j) m = fmaxf(m, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
  return m;
}

// Whether a row of max m over its causal prefix gets exactly zero from
// the keys past it: exp(NEG_BIG - m) is 0 in f32. Not on a row whose
// prefix is all masked (m = NEG_BIG), which stays uniform over all L keys.
__device__ __forceinline__ bool future_is_zero(float m) {
  return expf(__int_as_float(NEG_BIG_BITS) - m) == 0.0f;
}

// s (the accumulator of 2 R keys) as the register A operands of the R / 8
// k16 steps of a product over those keys, in bf16 (hopper.cuh).
template <int R>
__device__ __forceinline__ void to_frags(const float (&s)[R], uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// The thread's elements of s (2 R keys) in bf16 into a P / dS tile (PTILE
// layout) at row ``row0`` (and row0 + 8) of the 128.
template <int R>
__device__ __forceinline__ void store_ptile(unsigned char* tile, const float (&s)[R], int row0,
                                            int lane) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + 8 * hf;
      unsigned char* p = tile + (j >> 3) * PCHUNK + row * 128 +
                         ((((j & 7) ^ (row & 7))) << 4) + 4 * (lane & 3);
      *reinterpret_cast<uint32_t*>(p) = pack_bf16(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]);
    }
  }
}

// The thread's elements of a (64 x NC) accumulator, times ``mul``, in bf16
// to rows row0 and row0 + 8 of columns [col0, col0 + NC) (rows < L only).
template <int NC>
__device__ __forceinline__ void store_block(__nv_bfloat16* __restrict__ out,
                                            const float (&o)[NC / 2], int n, int col0,
                                            int row0, int c0, int L, int H, float mul) {
#pragma unroll
  for (int jn = 0; jn < NC / 8; ++jn) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + 8 * hf;
      __nv_bfloat16* dst =
          out + (static_cast<size_t>(n) * L + (r < L ? r : 0)) * H + col0 + 8 * jn + c0;
      st_b32(dst, pack_bf16(o[4 * jn + 2 * hf] * mul, o[4 * jn + 2 * hf + 1] * mul), r < L);
    }
  }
}

// The same for a (64 x D) accumulator of head h.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out, const float (&o)[D / 2],
                                           int n, int h, int row0, int c0, int L, int H,
                                           float mul) {
  store_block<D>(out, o, n, h * D, row0, c0, L, H, mul);
}

}  // namespace attn
}  // namespace bft

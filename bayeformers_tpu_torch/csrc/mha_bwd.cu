// mha_bwd: multi-head self-attention backward in the flat (N, L, H) layout.
//
// Replaces bayeformers_tpu/ops/attention.py::_bwd_kernel (Pallas #5). Same
// arithmetic:
// recompute the f32 scores s = (q_h k_h^T) * scale + bias (scale = 1 /
// sqrt(D) rounded to f32, after the product) and their exact f32 softmax P;
// P goes to bf16 for dV = P^T g; dP = g v_h^T in f32; dS = P * (dP -
// rowsum(dP * P)) in f32, then bf16 for dQ = dS k_h * scale and dK = dS^T
// q_h * scale; every product accumulates in f32. q, k, v, g and the outputs
// are bf16 (N, L, H) with head h in columns [h*D, h*D+D) and are read by
// stride, as mha_fwd reads them; bias is (N, L) f32. The head width D is a
// template parameter, instantiated at 32 and 64.
//
// Bound on the H100: 10*N*L*L*H flops (five products) against 7*N*L*H*2
// bytes; at BERT's L = 128 the bytes bound it, so each operand should be read
// about once. Design: two passes, so that dK and dV, which sum over all
// query rows, need no atomics (the gradients are bit-reproducible).
//  1. A query-tile kernel (32 rows, one head, one example) forms the exact
//     softmax, D = rowsum(dP * P) from the f32 P (not the FlashAttention
//     identity rowsum(g * O), which would read the bf16 forward output),
//     dS, and dQ; it writes the row max, the row sum and D. Two designs:
//     whole rows (L <= 512) keep the score rows and dP rows in shared memory
//     (2 x 32 x 512 f32 at most, which is why the tile has 32 rows: 64 would
//     need 256 KB at L = 512); key-tiled (L > 512) walks the key tiles of 64
//     three times: the row max and sum (the sum rescaled by exp(m_old -
//     m_new) when a tile raises the max), then D from P = exp(s - m) / sum
//     and dP, then dS and dQ.
//  2. A key-tile kernel (64 keys) walks the query rows in tiles of 32,
//     recomputes the same scores and dP for its keys with the same
//     fragment products, rebuilds P = exp(s - max) / sum bit for bit from
//     pass 1's statistics, and accumulates dV and dK in registers. It takes
//     any L as it is.
// A fully masked row (bias finfo(f32).min everywhere) gives equal scores,
// hence a uniform P, as in the plain version; it stays finite.
//
// Causal instances (CAUSAL = true, GPT-2): both passes set score (i, j) with
// key j > query i to finfo(f32).min after the bias add, a select as the
// reference's jnp.where (attention.py:207-209). They must mask identically:
// pass 2 rebuilds P from pass 1's row max and sum, so a mask in one pass and
// not the other gives wrong dK/dV, not a crash; every walk goes through
// masked_score(). As in _bwd_kernel, a row with every key masked keeps its
// uniform P, and its dS reaches every key, future ones included (XLA's
// autodiff of _mha_xla would give those zero). No tile above the diagonal
// is skipped.
//
// Instances of one template over the operand type T: bf16 (above) and
// f32, where q, k, v, g and the outputs are f32 and all five products are
// true f32 (3xTF32, mma.cuh), as the reference's _bwd_kernel takes its dot
// operands in the stored dtype (bayeformers_tpu/ops/attention.py:188-193);
// the softmax, D and dS stay f32 in both. In f32 pass 1 writes dS over the
// dP rows instead of into a separate tile (element c reads dP[c], then
// writes dS[c]): at L = 512 it needs 163 KB, where a separate f32 dS tile
// would need 228 KB, just above the 227 KB a block can have. Pass 2 needs
// 85 KB in f32 (53 KB in bf16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

#include "mma.cuh"

using namespace nvcuda;
using bft::from_f32;

namespace {

constexpr int BQ = 32;        // query rows per tile (both passes)
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int MAX_ROWS_L = 512;  // longest L of pass 1's whole-row design
constexpr int TSLD = BKV + 4;    // f32 leading dim of a (rows, 64 keys) tile
constexpr unsigned NEG_BIG_BITS = 0xff7fffffu;  // finfo(f32).min = -FLT_MAX

// Tiles of q / k / v / g in T, leading dim padded by 16 bytes; in f32, dS
// over the dP rows.
template <typename T, int D>
struct Layout {
  static constexpr int QLD = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int OLD = D + 4;  // f32 leading dim of a (rows, D) output tile
  static constexpr int TPLD = BKV + 16 / static_cast<int>(sizeof(T));  // P, dS in T
  static constexpr int VEC = bft::Mma<T>::VEC;
  static constexpr bool DS_OVER_DP = sizeof(T) == 4;
  static constexpr size_t TILES1_BYTES = static_cast<size_t>(2 * BQ + BKV) * QLD * sizeof(T);
  static constexpr size_t SMEM2_BYTES =
      static_cast<size_t>(2 * BKV + 2 * BQ) * QLD * sizeof(T) + 2 * BQ * TSLD * 4 +
      2 * BQ * TPLD * sizeof(T) + 3 * BQ * 4;
  // pass 1's key-tiled design: q, g, k, v tiles, scores and dP of one key
  // tile, dS (bf16) over its own tile, the row max, sum and D
  static constexpr size_t TILED1_BYTES =
      static_cast<size_t>(2 * BQ + 2 * BKV) * QLD * sizeof(T) + 2 * BQ * TSLD * 4 +
      (DS_OVER_DP ? 0 : BQ * TPLD * sizeof(T)) + 3 * BQ * 4;
};

__host__ __device__ constexpr int round64(int l) { return (l + 63) / 64 * 64; }
__host__ __device__ constexpr int sld(int lk) { return lk + 4; }
__host__ __device__ constexpr int dld(int lk) { return lk + 8; }
template <typename T, int D>
__host__ __device__ constexpr size_t smem1_bytes(int lk) {
  return Layout<T, D>::TILES1_BYTES + 2 * static_cast<size_t>(BQ) * sld(lk) * 4 +
         (Layout<T, D>::DS_OVER_DP ? 0 : static_cast<size_t>(BQ) * dld(lk) * sizeof(T));
}

// Rows [row0, row0 + rows) of one head's (L, D) slice into a (rows, QLD)
// tile; rows >= L are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, T* dst,
                                          int n, int h, int row0, int rows,
                                          int L, int H) {
  constexpr int VEC = Layout<T, D>::VEC, CPR = D / VEC, QLD = Layout<T, D>::QLD;
  for (int q = threadIdx.x; q < rows * CPR; q += THREADS) {
    const int row = q / CPR, chunk = q % CPR;
    const int l = row0 + row;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (l < L)
      v = *reinterpret_cast<const uint4*>(
          src + (static_cast<size_t>(n) * L + l) * H + h * D + chunk * VEC);
    *reinterpret_cast<uint4*>(dst + row * QLD + chunk * VEC) = v;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (32 rows of a, 64 keys) = a_tile (32, D) @ kv_tile (64 keys, D)^T into
// f32 ``out`` (leading dim ld); warp w owns rows (w & 1) * 16 and keys
// (w >> 1) * 32 + {0, 16}. Both passes form the scores and dP this way, so
// an element's products and their order are the same in both.
template <typename T, int D>
__device__ __forceinline__ void rows_by_keys(const T* a_tile, const T* kv_tile,
                                             float* out, int ld) {
  constexpr int QLD = Layout<T, D>::QLD, KD = bft::Mma<T>::KDEPTH;
  const int warp = threadIdx.x >> 5, wr = warp & 1, wc = warp >> 1;
  bft::Acc<T> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D; kk += KD) {
    bft::Operand<T, wmma::matrix_a, wmma::row_major> a;
    a.load(a_tile + wr * 16 * QLD + kk, QLD);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // kv^T as a col-major (d, key) operand straight from the (key, d) tile
      bft::Operand<T, wmma::matrix_b, wmma::col_major> b;
      b.load(kv_tile + (wc * 32 + j * 16) * QLD + kk, QLD);
      bft::mma(acc[j], a, b);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(out + wr * 16 * ld + wc * 32 + j * 16, acc[j], ld,
                            wmma::mem_row_major);
}

// The masked f32 score of query row i and key j, the same in both passes.
template <bool CAUSAL>
__device__ __forceinline__ float masked_score(float acc, float scale, float bias, int i,
                                              int j) {
  const float s = __fadd_rn(__fmul_rn(acc, scale), bias);
  return (CAUSAL && j > i) ? __int_as_float(NEG_BIG_BITS) : s;
}

// Pass 1's dQ = dS k_h * scale: fragments of warp w (rows (w & 1) * 16,
// columns (w >> 1) * D / 2 + j * 16), dS a (32, 64 keys) tile with leading
// dim ld, k the staged (64 keys, D) tile.
template <typename T, int D>
__device__ __forceinline__ void dq_product(bft::Acc<T> (&o)[D / 32], const T* ds, int ld,
                                           const T* ks) {
  constexpr int QLD = Layout<T, D>::QLD, KD = bft::Mma<T>::KDEPTH;
  const int warp = threadIdx.x >> 5, wr = warp & 1, wc = warp >> 1;
#pragma unroll
  for (int kk = 0; kk < BKV; kk += KD) {
    bft::Operand<T, wmma::matrix_a, wmma::row_major> a;
    a.load(ds + wr * 16 * ld + kk, ld);
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      bft::Operand<T, wmma::matrix_b, wmma::row_major> b;
      b.load(ks + kk * QLD + wc * (D / 2) + j * 16, QLD);
      bft::mma(o[j], a, b);
    }
  }
}

// The (32, D) dQ tile: fragments to shared memory over ``os``, then rows < L
// times scale to dq.
template <typename T, int D>
__device__ __forceinline__ void store_dq(bft::Acc<T> (&o)[D / 32], float* os,
                                         T* __restrict__ dq, int n, int h, int q0, int L,
                                         int H, float scale) {
  constexpr int OLD = Layout<T, D>::OLD;
  const int warp = threadIdx.x >> 5, wr = warp & 1, wc = warp >> 1;
#pragma unroll
  for (int j = 0; j < D / 32; ++j)
    wmma::store_matrix_sync(os + wr * 16 * OLD + wc * (D / 2) + j * 16, o[j], OLD,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int row = i / D, col = i % D, l = q0 + row;
    if (l < L)
      dq[(static_cast<size_t>(n) * L + l) * H + h * D + col] =
          from_f32<T>(os[row * OLD + col] * scale);
  }
}

// Pass 1, whole rows (L <= 512): one block per (query tile, head, example).
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ bias,
                  const T* __restrict__ g, T* __restrict__ dq,
                  float* __restrict__ row_max, float* __restrict__ row_sum,
                  float* __restrict__ row_d, int L, int H, int n_heads, float scale) {
  constexpr int QLD = Layout<T, D>::QLD;
  constexpr bool DS_OVER_DP = Layout<T, D>::DS_OVER_DP;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lk = round64(L), SLD = sld(lk);
  const int DLD = DS_OVER_DP ? SLD : dld(lk);
  T* qs = reinterpret_cast<T*>(smem);
  T* gs = qs + BQ * QLD;
  T* kvs = gs + BQ * QLD;
  float* ss = reinterpret_cast<float*>(smem + Layout<T, D>::TILES1_BYTES);
  float* dps = ss + BQ * SLD;
  T* dsb = DS_OVER_DP ? reinterpret_cast<T*>(dps)
                      : reinterpret_cast<T*>(dps + BQ * SLD);
  float* os = ss;  // the dQ tile reuses the score rows once dS exists

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_rows<T, D>(q, qs, n, h, q0, BQ, L, H);
  load_rows<T, D>(g, gs, n, h, q0, BQ, L, H);
  for (int kb = 0; kb < lk; kb += BKV) {
    __syncthreads();
    load_rows<T, D>(k, kvs, n, h, kb, BKV, L, H);
    __syncthreads();
    rows_by_keys<T, D>(qs, kvs, ss + kb, SLD);
    __syncthreads();
    load_rows<T, D>(v, kvs, n, h, kb, BKV, L, H);
    __syncthreads();
    rows_by_keys<T, D>(gs, kvs, dps + kb, SLD);
  }
  __syncthreads();

  // softmax, D and dS in f32; each warp owns 8 rows
  const float* brow = bias + static_cast<size_t>(n) * L;
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    float* srow = ss + r * SLD;
    const float* drow = dps + r * SLD;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int c = lane; c < L; c += 32) {
      const float s = masked_score<CAUSAL>(srow[c], scale, brow[c], q0 + r, c);
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int c = lane; c < L; c += 32) {
      const float e = expf(srow[c] - mx);
      srow[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float dsum = 0.0f;
    for (int c = lane; c < L; c += 32) {
      const float p = srow[c] / sum;
      srow[c] = p;
      dsum += drow[c] * p;
    }
    dsum = warp_sum(dsum);
    T* dsrow = dsb + r * DLD;  // over drow itself in f32: element c reads, then writes c
    for (int c = lane; c < lk; c += 32)
      dsrow[c] = from_f32<T>(c < L ? srow[c] * (drow[c] - dsum) : 0.0f);
    if (lane == 0 && q0 + r < L) {
      const size_t i = (static_cast<size_t>(n) * n_heads + h) * L + q0 + r;
      row_max[i] = mx;
      row_sum[i] = sum;
      row_d[i] = dsum;
    }
  }

  bft::Acc<T> o[D / 32];
#pragma unroll
  for (int j = 0; j < D / 32; ++j) wmma::fill_fragment(o[j], 0.0f);
  for (int kb = 0; kb < lk; kb += BKV) {
    __syncthreads();
    load_rows<T, D>(k, kvs, n, h, kb, BKV, L, H);
    __syncthreads();
    dq_product<T, D>(o, dsb + kb, DLD, kvs);
  }
  __syncthreads();
  store_dq<T, D>(o, os, dq, n, h, q0, L, H, scale);
}

// Pass 1, key-tiled (L > 512): the same statistics, D, dS and dQ, walked one
// key tile of 64 at a time (three walks).
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
mha_bwd_dq_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const T* __restrict__ g, T* __restrict__ dq,
                        float* __restrict__ row_max, float* __restrict__ row_sum,
                        float* __restrict__ row_d, int L, int H, int n_heads,
                        float scale) {
  using Lay = Layout<T, D>;
  constexpr int QLD = Lay::QLD;
  constexpr int DLD = Lay::DS_OVER_DP ? TSLD : Lay::TPLD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* gs = qs + BQ * QLD;
  T* ks = gs + BQ * QLD;
  T* vs = ks + BKV * QLD;
  float* ss = reinterpret_cast<float*>(vs + BKV * QLD);  // one key tile's scores
  float* dps = ss + BQ * TSLD;                             // and its dP
  T* dsb = Lay::DS_OVER_DP ? reinterpret_cast<T*>(dps)
                           : reinterpret_cast<T*>(dps + BQ * TSLD);
  float* st = reinterpret_cast<float*>(smem + Lay::TILED1_BYTES) - 3 * BQ;
  float* os = ss;  // the dQ tile reuses the score tile at the end

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* brow = bias + static_cast<size_t>(n) * L;

  load_rows<T, D>(q, qs, n, h, q0, BQ, L, H);
  load_rows<T, D>(g, gs, n, h, q0, BQ, L, H);
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    st[i] = __int_as_float(0xff800000);  // the row max, -inf
    st[BQ + i] = 0.0f;                   // the row sum of exp(s - max)
    st[2 * BQ + i] = 0.0f;               // D = rowsum(dP * P)
  }

  // the masked f32 score of row r and tile column u's key (lane + 32 u)
  auto score = [&](int r, int kb, int u) {
    const int c = lane + 32 * u;
    return masked_score<CAUSAL>(ss[r * TSLD + c], scale, brow[kb + c], q0 + r, kb + c);
  };

  // walk 1: the row max and sum
  for (int kb = 0; kb < L; kb += BKV) {
    __syncthreads();
    load_rows<T, D>(k, ks, n, h, kb, BKV, L, H);
    __syncthreads();
    rows_by_keys<T, D>(qs, ks, ss, TSLD);
    __syncthreads();
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      float s[2], mx = __int_as_float(0xff800000);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        s[u] = kb + lane + 32 * u < L ? score(r, kb, u) : __int_as_float(0xff800000);
        mx = fmaxf(mx, s[u]);
      }
      mx = warp_max(mx);
      const float m_old = st[r], m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (kb + lane + 32 * u < L) sum += expf(s[u] - m_new);
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        st[BQ + r] = st[BQ + r] * expf(m_old - m_new) + sum;
        st[r] = m_new;
      }
      __syncwarp();
    }
  }

  // walks 2 and 3: D from P and dP, then dS and dQ
  bft::Acc<T> o[D / 32];
#pragma unroll
  for (int j = 0; j < D / 32; ++j) wmma::fill_fragment(o[j], 0.0f);
  for (int walk = 2; walk <= 3; ++walk) {
    for (int kb = 0; kb < L; kb += BKV) {
      __syncthreads();
      load_rows<T, D>(k, ks, n, h, kb, BKV, L, H);
      load_rows<T, D>(v, vs, n, h, kb, BKV, L, H);
      __syncthreads();
      rows_by_keys<T, D>(qs, ks, ss, TSLD);
      rows_by_keys<T, D>(gs, vs, dps, TSLD);
      __syncthreads();
      for (int r = warp * 8; r < warp * 8 + 8; ++r) {
        const float m = st[r], l = st[BQ + r], dsum = st[2 * BQ + r];
        float part = 0.0f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = lane + 32 * u;
          const bool live = kb + c < L;
          const float p = live ? expf(score(r, kb, u) - m) / l : 0.0f;
          const float dp = dps[r * TSLD + c];
          if (walk == 2)
            part += live ? dp * p : 0.0f;
          else  // over dps itself in f32: element c reads, then writes c
            dsb[r * DLD + c] = from_f32<T>(live ? p * (dp - dsum) : 0.0f);
        }
        if (walk == 2) {
          part = warp_sum(part);
          __syncwarp();
          if (lane == 0) st[2 * BQ + r] += part;
          __syncwarp();
        }
      }
      if (walk == 3) {
        __syncthreads();
        dq_product<T, D>(o, dsb, DLD, ks);
      }
    }
  }
  for (int r = warp * 8; r < warp * 8 + 8; ++r)
    if (lane == 0 && q0 + r < L) {
      const size_t i = (static_cast<size_t>(n) * n_heads + h) * L + q0 + r;
      row_max[i] = st[r];
      row_sum[i] = st[BQ + r];
      row_d[i] = st[2 * BQ + r];
    }
  __syncthreads();
  store_dq<T, D>(o, os, dq, n, h, q0, L, H, scale);
}

// Pass 2: one block per (key tile, head, example).
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
mha_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   const T* __restrict__ g, const float* __restrict__ row_max,
                   const float* __restrict__ row_sum,
                   const float* __restrict__ row_d, T* __restrict__ dk,
                   T* __restrict__ dv, int L, int H, int n_heads, float scale) {
  constexpr int QLD = Layout<T, D>::QLD, OLD = Layout<T, D>::OLD;
  constexpr int PLD = Layout<T, D>::TPLD, KD = bft::Mma<T>::KDEPTH;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + BKV * QLD;
  T* qs = vs + BKV * QLD;
  T* gs = qs + BQ * QLD;
  float* ss = reinterpret_cast<float*>(gs + BQ * QLD);
  float* dps = ss + BQ * TSLD;
  T* pb = reinterpret_cast<T*>(dps + BQ * TSLD);
  T* dsb = pb + BQ * PLD;
  float* st = reinterpret_cast<float*>(dsb + BQ * PLD);  // max, sum, D
  float* os = ss;  // (64 keys, OLD) output tile over ss and dps at the end

  const int key0 = blockIdx.x * BKV, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const size_t stat0 = (static_cast<size_t>(n) * n_heads + h) * L;
  const float* brow = bias + static_cast<size_t>(n) * L;

  load_rows<T, D>(k, ks, n, h, key0, BKV, L, H);
  load_rows<T, D>(v, vs, n, h, key0, BKV, L, H);
  // warp w owns keys [w * 16, w * 16 + 16) of dV and dK, all D columns
  bft::Acc<T> dva[D / 16], dka[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dva[j], 0.0f);
    wmma::fill_fragment(dka[j], 0.0f);
  }

  for (int qb = 0; qb < L; qb += BQ) {
    __syncthreads();
    load_rows<T, D>(q, qs, n, h, qb, BQ, L, H);
    load_rows<T, D>(g, gs, n, h, qb, BQ, L, H);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const bool ok = qb + i < L;
      st[i] = ok ? row_max[stat0 + qb + i] : 0.0f;
      st[BQ + i] = ok ? row_sum[stat0 + qb + i] : 1.0f;
      st[2 * BQ + i] = ok ? row_d[stat0 + qb + i] : 0.0f;
    }
    __syncthreads();
    rows_by_keys<T, D>(qs, ks, ss, TSLD);
    rows_by_keys<T, D>(gs, vs, dps, TSLD);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BKV; i += THREADS) {
      const int r = i / BKV, c = i % BKV;
      float p = 0.0f, ds = 0.0f;
      if (qb + r < L && key0 + c < L) {
        const float s = masked_score<CAUSAL>(ss[r * TSLD + c], scale, brow[key0 + c],
                                             qb + r, key0 + c);
        p = expf(s - st[r]) / st[BQ + r];
        ds = p * (dps[r * TSLD + c] - st[2 * BQ + r]);
      }
      pb[r * PLD + c] = from_f32<T>(p);
      dsb[r * PLD + c] = from_f32<T>(ds);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BQ; kk += KD) {
      // P^T and dS^T as col-major (key, query) operands from (query, key) tiles
      bft::Operand<T, wmma::matrix_a, wmma::col_major> ap, ads;
      ap.load(pb + kk * PLD + warp * 16, PLD);
      ads.load(dsb + kk * PLD + warp * 16, PLD);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        bft::Operand<T, wmma::matrix_b, wmma::row_major> bg, bq;
        bg.load(gs + kk * QLD + j * 16, QLD);
        bq.load(qs + kk * QLD + j * 16, QLD);
        bft::mma(dva[j], ap, bg);
        bft::mma(dka[j], ads, bq);
      }
    }
  }

  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      wmma::store_matrix_sync(os + warp * 16 * OLD + j * 16,
                              pass ? dka[j] : dva[j], OLD, wmma::mem_row_major);
    __syncthreads();
    T* out = pass ? dk : dv;
    const float mul = pass ? scale : 1.0f;
    for (int i = threadIdx.x; i < BKV * D; i += THREADS) {
      const int row = i / D, col = i % D, l = key0 + row;
      if (l < L)
        out[(static_cast<size_t>(n) * L + l) * H + h * D + col] =
            from_f32<T>(os[row * OLD + col] * mul);
    }
  }
}

template <typename T, int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* g, void* dq, void* dk, void* dv, void* stats, int N,
           int L, int H, int n_heads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tiled = L > MAX_ROWS_L;
  const size_t smem1 = tiled ? Layout<T, D>::TILED1_BYTES : smem1_bytes<T, D>(round64(L));
  constexpr size_t smem2 = Layout<T, D>::SMEM2_BYTES;
  auto pass1 = tiled ? mha_bwd_dq_tiled_kernel<T, D, CAUSAL> : mha_bwd_dq_kernel<T, D, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mha_bwd_dkv_kernel<T, D, CAUSAL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 1 / sqrt(D) rounded to f32, as the plain version's Python float
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const size_t nhl = static_cast<size_t>(N) * n_heads * L;
  float* m = static_cast<float*>(stats);
  const auto* qb = static_cast<const T*>(q);
  const auto* kb = static_cast<const T*>(k);
  const auto* vb = static_cast<const T*>(v);
  const auto* gb = static_cast<const T*>(g);
  const auto* bb = static_cast<const float*>(bias);
  pass1<<<dim3((L + BQ - 1) / BQ, n_heads, N), THREADS, smem1, st>>>(
      qb, kb, vb, bb, gb, static_cast<T*>(dq), m, m + nhl, m + 2 * nhl, L, H, n_heads,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_dkv_kernel<T, D, CAUSAL><<<dim3((L + BKV - 1) / BKV, n_heads, N), THREADS,
                                     smem2, st>>>(
      qb, kb, vb, bb, gb, m, m + nhl, m + 2 * nhl, static_cast<T*>(dk),
      static_cast<T*>(dv), L, H, n_heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(const void* q, const void* k, const void* v, const void* bias, const void* g,
             void* dq, void* dk, void* dv, void* stats, int N, int L, int H, int n_heads,
             int f32, int causal, void* stream) {
  if (f32)
    return causal ? launch<float, D, true>(q, k, v, bias, g, dq, dk, dv, stats, N, L, H,
                                           n_heads, stream)
                  : launch<float, D, false>(q, k, v, bias, g, dq, dk, dv, stats, N, L, H,
                                            n_heads, stream);
  return causal ? launch<__nv_bfloat16, D, true>(q, k, v, bias, g, dq, dk, dv, stats, N,
                                                 L, H, n_heads, stream)
                : launch<__nv_bfloat16, D, false>(q, k, v, bias, g, dq, dk, dv, stats, N,
                                                  L, H, n_heads, stream);
}

}  // namespace

// q / k / v / g / dq / dk / dv (N, L, H) bf16 (f32 = 0) or f32 (f32 = 1),
// bias (N, L) f32, stats (3, N, n_heads, L) f32 scratch, causal masking when
// causal = 1; H = n_heads * D with D = 32 or 64; L <= 512 takes pass 1's
// whole-row design, longer L its key-tiled one. Returns cudaGetLastError().
extern "C" int bft_mha_bwd(const void* q, const void* k, const void* v,
                           const void* bias, const void* g, void* dq, void* dk,
                           void* dv, void* stats, int N, int L, int H,
                           int n_heads, int f32, int causal, void* stream) {
  if (N < 1 || L < 1 || n_heads < 1 || H % n_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (H / n_heads) {
    case 32:
      return dispatch<32>(q, k, v, bias, g, dq, dk, dv, stats, N, L, H, n_heads, f32,
                          causal, stream);
    case 64:
      return dispatch<64>(q, k, v, bias, g, dq, dk, dv, stats, N, L, H, n_heads, f32,
                          causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

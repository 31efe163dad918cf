// mha_bwd: multi-head self-attention backward in the flat (N, L, H) layout.
//
// Replaces bayeformers_tpu/ops/attention.py::_bwd_kernel (Pallas #5). Same
// arithmetic: recompute the f32 scores s = (q_h k_h^T) * scale + bias
// (scale = 1 / sqrt(D) rounded to f32, after the product) and their exact
// f32 softmax P; P goes to bf16 for dV = P^T g; dP = g v_h^T in f32; dS =
// P * (dP - D) with D = rowsum(dP * P) from the f32 P (not the
// FlashAttention identity rowsum(g * O), which would read the bf16 forward
// output), in f32, then bf16 for dQ = dS k_h * scale and dK = dS^T q_h *
// scale; every product accumulates in f32. q, k, v, g and the outputs are
// bf16 (N, L, H) with head h in columns [h*D, h*D+D); bias is (N, L) f32.
// The head width D is a template parameter, instantiated at 32, 64, 128 and
// 256.
// Causal instances (CAUSAL = true) set score (i, j) with key j > query i to
// finfo(f32).min after the bias add, a select as the reference's
// jnp.where (attention.py:207-209); as in _bwd_kernel, a row with every key
// masked keeps its uniform P, and its dS reaches every key, future ones
// included (XLA's autodiff of _mha_xla would give those zero). dK and dV
// sum over the query rows in a fixed order, with no atomics: reruns are
// bit-equal.
//
// Bound on the H100: 10*N*L*L*H flops (five products) against 7*N*L*H*2
// bytes; at BERT's L = 128 the bytes bound it, so each operand should be
// read about once.
//
// bf16 (namespace wg): TMA loads through 3-D maps over (N, L, H)
// (attention.cuh), products on wgmma, the softmax in registers.
//  * L <= 128 (the main path; mha_bwd_rows): one block per (head,
//    example). A producer warp loads q, k, v and g (4 x 128 x D bf16, 64 KB
//    at D = 64); each of two consumer warpgroups owns 64 query rows and
//    forms in registers S = q k^T and dP = g v^T (m64n128k16), the exact f32
//    P, D and dS, then dQ = dS k * scale with dS as the register A operand;
//    it writes P and dS in bf16 to shared memory (64 KB), and after a
//    barrier each warpgroup forms dV = P^T g and dK = dS^T q * scale for
//    its own 64 keys over all query rows, reading P, dS, g and q through
//    wgmma's transpose bits. Five products, where the two-pass design
//    needs seven. At L = 256 the tiles and P / dS would need 384 KB.
//  * L > 128: two passes, each block with two consumer warpgroups and a
//    producer warpgroup that hands its registers to them. Pass 1
//    (mha_bwd_dq_wg, 128 query rows, 64 a warpgroup) walks the key tiles
//    of 128 twice: walk 1 forms S and dP and carries the row max m, the
//    row sum l of exp(s - m) and dd, the sum of exp(s - m) dP (both
//    rescaled by exp(m_old - m_new) when a tile raises the max), so that D
//    = dd / l; walk 2 forms S and dP again, P = exp(s - m) / l, dS and dQ +=
//    dS k. It writes m, l and D of every row and whether the block's causal
//    skip held. Pass 2 (mha_bwd_dkv_wg, a key tile of 128) walks the query
//    rows in steps of 128 (TMA ring of 2), forms S and dP of its keys with
//    the same products, rebuilds P bit for bit from pass 1's statistics,
//    writes P and dS in bf16 to shared memory and accumulates dV and dK as
//    in the L <= 128 design.
// The causal skip, as in the forward (mha.cu): pass 1 walks its 128 rows'
// causal prefix first and skips the key tiles wholly above their diagonal
// when exp(NEG_BIG - m) is 0.0f on every row (those keys' P and dS are then
// exactly zero); pass 2 skips a step of query rows wholly before its key
// tile when pass 1 skipped for those rows. Rows holding one whose whole
// prefix is masked are walked in full.
// Wide heads (D = 128, 256; tiles as 64-column boxes, attention.cuh): D =
// 128 keeps the one-pass design up to L = 128 (q, k, v, g and P, dS: 192
// KB) and pass 1; D = 256, whose four tiles would take 256 KB, takes the
// two passes at every L, pass 1 with key tiles of 64 and one stage (q and
// g take 128 KB; dQ, 128 registers a thread, leaves room for the scores
// of 64 keys only). Pass 2 at both widths is mha_bwd_dkv_split: dV and dK
// of a warpgroup's 64 keys at all D columns would need 256 registers or
// more a thread, so a block takes 64 keys and its two warpgroups split
// the D columns of dV and dK between them.
//
// f32: q, k, v, g and the outputs f32, all five products true f32 (3xTF32
// on WMMA, mma.cuh), as the reference's _bwd_kernel takes its dot operands
// in the stored dtype (bayeformers_tpu/ops/attention.py:188-193); the
// softmax, D and dS in f32. TF32 wgmma takes only K-major operands from
// shared memory and dV = P^T g needs them MN-major; the f32 instances keep
// their design: two passes with query tiles of 32 rows. Pass 1 forms the
// statistics, D, dS and dQ, with whole rows (L <= 512: score and dP rows
// in shared memory, dS written over the dP rows, 163 KB at L = 512; L <=
// 256 at D = 256) or key tiles of 64 walked three times; pass 2 (a key
// tile of 64; at D = 256 two blocks a tile, each with half of the columns,
// P and dS written over the scores and dP) rebuilds P from pass 1's
// statistics and accumulates dV and dK. They skip no tile. At D >= 128 the
// products sum in steps of fresh fragments added by FADD (mma.cuh's
// add_into): one chain in the tensor cores' accumulator over D = 256 or
// all L drifted by 1e-5 of its sums on the H100.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

#include "attention.cuh"
#include "mma.cuh"

using namespace nvcuda;
using bft::from_f32;

namespace {

constexpr int BQ = 32;        // query rows per tile (both passes)
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 128;  // 4 warps
// The longest L of pass 1's whole-row design: 512, or 256 at D = 256, whose
// q, g and k tiles (128 x 260 f32) leave room for rows of 256 keys only.
template <int D>
__host__ __device__ constexpr int max_rows_len() {
  return D >= 256 ? 256 : 512;
}
// Pass 2's blocks a key tile: 2 at D = 256, each with half of the D
// columns of dV and dK, so that a warp's accumulators (2 x 8 fragments of
// 16 x 16 f32) stay in registers; 1 below.
template <int D>
__host__ __device__ constexpr int col_splits() {
  return D >= 256 ? 2 : 1;
}
constexpr int TSLD = BKV + 4;    // f32 leading dim of a (rows, 64 keys) tile
constexpr unsigned NEG_BIG_BITS = 0xff7fffffu;  // finfo(f32).min = -FLT_MAX

// Tiles of q / k / v / g in T (f32, the only instance of these templates),
// leading dim padded by 16 bytes; pass 1's dS over its dP rows.
template <typename T, int D>
struct Layout {
  static constexpr int QLD = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int OLD = D + 4;  // f32 leading dim of a (rows, D) output tile
  static constexpr int TPLD = BKV + 16 / static_cast<int>(sizeof(T));  // P, dS in T
  static constexpr int VEC = bft::Mma<T>::VEC;
  static constexpr size_t TILES1_BYTES = static_cast<size_t>(2 * BQ + BKV) * QLD * sizeof(T);
  // pass 2's P and dS written over its score and dP tiles at D = 256 (each
  // thread reads an element's s and dP, then writes its P and dS there), so
  // that the tiles fit in shared memory
  static constexpr bool PS_OVER = D >= 256;
  static_assert(!PS_OVER || (sizeof(T) == 4 && TPLD == TSLD), "P over the scores");
  static constexpr size_t SMEM2_BYTES =
      static_cast<size_t>(2 * BKV + 2 * BQ) * QLD * sizeof(T) + 2 * BQ * TSLD * 4 +
      (PS_OVER ? 0 : 2 * BQ * TPLD * sizeof(T)) + 3 * BQ * 4;
  // pass 1's key-tiled design: q, g, k, v tiles, scores and dP of one key
  // tile (dS over the dP), the row max, sum and D
  static constexpr size_t TILED1_BYTES =
      static_cast<size_t>(2 * BQ + 2 * BKV) * QLD * sizeof(T) + 2 * BQ * TSLD * 4 +
      3 * BQ * 4;
};

__host__ __device__ constexpr int round64(int l) { return (l + 63) / 64 * 64; }
__host__ __device__ constexpr int sld(int lk) { return lk + 4; }
template <typename T, int D>
__host__ __device__ constexpr size_t smem1_bytes(int lk) {
  return Layout<T, D>::TILES1_BYTES + 2 * static_cast<size_t>(BQ) * sld(lk) * 4;
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
// an element's products and their order are the same in both. At D >= 128
// each 32-deep step starts a fresh fragment, added by FADD (mha.cu's
// warp_scores); the instances at 32 and 64 keep their one chain.
template <typename T, int D>
__device__ __forceinline__ void rows_by_keys(const T* a_tile, const T* kv_tile,
                                             float* out, int ld) {
  constexpr int QLD = Layout<T, D>::QLD, KD = bft::Mma<T>::KDEPTH;
  constexpr int STEP = D >= 128 ? 32 : D;  // the depth of one accumulator chain
  const int warp = threadIdx.x >> 5, wr = warp & 1, wc = warp >> 1;
  bft::Acc<T> acc[2], part[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += STEP) {
    bft::Acc<T>(&chain)[2] = STEP < D ? part : acc;
    if (STEP < D) {
      wmma::fill_fragment(part[0], 0.0f);
      wmma::fill_fragment(part[1], 0.0f);
    }
#pragma unroll
    for (int kk = k0; kk < k0 + STEP; kk += KD) {
      bft::Operand<T, wmma::matrix_a, wmma::row_major> a;
      a.load(a_tile + wr * 16 * QLD + kk, QLD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // kv^T as a col-major (d, key) operand straight from the (key, d) tile
        bft::Operand<T, wmma::matrix_b, wmma::col_major> b;
        b.load(kv_tile + (wc * 32 + j * 16) * QLD + kk, QLD);
        bft::mma(chain[j], a, b);
      }
    }
    if (STEP < D) {
      bft::add_into(acc[0], part[0]);
      bft::add_into(acc[1], part[1]);
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
// dim ld, k the staged (64 keys, D) tile. At D >= 128 the tile's products
// go into a fresh fragment that is added to dQ by FADD (the instances at 32
// and 64 carry one chain over all L).
template <typename T, int D>
__device__ __forceinline__ void dq_product(bft::Acc<T> (&o)[D / 32], const T* ds, int ld,
                                           const T* ks) {
  constexpr int QLD = Layout<T, D>::QLD, KD = bft::Mma<T>::KDEPTH;
  constexpr bool FRESH = D >= 128;
  const int warp = threadIdx.x >> 5, wr = warp & 1, wc = warp >> 1;
  bft::Acc<T> part[FRESH ? D / 32 : 1];
  if (FRESH) {
#pragma unroll
    for (int j = 0; j < D / 32; ++j) wmma::fill_fragment(part[FRESH ? j : 0], 0.0f);
  }
#pragma unroll
  for (int kk = 0; kk < BKV; kk += KD) {
    bft::Operand<T, wmma::matrix_a, wmma::row_major> a;
    a.load(ds + wr * 16 * ld + kk, ld);
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      bft::Operand<T, wmma::matrix_b, wmma::row_major> b;
      b.load(ks + kk * QLD + wc * (D / 2) + j * 16, QLD);
      bft::mma(FRESH ? part[FRESH ? j : 0] : o[j], a, b);
    }
  }
  if (FRESH) {
#pragma unroll
    for (int j = 0; j < D / 32; ++j) bft::add_into(o[j], part[FRESH ? j : 0]);
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
  extern __shared__ __align__(128) unsigned char smem[];
  const int lk = round64(L), SLD = sld(lk);
  const int DLD = SLD;
  T* qs = reinterpret_cast<T*>(smem);
  T* gs = qs + BQ * QLD;
  T* kvs = gs + BQ * QLD;
  float* ss = reinterpret_cast<float*>(smem + Layout<T, D>::TILES1_BYTES);
  float* dps = ss + BQ * SLD;
  T* dsb = reinterpret_cast<T*>(dps);  // dS over the dP rows
  // the dQ tile reuses the score rows once dS exists (D >= 128: the tiles')
  float* os = D >= 128 ? reinterpret_cast<float*>(smem) : ss;

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
  constexpr int DLD = TSLD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* gs = qs + BQ * QLD;
  T* ks = gs + BQ * QLD;
  T* vs = ks + BKV * QLD;
  float* ss = reinterpret_cast<float*>(vs + BKV * QLD);  // one key tile's scores
  float* dps = ss + BQ * TSLD;                             // and its dP
  T* dsb = reinterpret_cast<T*>(dps);  // dS over the dP tile
  float* st = reinterpret_cast<float*>(smem + Lay::TILED1_BYTES) - 3 * BQ;
  // the dQ tile reuses the score tile at the end (D >= 128: the tiles')
  float* os = D >= 128 ? reinterpret_cast<float*>(smem) : ss;

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

// Pass 2: one block per (key tile, head, example), and per column half of
// dV and dK at D = 256 (col_splits).
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
  constexpr bool PS_OVER = Layout<T, D>::PS_OVER;
  constexpr int CS = col_splits<D>(), DC = D / CS;  // the block's columns
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + BKV * QLD;
  T* qs = vs + BKV * QLD;
  T* gs = qs + BQ * QLD;
  float* ss = reinterpret_cast<float*>(gs + BQ * QLD);
  float* dps = ss + BQ * TSLD;
  T* pb = PS_OVER ? reinterpret_cast<T*>(ss) : reinterpret_cast<T*>(dps + BQ * TSLD);
  T* dsb = PS_OVER ? reinterpret_cast<T*>(dps) : pb + BQ * PLD;
  float* st = PS_OVER ? dps + BQ * TSLD : reinterpret_cast<float*>(dsb + BQ * PLD);  // max, sum, D
  // the (64 keys, OLD) output tile over ss and dps at the end (D >= 128:
  // over the k and v tiles)
  float* os = D >= 128 ? reinterpret_cast<float*>(smem) : ss;

  const int key0 = blockIdx.x / CS * BKV, col0 = blockIdx.x % CS * DC;
  const int h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const size_t stat0 = (static_cast<size_t>(n) * n_heads + h) * L;
  const float* brow = bias + static_cast<size_t>(n) * L;

  load_rows<T, D>(k, ks, n, h, key0, BKV, L, H);
  load_rows<T, D>(v, vs, n, h, key0, BKV, L, H);
  // warp w owns keys [w * 16, w * 16 + 16) of dV and dK, the block's DC
  // columns
  bft::Acc<T> dva[DC / 16], dka[DC / 16];
#pragma unroll
  for (int j = 0; j < DC / 16; ++j) {
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
    // at D >= 128 the step's products go into fresh fragments that are
    // added to dV and dK by FADD (the instances at 32 and 64 carry one
    // chain over all L)
    constexpr bool FRESH = D >= 128;
    bft::Acc<T> pv[FRESH ? DC / 16 : 1], pk[FRESH ? DC / 16 : 1];
    if (FRESH) {
#pragma unroll
      for (int j = 0; j < DC / 16; ++j) {
        wmma::fill_fragment(pv[FRESH ? j : 0], 0.0f);
        wmma::fill_fragment(pk[FRESH ? j : 0], 0.0f);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BQ; kk += KD) {
      // P^T and dS^T as col-major (key, query) operands from (query, key) tiles
      bft::Operand<T, wmma::matrix_a, wmma::col_major> ap, ads;
      ap.load(pb + kk * PLD + warp * 16, PLD);
      ads.load(dsb + kk * PLD + warp * 16, PLD);
#pragma unroll
      for (int j = 0; j < DC / 16; ++j) {
        bft::Operand<T, wmma::matrix_b, wmma::row_major> bg, bq;
        bg.load(gs + kk * QLD + col0 + j * 16, QLD);
        bq.load(qs + kk * QLD + col0 + j * 16, QLD);
        bft::mma(FRESH ? pv[FRESH ? j : 0] : dva[j], ap, bg);
        bft::mma(FRESH ? pk[FRESH ? j : 0] : dka[j], ads, bq);
      }
    }
    if (FRESH) {
#pragma unroll
      for (int j = 0; j < DC / 16; ++j) {
        bft::add_into(dva[j], pv[FRESH ? j : 0]);
        bft::add_into(dka[j], pk[FRESH ? j : 0]);
      }
    }
  }

  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < DC / 16; ++j)
      wmma::store_matrix_sync(os + warp * 16 * OLD + j * 16,
                              pass ? dka[j] : dva[j], OLD, wmma::mem_row_major);
    __syncthreads();
    T* out = pass ? dk : dv;
    const float mul = pass ? scale : 1.0f;
    for (int i = threadIdx.x; i < BKV * DC; i += THREADS) {
      const int row = i / DC, col = i % DC, l = key0 + row;
      if (l < L)
        out[(static_cast<size_t>(n) * L + l) * H + h * D + col0 + col] =
            from_f32<T>(os[row * OLD + col] * mul);
    }
  }
}

template <typename T, int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* g, void* dq, void* dk, void* dv, void* stats, int N,
           int L, int H, int n_heads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tiled = L > max_rows_len<D>();
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
  mha_bwd_dkv_kernel<T, D, CAUSAL><<<dim3((L + BKV - 1) / BKV * col_splits<D>(), n_heads,
                                          N),
                                     THREADS, smem2, st>>>(
      qb, kb, vb, bb, gb, m, m + nhl, m + 2 * nhl, static_cast<T*>(dk),
      static_cast<T*>(dv), L, H, n_heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16 ----
namespace wg {

using bf16 = __nv_bfloat16;
using namespace bft::sm90;
using namespace bft::attn;

constexpr int TWO_WG = 256;             // two consumer warpgroups
constexpr int THREADS2 = TWO_WG + 128;  // and a producer warpgroup, which
                                        // hands its registers to them
constexpr int STAGES = 2;

// Issue dq += dS k over the tile's 16 K16 keys, dS from registers, k the
// (16 K16 keys, D) tile MN-major.
template <int D, int K16>
__device__ __forceinline__ void issue_ds_k(float (&dq)[D / 2], const uint32_t (&a)[K16][4],
                                           const unsigned char* ks) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk)
    mma_d_rs<D>(dq, a[kk], ndesc<D, 16 * K16>(ks + kk * 16 * Rows<D>::ROWB), 1);
}

// Issue dv += P^T g and dk += dS^T q over 128 query rows for the keys of
// chunk ``c`` of the P and dS tiles; g and q (128 rows, D) MN-major.
template <int D>
__device__ __forceinline__ void issue_dkv(float (&dv)[D / 2], float (&dk)[D / 2],
                                          const unsigned char* ps, const unsigned char* dss,
                                          const unsigned char* gs, const unsigned char* qs,
                                          int c) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    mma_d<D, 1, 1>(dv, pdesc(ps, c, kk), ndesc<D, BN>(gs + kk * 16 * Rows<D>::ROWB), 1);
    mma_d<D, 1, 1>(dk, pdesc(dss, c, kk), ndesc<D, BN>(qs + kk * 16 * Rows<D>::ROWB), 1);
  }
}

// S = q k^T and dP = g v^T for the warpgroup's 64 rows of q and g (in
// tiles of 128 rows) and the 2 R keys of k and v: issued together, then
// waited for.
template <int D, int R>
__device__ __forceinline__ void scores_and_dp(float (&s)[R], float (&dp)[R],
                                              const unsigned char* q, const unsigned char* g,
                                              const unsigned char* k, const unsigned char* v) {
  fence_acc(s);
  fence_acc(dp);
  wgmma_fence();
  issue_rows_by_keys<D, BN>(s, q, k);
  issue_rows_by_keys<D, BN>(dp, g, v);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(s);
  fence_acc(dp);
}

// ---- L <= 128: one block per (head, example) ----
template <int D>
struct RowsSmem {
  static constexpr int T = Rows<D>::R128;  // q, k, v, g: 128 rows each
  static constexpr int BYTES = 1024 + 4 * T + 2 * PTILE + 64;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS2, 1)
mha_bwd_rows(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_g,
                const float* __restrict__ bias, bf16* __restrict__ dq, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int L, int H, float scale) {
  using S = RowsSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;
  unsigned char* ks = qs + S::T;
  unsigned char* vs = ks + S::T;
  unsigned char* gs = vs + S::T;
  unsigned char* ps = gs + S::T;  // P, then dS, in bf16 (PTILE layout)
  unsigned char* dss = ps + PTILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(dss + PTILE);
  const int h = blockIdx.x, n = blockIdx.y;
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= TWO_WG) {
    setmaxnreg_dec<40>();
    if (threadIdx.x != TWO_WG) return;
    mbar_expect_tx(full, 4 * S::T);
    tma_tile<D, BN>(qs, &map_q, full, h * D, 0, n);
    tma_tile<D, BN>(ks, &map_k, full, h * D, 0, n);
    tma_tile<D, BN>(vs, &map_v, full, h * D, 0, n);
    tma_tile<D, BN>(gs, &map_g, full, h * D, 0, n);
    return;
  }
  setmaxnreg_inc<232>();
  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);
  const int r0 = wgi * 64 + warp * 16 + (lane >> 2);  // the thread's rows: r0, r0 + 8
  const float* brow = bias + static_cast<size_t>(n) * L;
  float s[64], dp[64];
  mbar_wait(full, 0);
  scores_and_dp<D>(s, dp, qs + wgi * 64 * Rows<D>::ROWB, gs + wgi * 64 * Rows<D>::ROWB, ks,
                   vs);
  mask_scores<CAUSAL>(s, brow, 0, c0, r0, L, scale);
  // the exact row softmax, D = rowsum(dP * P) from the f32 P, dS = P (dP -
  // D); rows past L get P = dS = 0
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float mx = quad_max(row_max(s, hf));
    float part = 0.0f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float e = expf(s[4 * jj + 2 * hf + u] - mx);
        s[4 * jj + 2 * hf + u] = e;
        part += e;
      }
    }
    const float sum = quad_sum(part);
    const bool live = r0 + 8 * hf < L;
    float dpart = 0.0f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 4 * jj + 2 * hf + u;
        const float p = live ? s[i] / sum : 0.0f;
        s[i] = p;
        dpart += dp[i] * p;
      }
    }
    const float dsum = quad_sum(dpart);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 4 * jj + 2 * hf + u;
        dp[i] = s[i] * (dp[i] - dsum);
      }
  }
  store_ptile(ps, s, r0, lane);
  store_ptile(dss, dp, r0, lane);
  // dQ = dS k * scale
  {
    uint32_t a[8][4];
    to_frags(dp, a);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    fence_acc(acc);
    wgmma_fence();
    issue_ds_k<D>(acc, a, ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    store_rows<D>(dq, acc, n, h, r0, c0, L, H, scale);
  }
  // dV = P^T g and dK = dS^T q * scale for the warpgroup's 64 keys
  fence_proxy_async();
  named_barrier(1, TWO_WG);
  float dva[D / 2], dka[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dva[i] = dka[i] = 0.0f;
  fence_acc(dva);
  fence_acc(dka);
  wgmma_fence();
  issue_dkv<D>(dva, dka, ps, dss, gs, qs, wgi);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(dva);
  fence_acc(dka);
  store_rows<D>(dv, dva, n, h, r0, c0, L, H, 1.0f);
  store_rows<D>(dk, dka, n, h, r0, c0, L, H, scale);
}

// ---- L > 128 (every L at D = 256), pass 1: one block per (128 query
// rows, head, example) ----
template <int D>
struct Pass1Smem {
  static constexpr int NK = key_tile<D>();
  static constexpr int Q = Rows<D>::R128;        // q, g: 128 rows each
  static constexpr int KV = NK * Rows<D>::ROW;   // k, v: NK keys each
  static constexpr int STAGE = 2 * KV;
  // one stage at D = 256, where q and g take 128 KB
  static constexpr int NS = D >= 256 ? 1 : STAGES;
  static constexpr int BYTES = 1024 + 2 * Q + NS * STAGE + 256;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS2, 1)
mha_bwd_dq_wg(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_g,
              const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
              const float* __restrict__ bias, bf16* __restrict__ dq, float* __restrict__ stats,
              int N, int L, int H, int n_heads, float scale) {
  using S = Pass1Smem<D>;
  constexpr int NK = S::NK, NS = S::NS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;
  unsigned char* gs = qs + S::Q;
  unsigned char* ring = gs + S::Q;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * S::STAGE);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + STAGES;
  uint64_t* decide = qbar + 1;
  int* ok_warp = reinterpret_cast<int*>(decide + 1);

  const int qb = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int q0 = qb * BN, h = blockIdx.y, n = blockIdx.z;
  const int nt = (L + NK - 1) / NK;
  const int last = q0 + BN - 1 < L ? q0 + BN - 1 : L - 1;
  const int pre = CAUSAL ? last / NK + 1 : nt;
  const bool test = CAUSAL && pre < nt;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], TWO_WG / 32);
    }
    mbar_init(qbar, 1);
    mbar_init(decide, TWO_WG / 32);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= TWO_WG) {
    // the producer warpgroup hands its registers over; one thread loads q
    // and g, then k and v of every tile of walk 1 and again of walk 2
    setmaxnreg_dec<40>();
    if (threadIdx.x != TWO_WG) return;
    mbar_expect_tx(qbar, 2 * S::Q);
    tma_tile<D, BN>(qs, &map_q, qbar, h * D, q0, n);
    tma_tile<D, BN>(gs, &map_g, qbar, h * D, q0, n);
    int j = 0;
    auto load = [&](int t) {
      const int slot = j % NS;
      if (j >= NS) mbar_wait(&empty[slot], ((j / NS) + 1) & 1);
      unsigned char* st = ring + slot * S::STAGE;
      mbar_expect_tx(&full[slot], S::STAGE);
      tma_tile<D, NK>(st, &map_k, &full[slot], h * D, t * NK, n);
      tma_tile<D, NK>(st + S::KV, &map_v, &full[slot], h * D, t * NK, n);
      ++j;
    };
    for (int t = 0; t < pre; ++t) load(t);
    int walked = nt;
    if (test) {
      mbar_wait(decide, 0);
      int all = 1;
      for (int w = 0; w < TWO_WG / 32; ++w) all &= ok_warp[w];
      if (all) walked = pre;
    }
    for (int t = pre; t < walked; ++t) load(t);
    for (int t = 0; t < walked; ++t) load(t);
    return;
  }

  setmaxnreg_inc<232>();
  const int wgi = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);
  const int qi0 = q0 + wgi * 64 + (warp & 3) * 16 + (lane >> 2);
  const unsigned char* qw = qs + wgi * 64 * Rows<D>::ROWB;  // the warpgroup's 64 rows
  const unsigned char* gw = gs + wgi * 64 * Rows<D>::ROWB;
  const float* brow = bias + static_cast<size_t>(n) * L;
  float s[NK / 2], dp[NK / 2];
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.0f, 0.0f}, dd[2] = {0.0f, 0.0f};
  int j = 0;
  mbar_wait(qbar, 0);

  auto step = [&](int t) -> const unsigned char* {
    const int slot = j % NS;
    mbar_wait(&full[slot], (j / NS) & 1);
    const unsigned char* st = ring + slot * S::STAGE;
    scores_and_dp<D>(s, dp, qw, gw, st, st + S::KV);
    mask_scores<CAUSAL>(s, brow, t, c0, qi0, L, scale);
    return st;
  };
  // walk 1: each row's max m, sum l of exp(s - m) and sum dd of exp(s -
  // m) dP, the thread's shares of both rescaled by exp(m_old - m_new) when a
  // tile raises the max; D = dd / l is rowsum(dP * P) of the exact f32 P
  auto walk1 = [&](int t) {
    step(t);
    mbar_arrive(&empty[j % NS], lane == 0);
    ++j;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float mn = fmaxf(m[hf], quad_max(row_max(s, hf)));
      float part = 0.0f, dpart = 0.0f;
#pragma unroll
      for (int jj = 0; jj < NK / 8; ++jj) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float e = expf(s[4 * jj + 2 * hf + u] - mn);
          part += e;
          dpart += e * dp[4 * jj + 2 * hf + u];
        }
      }
      const float alpha = expf(m[hf] - mn);
      l[hf] = l[hf] * alpha + part;
      dd[hf] = dd[hf] * alpha + dpart;
      m[hf] = mn;
    }
  };
  for (int t = 0; t < pre; ++t) walk1(t);
  int walked = nt;
  int skip = 0;
  if (test) {
    // the causal skip over the block's 128 rows (both warpgroups)
    const bool ok = (qi0 >= L || future_is_zero(m[0])) && (qi0 + 8 >= L || future_is_zero(m[1]));
    ok_warp[warp] = __all_sync(0xffffffffu, ok) ? 1 : 0;
    __syncwarp();
    mbar_arrive(decide, lane == 0);
    mbar_wait(decide, 0);
    skip = 1;
#pragma unroll
    for (int w = 0; w < TWO_WG / 32; ++w) skip &= ok_warp[w];
    walked = __shfl_sync(0xffffffffu, skip ? pre : nt, 0);
  }
  for (int t = pre; t < walked; ++t) walk1(t);
  float dsum[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] = quad_sum(l[hf]);
    dsum[hf] = quad_sum(dd[hf]) / l[hf];
  }

  // walk 2: P = exp(s - m) / l, dS = P (dP - D) in f32, then bf16, dQ += dS k
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  for (int t = 0; t < walked; ++t) {
    const unsigned char* st = step(t);
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) {
      const int hf = (i >> 1) & 1;
      const float p = expf(s[i] - m[hf]) / l[hf];
      dp[i] = p * (dp[i] - dsum[hf]);
    }
    uint32_t a[NK / 16][4];
    to_frags(dp, a);
    fence_acc(acc);
    wgmma_fence();
    issue_ds_k<D>(acc, a, st);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(&empty[j % NS], lane == 0);
    ++j;
  }
  store_rows<D>(dq, acc, n, h, qi0, c0, L, H, scale);
  // the row statistics for pass 2, and the block's skip flag
  const size_t nhl = static_cast<size_t>(N) * n_heads * L;
  const size_t row0 = (static_cast<size_t>(n) * n_heads + h) * L;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qi = qi0 + 8 * hf;
    const bool w = (lane & 3) == 0 && qi < L;
    float* at = stats + row0 + (qi < L ? qi : 0);
    st_b32(at, __float_as_uint(m[hf]), w);
    st_b32(at + nhl, __float_as_uint(l[hf]), w);
    st_b32(at + 2 * nhl, __float_as_uint(dsum[hf]), w);
  }
  int* flags = reinterpret_cast<int*>(stats + 3 * nhl);
  st_b32(flags + (static_cast<size_t>(n) * n_heads + h) * gridDim.x + qb,
         static_cast<uint32_t>(skip), threadIdx.x == 0);
}

// ---- L > 128, pass 2: one block per (key tile of 128, head, example) ----
template <int D>
struct Pass2Smem {
  static constexpr int KV = Rows<D>::R128;  // k, v; q and g of a step: 128 rows each
  static constexpr int STAGE = 2 * KV;
  static constexpr int BYTES = 1024 + 2 * KV + STAGES * STAGE + 2 * PTILE + 64;
};

// Whether pass 2 skips the query rows [128 qs, 128 qs + 128) for key tile
// kt of KT keys: rows wholly before the tile, on all of which pass 1 found
// exp(NEG_BIG - m) = 0 (their P and dS there are exactly zero).
template <bool CAUSAL, int KT = BN>
__device__ __forceinline__ bool skip_rows(const int* __restrict__ flags, int qs, int kt) {
  return CAUSAL && (qs + 1) * BN <= kt * KT && __ldg(flags + qs) != 0;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS2, 1)
mha_bwd_dkv_wg(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_g,
               const float* __restrict__ bias, const float* __restrict__ stats,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int L, int H, int n_heads,
               float scale) {
  using S = Pass2Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ks = smem;
  unsigned char* vs = ks + S::KV;
  unsigned char* ring = vs + S::KV;
  unsigned char* ps = ring + STAGES * S::STAGE;
  unsigned char* dss = ps + PTILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(dss + PTILE);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int kt = blockIdx.x, h = blockIdx.y, n = blockIdx.z;
  const int nqs = (L + BN - 1) / BN;  // steps of 128 query rows
  const size_t nhl = static_cast<size_t>(N) * n_heads * L;
  const size_t row0 = (static_cast<size_t>(n) * n_heads + h) * L;
  const int* flags = reinterpret_cast<const int*>(stats + 3 * nhl) +
                     (static_cast<size_t>(n) * n_heads + h) * nqs;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], TWO_WG / 32);
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= TWO_WG) {
    setmaxnreg_dec<40>();
    if (threadIdx.x != TWO_WG) return;
    mbar_expect_tx(kvbar, 2 * S::KV);
    tma_tile<D, BN>(ks, &map_k, kvbar, h * D, kt * BN, n);
    tma_tile<D, BN>(vs, &map_v, kvbar, h * D, kt * BN, n);
    int j = 0;
    for (int qs = 0; qs < nqs; ++qs) {
      if (skip_rows<CAUSAL>(flags, qs, kt)) continue;
      const int slot = j % STAGES;
      if (j >= STAGES) mbar_wait(&empty[slot], ((j / STAGES) + 1) & 1);
      unsigned char* st = ring + slot * S::STAGE;
      mbar_expect_tx(&full[slot], S::STAGE);
      tma_tile<D, BN>(st, &map_q, &full[slot], h * D, qs * BN, n);
      tma_tile<D, BN>(st + S::KV, &map_g, &full[slot], h * D, qs * BN, n);
      ++j;
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);
  const int rl = wgi * 64 + warp * 16 + (lane >> 2);  // the thread's rows in a step: rl, rl + 8
  const float* brow = bias + static_cast<size_t>(n) * L;
  float s[64], dp[64], dva[D / 2], dka[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dva[i] = dka[i] = 0.0f;
  mbar_wait(kvbar, 0);
  int j = 0;
  for (int qs = 0; qs < nqs; ++qs) {
    const int skip = __shfl_sync(0xffffffffu, skip_rows<CAUSAL>(flags, qs, kt) ? 1 : 0, 0);
    if (skip) continue;
    const int slot = j % STAGES;
    mbar_wait(&full[slot], (j / STAGES) & 1);
    const unsigned char* st = ring + slot * S::STAGE;
    scores_and_dp<D>(s, dp, st + wgi * 64 * Rows<D>::ROWB, st + S::KV + wgi * 64 * Rows<D>::ROWB,
                     ks, vs);
    const int qi0 = qs * BN + rl;
    mask_scores<CAUSAL>(s, brow, kt, c0, qi0, L, scale);
    // P rebuilt from pass 1's statistics, bit for bit; dS = P (dP - D)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qi = qi0 + 8 * hf;
      const bool live = qi < L;
      const size_t at = row0 + (live ? qi : 0);
      const float mx = __ldg(stats + at), sum = __ldg(stats + nhl + at),
                  dsum = __ldg(stats + 2 * nhl + at);
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = 4 * jj + 2 * hf + u;
          const float p = live ? expf(s[i] - mx) / sum : 0.0f;
          s[i] = p;
          dp[i] = p * (dp[i] - dsum);
        }
      }
    }
    named_barrier(1, TWO_WG);  // the last step's dV and dK products are done
    store_ptile(ps, s, rl, lane);
    store_ptile(dss, dp, rl, lane);
    fence_proxy_async();
    named_barrier(1, TWO_WG);
    fence_acc(dva);
    fence_acc(dka);
    wgmma_fence();
    issue_dkv<D>(dva, dka, ps, dss, st + S::KV, st, wgi);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dva);
    fence_acc(dka);
    mbar_arrive(&empty[slot], lane == 0);
    ++j;
  }
  const int key0 = kt * BN + rl;
  store_rows<D>(dv, dva, n, h, key0, c0, L, H, 1.0f);
  store_rows<D>(dk, dka, n, h, key0, c0, L, H, scale);
}

// ---- D >= 128, pass 2: one block per (key tile of 64, head, example),
// each warpgroup owning half of the columns of dV and dK ----
// At D = 128 and 256 the design above would hold dV and dK of a warpgroup's
// 64 keys at all D columns (2 x 64 or 2 x 128 registers a thread) beside
// the scores and dP of 128 keys: 256 or more, over the 232 that setmaxnreg
// gives. Here both warpgroups form S and dP for their 64 query rows of a
// step and the block's 64 keys (m64n64k16), write P and dS to one 64-key
// chunk each, and warpgroup w then forms dV and dK at columns [w D / 2, (w +
// 1) D / 2) of all 64 keys over the step's 128 query rows (m64n64k16 or
// m64n128k16 through wgmma's transpose bits): 2 x D / 4 accumulator
// registers and 64 of scores and dP, 192 a thread at D = 256. The keys'
// scores are formed once, so no product is repeated. Shared memory holds k
// and v (2 x 64 x 2 D bytes), the ring of q and g steps (2 x 128 x 2 D
// bytes a stage: two stages at D = 128, one at 256) and P and dS (32 KB).
template <int D>
struct SplitSmem {
  static constexpr int KT = 64;                   // keys of a block
  static constexpr int KV = KT * Rows<D>::ROW;    // k, v
  static constexpr int QG = Rows<D>::R128;        // q, g of a step: 128 rows each
  static constexpr int STAGE = 2 * QG;
  static constexpr int NS = D >= 256 ? 1 : STAGES;
  static constexpr int BYTES = 1024 + 2 * KV + NS * STAGE + 2 * PCHUNK + 64;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS2, 1)
mha_bwd_dkv_split(const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_g, const float* __restrict__ bias,
                  const float* __restrict__ stats, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int N, int L, int H, int n_heads, float scale) {
  using S = SplitSmem<D>;
  constexpr int KT = S::KT, NS = S::NS, HALF = D / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ks = smem;
  unsigned char* vs = ks + S::KV;
  unsigned char* ring = vs + S::KV;
  unsigned char* ps = ring + NS * S::STAGE;  // P, then dS: 128 rows x 64 keys each
  unsigned char* dss = ps + PCHUNK;
  uint64_t* full = reinterpret_cast<uint64_t*>(dss + PCHUNK);
  uint64_t* empty = full + NS;
  uint64_t* kvbar = empty + NS;

  const int kt = blockIdx.x, h = blockIdx.y, n = blockIdx.z;
  const int nqs = (L + BN - 1) / BN;  // steps of 128 query rows
  const size_t nhl = static_cast<size_t>(N) * n_heads * L;
  const size_t row0 = (static_cast<size_t>(n) * n_heads + h) * L;
  const int* flags = reinterpret_cast<const int*>(stats + 3 * nhl) +
                     (static_cast<size_t>(n) * n_heads + h) * nqs;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], TWO_WG / 32);
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= TWO_WG) {
    setmaxnreg_dec<40>();
    if (threadIdx.x != TWO_WG) return;
    mbar_expect_tx(kvbar, 2 * S::KV);
    tma_tile<D, KT>(ks, &map_k, kvbar, h * D, kt * KT, n);
    tma_tile<D, KT>(vs, &map_v, kvbar, h * D, kt * KT, n);
    int j = 0;
    for (int qs = 0; qs < nqs; ++qs) {
      if (skip_rows<CAUSAL, KT>(flags, qs, kt)) continue;
      const int slot = j % NS;
      if (j >= NS) mbar_wait(&empty[slot], ((j / NS) + 1) & 1);
      unsigned char* st = ring + slot * S::STAGE;
      mbar_expect_tx(&full[slot], S::STAGE);
      tma_tile<D, BN>(st, &map_q, &full[slot], h * D, qs * BN, n);
      tma_tile<D, BN>(st + S::QG, &map_g, &full[slot], h * D, qs * BN, n);
      ++j;
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3);
  const int kr = warp * 16 + (lane >> 2);  // the thread's keys of dV, dK: kr, kr + 8
  const int rl = wgi * 64 + kr;            // the thread's rows in a step: rl, rl + 8
  // the warpgroup's columns of g and q: chunks wgi D / 128 on
  const int cols = wgi * (HALF / 64) * BN * 128;
  const float* brow = bias + static_cast<size_t>(n) * L;
  float s[KT / 2], dp[KT / 2], dva[HALF / 2], dka[HALF / 2];
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) dva[i] = dka[i] = 0.0f;
  mbar_wait(kvbar, 0);
  int j = 0;
  for (int qs = 0; qs < nqs; ++qs) {
    const int skip = __shfl_sync(0xffffffffu, skip_rows<CAUSAL, KT>(flags, qs, kt) ? 1 : 0, 0);
    if (skip) continue;
    const int slot = j % NS;
    mbar_wait(&full[slot], (j / NS) & 1);
    const unsigned char* st = ring + slot * S::STAGE;
    scores_and_dp<D>(s, dp, st + wgi * 64 * Rows<D>::ROWB,
                     st + S::QG + wgi * 64 * Rows<D>::ROWB, ks, vs);
    const int qi0 = qs * BN + rl;
    mask_scores<CAUSAL>(s, brow, kt, c0, qi0, L, scale);
    // P rebuilt from pass 1's statistics, bit for bit; dS = P (dP - D)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qi = qi0 + 8 * hf;
      const bool live = qi < L;
      const size_t at = row0 + (live ? qi : 0);
      const float mx = __ldg(stats + at), sum = __ldg(stats + nhl + at),
                  dsum = __ldg(stats + 2 * nhl + at);
#pragma unroll
      for (int jj = 0; jj < KT / 8; ++jj) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = 4 * jj + 2 * hf + u;
          const float p = live ? expf(s[i] - mx) / sum : 0.0f;
          s[i] = p;
          dp[i] = p * (dp[i] - dsum);
        }
      }
    }
    named_barrier(1, TWO_WG);  // the last step's dV and dK products are done
    store_ptile(ps, s, rl, lane);
    store_ptile(dss, dp, rl, lane);
    fence_proxy_async();
    named_barrier(1, TWO_WG);
    fence_acc(dva);
    fence_acc(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int row = kk * 16 * Rows<D>::ROWB;
      mma_d<HALF, 1, 1>(dva, pdesc(ps, 0, kk), ndesc<D, BN>(st + S::QG + cols + row), 1);
      mma_d<HALF, 1, 1>(dka, pdesc(dss, 0, kk), ndesc<D, BN>(st + cols + row), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dva);
    fence_acc(dka);
    mbar_arrive(&empty[slot], lane == 0);
    ++j;
  }
  const int key0 = kt * KT + kr;
  store_block<HALF>(dv, dva, n, h * D + wgi * HALF, key0, c0, L, H, 1.0f);
  store_block<HALF>(dk, dka, n, h * D + wgi * HALF, key0, c0, L, H, scale);
}

template <int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* g,
           void* dq, void* dk, void* dv, void* stats, int N, int L, int H, int n_heads,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const auto* bb = static_cast<const float*>(bias);
  constexpr int NK = key_tile<D>(), BOX = Rows<D>::BOX;
  CUtensorMap mq, mk, mv, mg;
  int e = bft::make_map_bf16_box(&mq, q, N, L, H, H, BN, BOX);
  if (!e) e = bft::make_map_bf16_box(&mk, k, N, L, H, H, NK, BOX);
  if (!e) e = bft::make_map_bf16_box(&mv, v, N, L, H, H, NK, BOX);
  if (!e) e = bft::make_map_bf16_box(&mg, g, N, L, H, H, BN, BOX);
  if (e) return e;
  // one pass up to L = 128 at widths up to 128; D = 256 (whose q, k, v and
  // g would take 256 KB) takes the two passes at every L
  if constexpr (D <= 128) {
    if (L <= BN) {
      constexpr int smem = RowsSmem<D>::BYTES;
      cudaError_t err = bft::allow_smem<mha_bwd_rows<D, CAUSAL>>(smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      mha_bwd_rows<D, CAUSAL><<<dim3(n_heads, N), THREADS2, smem, st>>>(
          mq, mk, mv, mg, bb, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), L, H, scale);
      return static_cast<int>(cudaGetLastError());
    }
  }
  constexpr int smem1 = Pass1Smem<D>::BYTES;
  cudaError_t err = bft::allow_smem<mha_bwd_dq_wg<D, CAUSAL>>(smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* sp = static_cast<float*>(stats);
  mha_bwd_dq_wg<D, CAUSAL><<<dim3((L + BN - 1) / BN, n_heads, N), THREADS2, smem1, st>>>(
      mq, mg, mk, mv, bb, static_cast<bf16*>(dq), sp, N, L, H, n_heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (D >= 128) {
    // pass 2's k and v tiles are 64 keys
    constexpr int KT = SplitSmem<D>::KT, smem2 = SplitSmem<D>::BYTES;
    CUtensorMap mk2, mv2;
    e = bft::make_map_bf16_box(&mk2, k, N, L, H, H, KT, BOX);
    if (!e) e = bft::make_map_bf16_box(&mv2, v, N, L, H, H, KT, BOX);
    if (e) return e;
    err = bft::allow_smem<mha_bwd_dkv_split<D, CAUSAL>>(smem2);
    if (err != cudaSuccess) return static_cast<int>(err);
    mha_bwd_dkv_split<D, CAUSAL><<<dim3((L + KT - 1) / KT, n_heads, N), THREADS2, smem2, st>>>(
        mk2, mv2, mq, mg, bb, sp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, L, H,
        n_heads, scale);
  } else {
    constexpr int smem2 = Pass2Smem<D>::BYTES;
    err = bft::allow_smem<mha_bwd_dkv_wg<D, CAUSAL>>(smem2);
    if (err != cudaSuccess) return static_cast<int>(err);
    mha_bwd_dkv_wg<D, CAUSAL><<<dim3((L + BN - 1) / BN, n_heads, N), THREADS2, smem2, st>>>(
        mk, mv, mq, mg, bb, sp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), N, L, H,
        n_heads, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

template <int D>
int dispatch(const void* q, const void* k, const void* v, const void* bias, const void* g,
             void* dq, void* dk, void* dv, void* stats, int N, int L, int H, int n_heads,
             int f32, int causal, void* stream) {
  if (f32)
    return causal ? launch<float, D, true>(q, k, v, bias, g, dq, dk, dv, stats, N, L, H,
                                           n_heads, stream)
                  : launch<float, D, false>(q, k, v, bias, g, dq, dk, dv, stats, N, L, H,
                                            n_heads, stream);
  return causal ? wg::launch<D, true>(q, k, v, bias, g, dq, dk, dv, stats, N, L, H, n_heads,
                                      stream)
                : wg::launch<D, false>(q, k, v, bias, g, dq, dk, dv, stats, N, L, H, n_heads,
                                       stream);
}

}  // namespace

// q / k / v / g / dq / dk / dv (N, L, H) bf16 (f32 = 0) or f32 (f32 = 1),
// bias (N, L) f32, causal masking when causal = 1; H = n_heads * D with D =
// 32, 64, 128 or 256; stats scratch of 3 N n_heads L f32 (the rows' max,
// sum and D) and N n_heads ceil(L / 128) int32 (bf16: each 128-row query
// block's skip flag). bf16: one pass up to L = 128 (D <= 128), two above
// and at every L at D = 256; f32: whole rows in pass 1 up to L = 512 (256
// at D = 256), key tiles above. Returns cudaGetLastError().

// Each of the widths 128 and 256 compiles in a translation unit of its own
// (mha_bwd_128.cu and mha_bwd_256.cu include this file with BFT_MHA_WIDTH
// defined), so that the build's parallel nvcc processes share the work;
// each unit instantiates only the templates its entry point dispatches to.
#define BFT_PASTE2(a, b) a##b
#define BFT_PASTE(a, b) BFT_PASTE2(a, b)
#ifdef BFT_MHA_WIDTH
extern "C" int BFT_PASTE(bft_mha_bwd_d, BFT_MHA_WIDTH)(
    const void* q, const void* k, const void* v, const void* bias,
    const void* g, void* dq, void* dk, void* dv, void* stats,
    int N, int L, int H, int n_heads, int f32, int causal,
    void* stream) {
  return dispatch<BFT_MHA_WIDTH>(q, k, v, bias, g, dq, dk, dv, stats, N, L, H, n_heads, f32,
                                 causal, stream);
}
#else
extern "C" int bft_mha_bwd_d128(const void* q, const void* k, const void* v,
                                const void* bias, const void* g, void* dq, void* dk,
                                void* dv, void* stats, int N, int L, int H,
                                int n_heads, int f32, int causal, void* stream);
extern "C" int bft_mha_bwd_d256(const void* q, const void* k, const void* v,
                                const void* bias, const void* g, void* dq, void* dk,
                                void* dv, void* stats, int N, int L, int H,
                                int n_heads, int f32, int causal, void* stream);

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
    case 128:
      return bft_mha_bwd_d128(q, k, v, bias, g, dq, dk, dv, stats, N, L, H, n_heads, f32,
                              causal, stream);
    case 256:
      return bft_mha_bwd_d256(q, k, v, bias, g, dq, dk, dv, stats, N, L, H, n_heads, f32,
                              causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif

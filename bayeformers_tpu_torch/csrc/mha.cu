// mha_fwd: multi-head self-attention forward in the flat (N, L, H) layout.
//
// Replaces bayeformers_tpu/ops/attention.py::_fwd_kernel_stacked (Pallas #3),
// the head-grouped forward, and its per-head twin _fwd_kernel (Pallas #4),
// which computes the same function: the reference takes #4 where Pallas fits
// but no head group of 2 or more does (attention.py:321-330), which at the
// shapes this port serves means head width 32 at L around 1024. This kernel
// runs one block per (query tile, head, example), so the instance that
// serves those shapes (the key-tiled one below, at D = 32) is #4's
// counterpart; the wrapper counts its launches there under #4's name.
// Same contract as #3: q/k/v/out (N, L, H) bf16 with head h in columns
// [h*D, (h+1)*D), an additive f32 key bias (N, L); scores = (q_h k_h^T) *
// scale + bias in f32, scale = 1 / sqrt(D) rounded to f32 and applied to the
// f32 scores after the product (attention.py:104), a row softmax in f32,
// then P cast to bf16 and O = P v_h with f32 accumulation. The head width D
// is a template parameter, instantiated at 32, 64, 128 and 256.
//
// Causal instances (CAUSAL = true, GPT-2, LLaMA): after the bias add and
// before the row max, score (i, j) with key j > query i becomes NEG_BIG =
// finfo(f32).min, a select as in the reference's jnp.where
// (attention.py:106-107), not an add: bias-masked and causal-masked scores
// then hold the same value, and a row with every key masked stays uniform
// over all L keys.
//
// Bound on the H100: at BERT's L = 128 the work is 4*N*L*L*H flops over
// 4*N*L*H*2 bytes, about 32 flops a byte, below the ~295 at which the
// tensor cores rather than the memory would be the limit: the kernel should
// move each of q, k, v, out once; at L = 1024 the causal products take
// about as long as the bytes.
//
// bf16 (wg::mha_fwd_wg): work items of (query tile of 64 rows, head,
// example), the longest causal rows first, walked by a persistent grid of
// two blocks an SM. In a block a producer warp loads each item's q tile,
// one item ahead, and the key tiles of 128 (k, then v) by TMA into a ring
// of 2 stages (attention.cuh: a 3-D map over (N, L, H), so the head is
// sliced on the way in and rows past L read as zero); one consumer
// warpgroup forms S = q k^T on wgmma m64n128k16 from shared memory, applies
// the scale, the bias and the causal select in registers (keys past L are
// excluded by their index), and forms O = P v on wgmma m64nDk16 with P as
// the register A operand. Two designs, two instances:
//  * whole rows (L <= 128, one key tile: BERT, GPT-2 and LLaMA at L = 128):
//    the warpgroup's whole score rows sit in the accumulator, so the
//    softmax is exact and done in registers (row max and sum by quad
//    shuffles, P normalised and then cast to bf16, as _mha_xla), in one
//    pass with no rescaling, the reference's order of arithmetic (the
//    normalisation multiplies by 1 / l, within an f32 ulp of dividing).
//    L = 256 would hold 128 score and 64 P registers a thread beside O's:
//    longer rows take the key-tiled walk.
//  * key-tiled (L > 128): the exact two-walk softmax rather than an online
//    one with O rescaled. Walk 1 forms each tile's scores and carries the
//    row max m and the row sum l (rescaled by exp(m_old - m_new) when a
//    tile raises the max); walk 2 forms the same scores again, P = exp(s -
//    m) / l, cast to bf16, and O += P v. P is then the reference's
//    normalised P in bf16, rounded as in the whole-row design, and O is
//    never rescaled; the cost is the second q k^T, a third more products.
//    Shared memory does not grow with L, so no length is refused.
//  * wide heads (D = 128, 256): the q, k and v tiles arrive as 64-column
//    boxes (attention.cuh) and O = P v runs on m64n128k16 or m64n256k16
//    with P in registers. A block holds O at 64 or 128 registers a thread
//    and two stages of k and v that fill most of an SM's shared memory, so
//    one block runs an SM; at D = 256 the key tile narrows to 64 keys (32
//    score registers beside O's 128, two stages of 64 KB), and every L
//    takes the key-tiled walk.
// The causal skip: the tiles of the causal prefix are walked first; a key
// tile that lies wholly above the diagonal of every row of the query tile
// is skipped, in both walks, when exp(NEG_BIG - m) is 0.0f in f32 for
// every row, m the row's max over its prefix: those keys then add exactly
// zero to l and to O, so no bit of the tile's output changes. A tile
// holding a row whose whole prefix is masked (m = NEG_BIG) walks all L keys,
// which keeps that row uniform over all of them. The consumers decide
// (one mbarrier) and the producer follows.
//
// f32: q, k, v and out f32 and both products true f32 (3xTF32, mma.cuh) on
// WMMA, as the reference's kernel takes its dot operands in the stored
// dtype (bayeformers_tpu/ops/attention.py:83-89). TF32 wgmma takes only
// K-major operands from shared memory and P v needs v MN-major; the f32
// instances keep their design: one block of 4 warps per (query tile of 64,
// head, example); whole rows (L <= 512) keep the score rows in shared
// memory, P written over them (163 KB at L = 512; whole rows up to L = 256
// at D = 256, where the q and k tiles take 133 KB); longer rows walk the
// keys twice in tiles of 64 with the same exact softmax. They skip no
// tile above the diagonal. At D >= 128 both products sum in steps of fresh
// fragments added by FADD (mma.cuh's add_into): one chain in the tensor
// cores' accumulator over D = 256 drifted by 1e-5 of the scores on the
// H100; the instances at 32 and 64 keep their one chain.
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

constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 64;      // keys per staged block
constexpr int THREADS = 128; // 4 warps, 16 query rows each
// The longest L of the whole-row design: 512, or 256 at D = 256, whose q and
// k tiles (2 x 64 x 260 f32) leave room for score rows of 256 keys only.
template <int D>
__host__ __device__ constexpr int max_rows_len() {
  return D >= 256 ? 256 : 512;
}
constexpr int TSLD = BKV + 4;    // f32 leading dim of one key tile's scores
constexpr unsigned NEG_BIG_BITS = 0xff7fffffu;  // finfo(f32).min = -FLT_MAX

// q / k / v tiles in T (f32, the only instance of these templates), leading
// dim padded by 16 bytes; P written over the f32 score rows.
template <typename T, int D>
struct Layout {
  static constexpr int QLD = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int OLD = D + 4;  // f32 leading dim of the output tile
  static constexpr int VEC = bft::Mma<T>::VEC;
  // the key-tiled design: one tile's scores, P over them
  static constexpr size_t TILED_BYTES =
      2 * static_cast<size_t>(BQ) * QLD * sizeof(T) + static_cast<size_t>(BQ) * TSLD * 4 +
      2 * BQ * 4;
};

__host__ __device__ constexpr int round64(int l) { return (l + 63) / 64 * 64; }
__host__ __device__ constexpr int sld(int lk) { return lk + 4; }
template <typename T, int D>
__host__ __device__ constexpr size_t smem_bytes(int lk) {
  return 2 * static_cast<size_t>(BQ) * Layout<T, D>::QLD * sizeof(T) +
         static_cast<size_t>(BQ) * sld(lk) * 4;
}

// Rows [row0, row0 + 64) of one head's (L, D) slice into a (64, QLD) tile;
// rows >= L are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, T* dst,
                                          int n, int h, int row0, int L, int H) {
  constexpr int VEC = Layout<T, D>::VEC, CPR = D / VEC, QLD = Layout<T, D>::QLD;
  for (int q = threadIdx.x; q < BQ * CPR; q += THREADS) {
    const int row = q / CPR, chunk = q % CPR;
    const int l = row0 + row;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (l < L)
      v = *reinterpret_cast<const uint4*>(
          src + (static_cast<size_t>(n) * L + l) * H + h * D + chunk * VEC);
    *reinterpret_cast<uint4*>(dst + row * QLD + chunk * VEC) = v;
  }
}

// Warp w's 16 query rows by the 64 keys of the staged tile, (q_h k_h^T)
// unscaled in f32, into ``out`` (leading dim ld) at the warp's rows. At
// D >= 128 each 32-deep step of the contraction starts a fresh fragment,
// added to the scores by FADD (bft::add_into): the accumulator's drift over
// D = 256 read 1e-5 of the scores on the H100; the instances at 32 and 64
// keep their one chain over D, bit for bit.
template <typename T, int D>
__device__ __forceinline__ void warp_scores(const T* qs, const T* kvs, float* out,
                                            int ld) {
  constexpr int QLD = Layout<T, D>::QLD, KD = bft::Mma<T>::KDEPTH;
  constexpr int STEP = D >= 128 ? 32 : D;  // the depth of one accumulator chain
  const int warp = threadIdx.x >> 5;
  bft::Acc<T> sc[4], part[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(sc[j], 0.0f);
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += STEP) {
    bft::Acc<T>(&chain)[4] = STEP < D ? part : sc;
    if (STEP < D) {
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(part[j], 0.0f);
    }
#pragma unroll
    for (int kk = k0; kk < k0 + STEP; kk += KD) {
      bft::Operand<T, wmma::matrix_a, wmma::row_major> a;
      a.load(qs + warp * 16 * QLD + kk, QLD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // k^T as a col-major (d, key) operand straight from the (key, d) tile
        bft::Operand<T, wmma::matrix_b, wmma::col_major> b;
        b.load(kvs + j * 16 * QLD + kk, QLD);
        bft::mma(chain[j], a, b);
      }
    }
    if (STEP < D) {
#pragma unroll
      for (int j = 0; j < 4; ++j) bft::add_into(sc[j], part[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(out + warp * 16 * ld + j * 16, sc[j], ld, wmma::mem_row_major);
}

// The masked f32 score of query row i and key j, the same in every walk.
template <bool CAUSAL>
__device__ __forceinline__ float masked_score(float acc, float scale, float bias, int i,
                                              int j) {
  const float s = __fadd_rn(__fmul_rn(acc, scale), bias);
  return (CAUSAL && j > i) ? __int_as_float(NEG_BIG_BITS) : s;
}

// o[j] += P (warp w's 16 rows of a 64-key tile, leading dim pld) v (the
// staged (64 keys, D) tile). At D >= 128 the tile's products go into a
// fresh fragment that is added to O by FADD, as in warp_scores; below, O
// carries them in its one chain over all L keys.
template <typename T, int D>
__device__ __forceinline__ void warp_pv(bft::Acc<T> (&o)[D / 16], const T* ps, int pld,
                                        const T* kvs) {
  constexpr int QLD = Layout<T, D>::QLD, KD = bft::Mma<T>::KDEPTH;
  constexpr bool FRESH = D >= 128;
  const int warp = threadIdx.x >> 5;
  bft::Acc<T> part[FRESH ? D / 16 : 1];
  if (FRESH) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(part[FRESH ? j : 0], 0.0f);
  }
#pragma unroll
  for (int kk = 0; kk < BKV; kk += KD) {
    bft::Operand<T, wmma::matrix_a, wmma::row_major> a;
    a.load(ps + warp * 16 * pld + kk, pld);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      bft::Operand<T, wmma::matrix_b, wmma::row_major> b;
      b.load(kvs + kk * QLD + j * 16, QLD);
      bft::mma(FRESH ? part[FRESH ? j : 0] : o[j], a, b);
    }
  }
  if (FRESH) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) bft::add_into(o[j], part[FRESH ? j : 0]);
  }
}

// The (64, D) output tile: O fragments to shared memory over ``os``, then
// rows < L to out.
template <typename T, int D>
__device__ __forceinline__ void store_out(bft::Acc<T> (&o)[D / 16], float* os,
                                          T* __restrict__ out, int n, int h, int q0,
                                          int L, int H) {
  constexpr int OLD = Layout<T, D>::OLD;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(os + warp * 16 * OLD + j * 16, o[j], OLD,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int row = i / D, col = i % D;
    const int l = q0 + row;
    if (l < L)
      out[(static_cast<size_t>(n) * L + l) * H + h * D + col] =
          from_f32<T>(os[row * OLD + col]);
  }
}

// The whole-row design (L <= max_rows_len).
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ bias,
               T* __restrict__ out, int L, int H, float scale) {
  constexpr int QLD = Layout<T, D>::QLD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lk = round64(L);
  T* qs = reinterpret_cast<T*>(smem);
  T* kvs = qs + BQ * QLD;
  float* ss = reinterpret_cast<float*>(kvs + BKV * QLD);
  T* ps = reinterpret_cast<T*>(ss);  // P over the score rows
  // the output tile reuses the score rows once P is used; at D >= 128 it
  // outgrows them and takes the q and k tiles' room instead
  float* os = D >= 128 ? reinterpret_cast<float*>(smem) : ss;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int SLD = sld(lk), PLD = sld(lk);

  load_tile<T, D>(q, qs, n, h, q0, L, H);

  // ---- scores: (64 query rows, lk keys) f32 ----
  for (int kb = 0; kb < lk; kb += BKV) {
    __syncthreads();
    load_tile<T, D>(k, kvs, n, h, kb, L, H);
    __syncthreads();
    warp_scores<T, D>(qs, kvs, ss + kb, SLD);
  }
  __syncwarp();

  // ---- row softmax in f32; each warp owns its 16 rows ----
  const float* brow = bias + static_cast<size_t>(n) * L;
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float* srow = ss + r * SLD;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int c = lane; c < L; c += 32) {
      const float s = masked_score<CAUSAL>(srow[c], scale, brow[c], q0 + r, c);
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int c = lane; c < L; c += 32) {
      const float e = expf(srow[c] - mx);
      srow[c] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    T* prow = ps + r * PLD;  // over srow itself in f32: element c reads, then writes c
    for (int c = lane; c < lk; c += 32)
      prow[c] = from_f32<T>(c < L ? srow[c] / sum : 0.0f);
  }

  // ---- O = P v ----
  bft::Acc<T> o[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(o[j], 0.0f);
  for (int kb = 0; kb < lk; kb += BKV) {
    __syncthreads();
    load_tile<T, D>(v, kvs, n, h, kb, L, H);
    __syncthreads();
    warp_pv<T, D>(o, ps + kb, PLD, kvs);
  }
  __syncthreads();
  store_out<T, D>(o, os, out, n, h, q0, L, H);
}

// The key-tiled design (L > max_rows_len): the same scores and softmax, walked one
// key tile of 64 at a time.
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
mha_fwd_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, int L, int H, float scale) {
  using Lay = Layout<T, D>;
  constexpr int QLD = Lay::QLD, TPLD = TSLD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* kvs = qs + BQ * QLD;
  float* ts = reinterpret_cast<float*>(kvs + BKV * QLD);  // one tile's scores
  T* tp = reinterpret_cast<T*>(ts);  // one tile's P over its scores
  float* row_m = reinterpret_cast<float*>(smem + Lay::TILED_BYTES) - 2 * BQ;
  float* row_l = row_m + BQ;
  // the output tile reuses the score tile at the end (D >= 128: the q and
  // k tiles')
  float* os = D >= 128 ? reinterpret_cast<float*>(smem) : ts;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* brow = bias + static_cast<size_t>(n) * L;

  load_tile<T, D>(q, qs, n, h, q0, L, H);
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    row_m[i] = __int_as_float(0xff800000);  // -inf
    row_l[i] = 0.0f;
  }

  // ---- walk 1: each row's max and sum of exp(s - max) ----
  for (int kb = 0; kb < L; kb += BKV) {
    __syncthreads();
    load_tile<T, D>(k, kvs, n, h, kb, L, H);
    __syncthreads();
    warp_scores<T, D>(qs, kvs, ts, TSLD);
    __syncwarp();
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      float s[2], mx = __int_as_float(0xff800000);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        s[u] = kb + c < L
                   ? masked_score<CAUSAL>(ts[r * TSLD + c], scale, brow[kb + c], q0 + r,
                                          kb + c)
                   : __int_as_float(0xff800000);
        mx = fmaxf(mx, s[u]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = row_m[r], m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (kb + lane + 32 * u < L) sum += expf(s[u] - m_new);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        row_l[r] = row_l[r] * expf(m_old - m_new) + sum;
        row_m[r] = m_new;
      }
      __syncwarp();
    }
  }

  // ---- walk 2: P = exp(s - m) / l, O += P v ----
  bft::Acc<T> o[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(o[j], 0.0f);
  for (int kb = 0; kb < L; kb += BKV) {
    __syncthreads();
    load_tile<T, D>(k, kvs, n, h, kb, L, H);
    __syncthreads();
    warp_scores<T, D>(qs, kvs, ts, TSLD);
    __syncwarp();
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const float m = row_m[r], l = row_l[r];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        float p = 0.0f;
        if (kb + c < L)
          p = expf(masked_score<CAUSAL>(ts[r * TSLD + c], scale, brow[kb + c], q0 + r,
                                        kb + c) - m) / l;
        tp[r * TPLD + c] = from_f32<T>(p);  // over ts itself in f32: c reads, then writes c
      }
    }
    __syncthreads();
    load_tile<T, D>(v, kvs, n, h, kb, L, H);
    __syncthreads();
    warp_pv<T, D>(o, tp, TPLD, kvs);
  }
  __syncthreads();
  store_out<T, D>(o, os, out, n, h, q0, L, H);
}

template <typename T, int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int N, int L, int H, int n_heads, void* stream) {
  const bool tiled = L > max_rows_len<D>();
  const size_t smem = tiled ? Layout<T, D>::TILED_BYTES : smem_bytes<T, D>(round64(L));
  auto kernel = tiled ? mha_fwd_tiled_kernel<T, D, CAUSAL> : mha_fwd_kernel<T, D, CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // 1 / sqrt(D) rounded to f32, as the plain version's Python float
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const dim3 grid((L + BQ - 1) / BQ, n_heads, N);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), L, H, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16 ----
namespace wg {

using bf16 = __nv_bfloat16;
using namespace bft::sm90;
using namespace bft::attn;

constexpr int STAGES = 2;                // ring of key tiles
constexpr int CONSUMERS = 128;           // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp

// Two blocks an SM up to D = 64; one at D = 128 and 256, whose stages
// (two of 2 x 128 x 256 or 2 x 64 x 512 bytes) fill most of an SM's shared
// memory and whose O accumulator (64 or 128 registers a thread) needs the
// registers of a block alone.
template <int D>
__host__ __device__ constexpr int blocks_per_sm() {
  return D >= 128 ? 1 : 2;
}

template <int D>
struct Smem {
  static constexpr int NK = key_tile<D>();      // keys of a tile
  static constexpr int Q = Rows<D>::R64;        // a query tile
  static constexpr int KV = NK * Rows<D>::ROW;  // one key tile of k or of v
  static constexpr int STAGE = 2 * KV;          // k, then v
  static constexpr int BYTES = 1024 + 2 * Q + STAGES * STAGE + 256;
};

// A work item, a (query tile of 64, head, example): the block's i-th is
// item blockIdx.x + i gridDim.x; the query tile varies slowest, the longest
// causal rows first.
struct Item {
  int q0, h, n, pre, test;
};

template <bool CAUSAL, int NK>
__device__ __forceinline__ Item item_at(int it, int pairs, int n_heads, int nt, int L) {
  Item x;
  const int qt = (L + BM - 1) / BM - 1 - it / pairs, rest = it % pairs;
  x.h = rest % n_heads;
  x.n = rest / n_heads;
  x.q0 = qt * BM;
  const int last = x.q0 + BM - 1 < L ? x.q0 + BM - 1 : L - 1;
  x.pre = CAUSAL ? last / NK + 1 : nt;  // the key tiles of the causal prefix
  x.test = CAUSAL && x.pre < nt;        // a skip to decide
  return x;
}

// Persistent: each block walks its items; the module note.
template <int D, bool CAUSAL, bool ROWS>
__global__ void __launch_bounds__(THREADS, blocks_per_sm<D>())
mha_fwd_wg(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v, const float* __restrict__ bias,
           bf16* __restrict__ out, int L, int H, int n_heads, int n_items, float scale) {
  using S = Smem<D>;
  constexpr int NK = S::NK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qbuf = smem;  // two query tiles: the item's and the next one's
  unsigned char* ring = smem + 2 * S::Q;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * S::STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;
  uint64_t* qempty = qfull + 2;
  uint64_t* decide = qempty + 2;
  int* ok_warp = reinterpret_cast<int*>(decide + 1);  // the skip test, one per warp

  const int nt = ROWS ? 1 : (L + NK - 1) / NK;
  const int pairs = n_items / ((L + BM - 1) / BM);  // (head, example) pairs
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], CONSUMERS / 32);
    }
    mbar_init(decide, CONSUMERS / 32);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // the producer warp: one thread loads each item's q tile (one item
    // ahead), then walk 1's k tiles and walk 2's k and v tiles into the
    // ring, in the consumers' order, across items
    if (threadIdx.x != CONSUMERS) return;
    int j = 0, tests = 0;
    for (int i = 0, it = blockIdx.x; it < n_items; ++i, it += gridDim.x) {
      const Item x = item_at<CAUSAL, NK>(it, pairs, n_heads, nt, L);
      const int qb = i & 1;
      if (i >= 2) mbar_wait(&qempty[qb], ((i >> 1) + 1) & 1);
      mbar_expect_tx(&qfull[qb], S::Q);
      tma_tile<D, BM>(qbuf + qb * S::Q, &map_q, &qfull[qb], x.h * D, x.q0, x.n);
      auto load = [&](int t, bool with_v) {
        const int slot = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[slot], ((j / STAGES) + 1) & 1);
        unsigned char* st = ring + slot * S::STAGE;
        mbar_expect_tx(&full[slot], with_v ? S::STAGE : S::KV);
        tma_tile<D, NK>(st, &map_k, &full[slot], x.h * D, t * NK, x.n);
        if (with_v) tma_tile<D, NK>(st + S::KV, &map_v, &full[slot], x.h * D, t * NK, x.n);
        ++j;
      };
      int walked = nt;
      if (!ROWS) {
        for (int t = 0; t < x.pre; ++t) load(t, false);
        if (x.test) {
          mbar_wait(decide, tests & 1);
          ++tests;
          if (ok_warp[0] & ok_warp[1] & ok_warp[2] & ok_warp[3]) walked = x.pre;
        }
        for (int t = x.pre; t < walked; ++t) load(t, false);
      }
      for (int t = 0; t < walked; ++t) load(t, true);
    }
    return;
  }

  // the consumers: no branch on the thread around wgmma work
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = 2 * (lane & 3), rw = warp * 16 + (lane >> 2);
  float s[NK / 2], o[D / 2];
  int j = 0, tests = 0;
  for (int i = 0, it = blockIdx.x; it < n_items; ++i, it += gridDim.x) {
    const Item x = item_at<CAUSAL, NK>(it, pairs, n_heads, nt, L);
    const int qb = i & 1;
    const unsigned char* qs = qbuf + qb * S::Q;
    const int qi0 = x.q0 + rw;  // the thread's queries: qi0, qi0 + 8
    const float* brow = bias + static_cast<size_t>(x.n) * L;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.0f;
    float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.0f, 0.0f};
    mbar_wait(&qfull[qb], (i >> 1) & 1);

    // the masked scores of key tile t from the next stage of the ring;
    // returns the stage
    auto scores = [&](int t) -> const unsigned char* {
      const int slot = j % STAGES;
      mbar_wait(&full[slot], (j / STAGES) & 1);
      const unsigned char* st = ring + slot * S::STAGE;
      fence_acc(s);
      wgmma_fence();
      issue_rows_by_keys<D, BM>(s, qs, st);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      mask_scores<CAUSAL>(s, brow, t, c0, qi0, L, scale);
      return st;
    };

    int walked = nt;
    if (!ROWS) {
      // walk 1: each row's max m and sum l of exp(s - m), the thread's
      // share of l rescaled by exp(m_old - m_new) when a tile raises the max
      auto walk1 = [&](int t) {
        scores(t);
        mbar_arrive(&empty[j % STAGES], lane == 0);
        ++j;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float mn = fmaxf(m[hf], quad_max(row_max(s, hf)));
          float part = 0.0f;
#pragma unroll
          for (int jj = 0; jj < NK / 8; ++jj)
            part += expf(s[4 * jj + 2 * hf] - mn) + expf(s[4 * jj + 2 * hf + 1] - mn);
          l[hf] = l[hf] * expf(m[hf] - mn) + part;
          m[hf] = mn;
        }
      };
      for (int t = 0; t < x.pre; ++t) walk1(t);
      if (x.test) {
        // the causal skip (module note); rows past L do not hold it back
        const bool ok = (qi0 >= L || future_is_zero(m[0])) &&
                        (qi0 + 8 >= L || future_is_zero(m[1]));
        ok_warp[warp] = __all_sync(0xffffffffu, ok) ? 1 : 0;
        __syncwarp();
        mbar_arrive(decide, lane == 0);
        mbar_wait(decide, tests & 1);
        ++tests;
        walked = (ok_warp[0] & ok_warp[1] & ok_warp[2] & ok_warp[3]) ? x.pre : nt;
        walked = __shfl_sync(0xffffffffu, walked, 0);
      }
      for (int t = x.pre; t < walked; ++t) walk1(t);
      l[0] = 1.0f / quad_sum(l[0]);
      l[1] = 1.0f / quad_sum(l[1]);
    }

    // walk 2: P = exp(s - m) / l in f32, to bf16 in registers, O += P v
    for (int t = 0; t < walked; ++t) {
      const unsigned char* st = scores(t);
      if (ROWS) {
        // whole rows: the exact row softmax of _mha_xla
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          m[hf] = quad_max(row_max(s, hf));
          float part = 0.0f;
#pragma unroll
          for (int jj = 0; jj < NK / 8; ++jj) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float e = expf(s[4 * jj + 2 * hf + u] - m[hf]);
              s[4 * jj + 2 * hf + u] = e;
              part += e;
            }
          }
          l[hf] = 1.0f / quad_sum(part);
        }
#pragma unroll
        for (int e = 0; e < NK / 2; ++e) s[e] = s[e] * l[(e >> 1) & 1];
      } else {
#pragma unroll
        for (int e = 0; e < NK / 2; ++e) s[e] = expf(s[e] - m[(e >> 1) & 1]) * l[(e >> 1) & 1];
      }
      uint32_t a[NK / 16][4];
      to_frags(s, a);
      fence_acc(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
        mma_d_rs<D>(o, a[kk], ndesc<D, NK>(st + S::KV + kk * 16 * Rows<D>::ROWB), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      mbar_arrive(&empty[j % STAGES], lane == 0);
      ++j;
    }
    mbar_arrive(&qempty[qb], lane == 0);
    store_rows<D>(out, o, x.n, x.h, qi0, c0, L, H, 1.0f);
  }
}

template <int D, bool CAUSAL, bool ROWS>
int launch_items(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                 const void* bias, void* out, int N, int L, int H, int n_heads,
                 cudaStream_t stream) {
  constexpr int smem = Smem<D>::BYTES;
  const cudaError_t err = bft::allow_smem<mha_fwd_wg<D, CAUSAL, ROWS>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 1 / sqrt(D) rounded to f32, as the plain version's Python float
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const int n_items = (L + BM - 1) / BM * n_heads * N;
  const int cap = blocks_per_sm<D>() * bft::sm_count();
  mha_fwd_wg<D, CAUSAL, ROWS><<<n_items < cap ? n_items : cap, THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<const float*>(bias), static_cast<bf16*>(out), L, H, n_heads,
      n_items, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, int N,
           int L, int H, int n_heads, void* stream) {
  constexpr int NK = key_tile<D>(), BOX = Rows<D>::BOX;
  CUtensorMap mq, mk, mv;
  int e = bft::make_map_bf16_box(&mq, q, N, L, H, H, BM, BOX);
  if (!e) e = bft::make_map_bf16_box(&mk, k, N, L, H, H, NK, BOX);
  if (!e) e = bft::make_map_bf16_box(&mv, v, N, L, H, H, NK, BOX);
  if (e) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // whole rows up to L = 128 at widths up to 128; D = 256 walks at every L
  if constexpr (D <= 128) {
    if (L <= BN)
      return launch_items<D, CAUSAL, true>(mq, mk, mv, bias, out, N, L, H, n_heads, st);
  }
  return launch_items<D, CAUSAL, false>(mq, mk, mv, bias, out, N, L, H, n_heads, st);
}

}  // namespace wg

template <int D>
int dispatch(const void* q, const void* k, const void* v, const void* bias, void* out,
             int N, int L, int H, int n_heads, int f32, int causal, void* stream) {
  if (f32)
    return causal ? launch<float, D, true>(q, k, v, bias, out, N, L, H, n_heads, stream)
                  : launch<float, D, false>(q, k, v, bias, out, N, L, H, n_heads, stream);
  return causal ? wg::launch<D, true>(q, k, v, bias, out, N, L, H, n_heads, stream)
                : wg::launch<D, false>(q, k, v, bias, out, N, L, H, n_heads, stream);
}

}  // namespace

// q / k / v / out (N, L, H) bf16 (f32 = 0) or f32 (f32 = 1), bias (N, L)
// f32, causal masking when causal = 1; H = n_heads * D with D = 32, 64, 128
// or 256; whole rows up to L = 128 (bf16, D <= 128) or 512 (f32; 256 at D =
// 256), key-tiled above (and at every L for bf16 at D = 256). Returns
// cudaGetLastError().
// Each of the widths 128 and 256 compiles in a translation unit of its own
// (mha_128.cu and mha_256.cu include this file with BFT_MHA_WIDTH
// defined), so that the build's parallel nvcc processes share the work;
// each unit instantiates only the templates its entry point dispatches to.
#define BFT_PASTE2(a, b) a##b
#define BFT_PASTE(a, b) BFT_PASTE2(a, b)
#ifdef BFT_MHA_WIDTH
extern "C" int BFT_PASTE(bft_mha_fwd_d, BFT_MHA_WIDTH)(
    const void* q, const void* k, const void* v, const void* bias,
    void* out, int N, int L, int H, int n_heads, int f32,
    int causal, void* stream) {
  return dispatch<BFT_MHA_WIDTH>(q, k, v, bias, out, N, L, H, n_heads, f32, causal, stream);
}
#else
extern "C" int bft_mha_fwd_d128(const void* q, const void* k, const void* v,
                                const void* bias, void* out, int N, int L, int H,
                                int n_heads, int f32, int causal, void* stream);
extern "C" int bft_mha_fwd_d256(const void* q, const void* k, const void* v,
                                const void* bias, void* out, int N, int L, int H,
                                int n_heads, int f32, int causal, void* stream);

extern "C" int bft_mha_fwd(const void* q, const void* k, const void* v,
                           const void* bias, void* out, int N, int L, int H,
                           int n_heads, int f32, int causal, void* stream) {
  if (N < 1 || L < 1 || n_heads < 1 || H % n_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (H / n_heads) {
    case 32:
      return dispatch<32>(q, k, v, bias, out, N, L, H, n_heads, f32, causal, stream);
    case 64:
      return dispatch<64>(q, k, v, bias, out, N, L, H, n_heads, f32, causal, stream);
    case 128:
      return bft_mha_fwd_d128(q, k, v, bias, out, N, L, H, n_heads, f32, causal, stream);
    case 256:
      return bft_mha_fwd_d256(q, k, v, bias, out, N, L, H, n_heads, f32, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif

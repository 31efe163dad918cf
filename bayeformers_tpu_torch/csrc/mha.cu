// mha_fwd: multi-head self-attention forward in the flat (N, L, H) layout.
//
// Replaces bayeformers_tpu/ops/attention.py::_fwd_kernel_stacked (Pallas #3),
// the head-grouped forward, and its per-head twin _fwd_kernel (Pallas #4),
// which computes the same function: the reference takes #4 where Pallas fits
// but no head group of 2 or more does (attention.py:321-330), which at the
// shapes this port serves means head width 32 at L around 1024. This kernel
// already runs one block per (query tile, head, example), so the instance
// that serves those shapes (the key-tiled one below, at D = 32) is #4's
// counterpart; the wrapper counts its launches there under #4's name.
// Same contract as #3: q/k/v/out (N, L, H) bf16 with head h in columns
// [h*D, (h+1)*D), an additive f32 key bias (N, L); scores = (q_h k_h^T) *
// scale + bias in f32, scale = 1 / sqrt(D) rounded to f32 and applied to the
// f32 scores after the product (attention.py:104), a row softmax in f32,
// then P cast to bf16 and O = P v_h with f32 accumulation. The head width D
// is a template parameter, instantiated at 32 and 64.
//
// Causal instances (CAUSAL = true, GPT-2): after the bias add and before the
// row max, score (i, j) with key j > query i becomes NEG_BIG = finfo(f32).min,
// a select as in the reference's jnp.where (attention.py:106-107), not an
// add: bias-masked and causal-masked scores then hold the same value, and a
// row with every key masked stays uniform over all L keys. No key tile above
// the diagonal is skipped: skipping them would make that row uniform over
// the causal prefix instead.
//
// Bound on the H100: at BERT's L = 128 the work is 4*N*L*L*H flops over
// 4*N*L*H*2 bytes, about 32 flops a byte, well below the ~295 at which the
// tensor cores rather than the memory would be the limit: the kernel should
// move each of q, k, v, out once. Design: one block of 4 warps per (query
// tile of 64 rows, head, example). Heads are sliced on-chip by stride, so no
// head-split transpose ever reaches device memory. Two designs:
//  * whole rows (L <= 512): the block keeps its whole score rows in shared
//    memory (64 x 512 f32 plus the bf16 P, 212 KB at most), so the softmax
//    is exact rather than online and the P v product needs no rescaling;
//  * key-tiled (L > 512): two walks over the key tiles of 64. The first
//    forms each tile's scores and carries the row max m and the row sum l
//    (the sum of exp(s - m) over the keys, rescaled by exp(m_old - m_new)
//    when a tile raises the max); the second forms the same scores again,
//    P = exp(s - m) / l, and accumulates P v. O is normalised once, as in
//    _mha_xla and #3; only the scalar sum is ever rescaled. Shared memory
//    no longer grows with L, so no length is refused.
// QK^T and PV run on the tensor cores through WMMA. All-masked rows (bias
// = finfo(f32).min everywhere) come out uniform over the keys, as in the
// plain version.
//
// Instances of one template over the operand type T, CAUSAL and D: bf16
// (above) and f32, where q, k, v and out are f32 and both products are true
// f32 (3xTF32, mma.cuh), as the reference's kernel takes its dot operands in
// the stored dtype (bayeformers_tpu/ops/attention.py:83-89). The softmax is
// f32 in both. In f32, P is the f32 score row itself, so it is written over
// the scores rather than into a separate tile: at L = 512 the block then needs
// 163 KB (a separate f32 P tile would need 293 KB, above the 227 KB a block
// can have); the bf16 instance keeps its layout (212 KB at L = 512).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

#include "mma.cuh"

using namespace nvcuda;
using bft::from_f32;

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 64;      // keys per staged block
constexpr int THREADS = 128; // 4 warps, 16 query rows each
constexpr int MAX_ROWS_L = 512;  // longest L of the whole-row design
constexpr int TSLD = BKV + 4;    // f32 leading dim of one key tile's scores
constexpr unsigned NEG_BIG_BITS = 0xff7fffffu;  // finfo(f32).min = -FLT_MAX

// q / k / v tiles in T, leading dim padded by 16 bytes; P in T over its own
// tile (bf16) or over the f32 score rows (f32).
template <typename T, int D>
struct Layout {
  static constexpr int QLD = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int OLD = D + 4;  // f32 leading dim of the output tile
  static constexpr int VEC = bft::Mma<T>::VEC;
  static constexpr bool P_OVER_S = sizeof(T) == 4;
  // the key-tiled design: one tile's P in T (bf16), over its scores in f32
  static constexpr int TPLD = P_OVER_S ? TSLD : BKV + 8;
  static constexpr size_t TILED_BYTES =
      2 * static_cast<size_t>(BQ) * QLD * sizeof(T) + static_cast<size_t>(BQ) * TSLD * 4 +
      (P_OVER_S ? 0 : static_cast<size_t>(BQ) * TPLD * sizeof(T)) + 2 * BQ * 4;
};

__host__ __device__ constexpr int round64(int l) { return (l + 63) / 64 * 64; }
__host__ __device__ constexpr int sld(int lk) { return lk + 4; }
__host__ __device__ constexpr int pld(int lk) { return lk + 8; }
template <typename T, int D>
__host__ __device__ constexpr size_t smem_bytes(int lk) {
  return 2 * static_cast<size_t>(BQ) * Layout<T, D>::QLD * sizeof(T) +
         static_cast<size_t>(BQ) * sld(lk) * 4 +
         (Layout<T, D>::P_OVER_S ? 0 : static_cast<size_t>(BQ) * pld(lk) * sizeof(T));
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
// unscaled in f32, into ``out`` (leading dim ld) at the warp's rows.
template <typename T, int D>
__device__ __forceinline__ void warp_scores(const T* qs, const T* kvs, float* out,
                                            int ld) {
  constexpr int QLD = Layout<T, D>::QLD, KD = bft::Mma<T>::KDEPTH;
  const int warp = threadIdx.x >> 5;
  bft::Acc<T> sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(sc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D; kk += KD) {
    bft::Operand<T, wmma::matrix_a, wmma::row_major> a;
    a.load(qs + warp * 16 * QLD + kk, QLD);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // k^T as a col-major (d, key) operand straight from the (key, d) tile
      bft::Operand<T, wmma::matrix_b, wmma::col_major> b;
      b.load(kvs + j * 16 * QLD + kk, QLD);
      bft::mma(sc[j], a, b);
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
// staged (64 keys, D) tile)
template <typename T, int D>
__device__ __forceinline__ void warp_pv(bft::Acc<T> (&o)[D / 16], const T* ps, int pld,
                                        const T* kvs) {
  constexpr int QLD = Layout<T, D>::QLD, KD = bft::Mma<T>::KDEPTH;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < BKV; kk += KD) {
    bft::Operand<T, wmma::matrix_a, wmma::row_major> a;
    a.load(ps + warp * 16 * pld + kk, pld);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      bft::Operand<T, wmma::matrix_b, wmma::row_major> b;
      b.load(kvs + kk * QLD + j * 16, QLD);
      bft::mma(o[j], a, b);
    }
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

// The whole-row design (L <= 512).
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ bias,
               T* __restrict__ out, int L, int H, float scale) {
  constexpr int QLD = Layout<T, D>::QLD;
  constexpr bool P_OVER_S = Layout<T, D>::P_OVER_S;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lk = round64(L);
  T* qs = reinterpret_cast<T*>(smem);
  T* kvs = qs + BQ * QLD;
  float* ss = reinterpret_cast<float*>(kvs + BKV * QLD);
  T* ps = P_OVER_S ? reinterpret_cast<T*>(ss)
                   : reinterpret_cast<T*>(ss + BQ * sld(lk));
  float* os = ss;  // the output tile reuses the score rows once P is used

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int SLD = sld(lk), PLD = P_OVER_S ? sld(lk) : pld(lk);

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

// The key-tiled design (L > 512): the same scores and softmax, walked one
// key tile of 64 at a time.
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
mha_fwd_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, int L, int H, float scale) {
  using Lay = Layout<T, D>;
  constexpr int QLD = Lay::QLD, TPLD = Lay::TPLD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* kvs = qs + BQ * QLD;
  float* ts = reinterpret_cast<float*>(kvs + BKV * QLD);  // one tile's scores
  T* tp = Lay::P_OVER_S ? reinterpret_cast<T*>(ts)
                        : reinterpret_cast<T*>(ts + BQ * TSLD);
  float* row_m = reinterpret_cast<float*>(smem + Lay::TILED_BYTES) - 2 * BQ;
  float* row_l = row_m + BQ;
  float* os = ts;  // the output tile reuses the score tile at the end

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
  const bool tiled = L > MAX_ROWS_L;
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

template <int D>
int dispatch(const void* q, const void* k, const void* v, const void* bias, void* out,
             int N, int L, int H, int n_heads, int f32, int causal, void* stream) {
  if (f32)
    return causal ? launch<float, D, true>(q, k, v, bias, out, N, L, H, n_heads, stream)
                  : launch<float, D, false>(q, k, v, bias, out, N, L, H, n_heads, stream);
  return causal
             ? launch<__nv_bfloat16, D, true>(q, k, v, bias, out, N, L, H, n_heads, stream)
             : launch<__nv_bfloat16, D, false>(q, k, v, bias, out, N, L, H, n_heads, stream);
}

}  // namespace

// q / k / v / out (N, L, H) bf16 (f32 = 0) or f32 (f32 = 1), bias (N, L)
// f32, causal masking when causal = 1; H = n_heads * D with D = 32 or 64;
// L <= 512 takes the whole-row design, longer L the key-tiled one. Returns
// cudaGetLastError().
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
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

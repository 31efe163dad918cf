// mha_fwd: multi-head self-attention forward in the flat (N, L, H) layout.
//
// Replaces bayeformers_tpu/ops/attention.py::_fwd_kernel_stacked (Pallas #3),
// the head-grouped forward the TPU runs whenever a head group of 2 or more
// fits VMEM, which is every shape this port serves. Its per-head twin
// _fwd_kernel (#4) computes the same function; whether this kernel also
// stands for it is open until a measurement settles it (ROADMAP queue 2).
// Same contract as #3: q/k/v/out (N, L, H) bf16 with head h in columns
// [h*64, (h+1)*64), an additive f32 key bias (N, L); scores = (q_h k_h^T) /
// sqrt(64) + bias in f32, a row softmax in f32, then P cast to bf16 and
// O = P v_h with f32 accumulation.
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
// head-split transpose ever reaches device memory. The block keeps its whole
// score rows in shared memory (L <= 512: 64 x 512 f32 plus the bf16 P, 212 KB
// at most), so the softmax is exact rather than online and the P v product
// needs no rescaling; QK^T and PV run on the tensor cores through WMMA.
// All-masked rows (bias = finfo(f32).min everywhere) come out uniform over
// the keys, as in the plain version.
//
// Four instances of one template over the operand type T and CAUSAL: bf16
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

#include <cstdint>

#include "mma.cuh"

using namespace nvcuda;
using bft::from_f32;

namespace {

constexpr int D = 64;        // head width
constexpr int BQ = 64;       // query rows per block
constexpr int BKV = 64;      // keys per staged block
constexpr int THREADS = 128; // 4 warps, 16 query rows each
constexpr int OLD = D + 4;   // f32 leading dim of the output tile
constexpr int MAX_L = 512;
constexpr unsigned NEG_BIG_BITS = 0xff7fffffu;  // finfo(f32).min = -FLT_MAX

// q / k / v tiles in T, leading dim padded by 16 bytes; P in T over its own
// tile (bf16) or over the f32 score rows (f32).
template <typename T>
struct Layout {
  static constexpr int QLD = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int VEC = bft::Mma<T>::VEC;
  static constexpr bool P_OVER_S = sizeof(T) == 4;
};

__host__ __device__ constexpr int round64(int l) { return (l + 63) / 64 * 64; }
__host__ __device__ constexpr int sld(int lk) { return lk + 4; }
__host__ __device__ constexpr int pld(int lk) { return lk + 8; }
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int lk) {
  return 2 * static_cast<size_t>(BQ) * Layout<T>::QLD * sizeof(T) +
         static_cast<size_t>(BQ) * sld(lk) * 4 +
         (Layout<T>::P_OVER_S ? 0 : static_cast<size_t>(BQ) * pld(lk) * sizeof(T));
}

// Rows [row0, row0 + 64) of one head's (L, 64) slice into a (64, QLD) tile;
// rows >= L are zero.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, T* dst,
                                          int n, int h, int row0, int L, int H) {
  constexpr int VEC = Layout<T>::VEC, CPR = D / VEC, QLD = Layout<T>::QLD;
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

template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ bias,
               T* __restrict__ out, int L, int H) {
  constexpr int QLD = Layout<T>::QLD, KD = bft::Mma<T>::KDEPTH;
  constexpr bool P_OVER_S = Layout<T>::P_OVER_S;
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

  load_tile(q, qs, n, h, q0, L, H);

  // ---- scores: (64 query rows, lk keys) f32 ----
  for (int kb = 0; kb < lk; kb += BKV) {
    __syncthreads();
    load_tile(k, kvs, n, h, kb, L, H);
    __syncthreads();
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
      wmma::store_matrix_sync(ss + warp * 16 * SLD + kb + j * 16, sc[j], SLD,
                              wmma::mem_row_major);
  }
  __syncwarp();

  // ---- row softmax in f32; each warp owns its 16 rows ----
  const float scale = 0.125f;  // 1 / sqrt(64), exact
  const float* brow = bias + static_cast<size_t>(n) * L;
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float* srow = ss + r * SLD;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int c = lane; c < L; c += 32) {
      float s = __fadd_rn(__fmul_rn(srow[c], scale), brow[c]);
      if (CAUSAL && c > q0 + r) s = __int_as_float(NEG_BIG_BITS);
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
  bft::Acc<T> o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(o[j], 0.0f);
  for (int kb = 0; kb < lk; kb += BKV) {
    __syncthreads();
    load_tile(v, kvs, n, h, kb, L, H);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKV; kk += KD) {
      bft::Operand<T, wmma::matrix_a, wmma::row_major> a;
      a.load(ps + warp * 16 * PLD + kb + kk, PLD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bft::Operand<T, wmma::matrix_b, wmma::row_major> b;
        b.load(kvs + kk * QLD + j * 16, QLD);
        bft::mma(o[j], a, b);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j)
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

template <typename T, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int N, int L, int H, int n_heads, void* stream) {
  const size_t smem = smem_bytes<T>(round64(L));
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_kernel<T, CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + BQ - 1) / BQ, n_heads, N);
  mha_fwd_kernel<T, CAUSAL><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), L, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q / k / v / out (N, L, H) bf16 (f32 = 0) or f32 (f32 = 1), bias (N, L)
// f32, causal masking when causal = 1; H = n_heads * 64, L <= 512. Returns
// cudaGetLastError().
extern "C" int bft_mha_fwd(const void* q, const void* k, const void* v,
                           const void* bias, void* out, int N, int L, int H,
                           int n_heads, int f32, int causal, void* stream) {
  if (L < 1 || L > MAX_L || H != n_heads * D) return static_cast<int>(cudaErrorInvalidValue);
  if (f32)
    return causal ? launch<float, true>(q, k, v, bias, out, N, L, H, n_heads, stream)
                  : launch<float, false>(q, k, v, bias, out, N, L, H, n_heads, stream);
  return causal
             ? launch<__nv_bfloat16, true>(q, k, v, bias, out, N, L, H, n_heads, stream)
             : launch<__nv_bfloat16, false>(q, k, v, bias, out, N, L, H, n_heads, stream);
}

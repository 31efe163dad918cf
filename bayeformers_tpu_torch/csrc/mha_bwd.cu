// mha_bwd: multi-head self-attention backward in the flat (N, L, H) layout.
//
// Replaces bayeformers_tpu/ops/attention.py::_bwd_kernel. Same arithmetic:
// recompute the f32 scores s = (q_h k_h^T) / sqrt(64) + bias and their exact
// f32 softmax P; P goes to bf16 for dV = P^T g; dP = g v_h^T in f32;
// dS = P * (dP - rowsum(dP * P)) in f32, then bf16 for dQ = dS k_h / sqrt(64)
// and dK = dS^T q_h / sqrt(64); every product accumulates in f32. q, k, v,
// g and the outputs are bf16 (N, L, H) with head h in columns [h*64, h*64+64)
// and are read by stride, as mha_fwd reads them; bias is (N, L) f32.
//
// Bound on the H100: 10*N*L*L*H flops (five products) against 7*N*L*H*2
// bytes; at BERT's L = 128 the bytes bound it, so each operand should be read
// about once. Design: two passes, so that dK and dV, which sum over all
// query rows, need no atomics (the gradients are bit-reproducible).
//  1. A query-tile kernel (32 rows, one head, one example) keeps its whole
//     score rows and dP rows in shared memory (2 x 32 x 512 f32 at most,
//     which is why the tile has 32 rows: 64 would need 256 KB at L = 512),
//     forms the exact softmax, D = rowsum(dP * P) from the f32 P (not the
//     FlashAttention identity rowsum(g * O), which would read the bf16
//     forward output), dS, and dQ; it writes the row max, the row sum and D.
//  2. A key-tile kernel (64 keys) walks the query rows in tiles of 32,
//     recomputes the same scores and dP for its keys with the same
//     fragment products, rebuilds P = exp(s - max) / sum bit for bit from
//     pass 1's statistics, and accumulates dV and dK in registers.
// A fully masked row (bias finfo(f32).min everywhere) gives equal scores,
// hence a uniform P, as in the plain version; it stays finite.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int D = 64;         // head width
constexpr int BQ = 32;        // query rows per tile (both passes)
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int QLD = D + 8;    // bf16 leading dim of q / k / v / g tiles
constexpr int OLD = D + 4;    // f32 leading dim of 64-wide tiles
constexpr int MAX_L = 512;
constexpr float SCALE = 0.125f;  // 1 / sqrt(64), exact

__host__ __device__ constexpr int round64(int l) { return (l + 63) / 64 * 64; }
__host__ __device__ constexpr int sld(int lk) { return lk + 4; }
__host__ __device__ constexpr int dld(int lk) { return lk + 8; }
constexpr size_t TILES1_BYTES = static_cast<size_t>(2 * BQ + BKV) * QLD * 2;
__host__ __device__ constexpr size_t smem1_bytes(int lk) {
  return TILES1_BYTES + 2 * static_cast<size_t>(BQ) * sld(lk) * 4 +
         static_cast<size_t>(BQ) * dld(lk) * 2;
}
constexpr size_t SMEM2_BYTES = static_cast<size_t>(2 * BKV + 2 * BQ) * QLD * 2 +
                               2 * BQ * OLD * 4 + 2 * BQ * QLD * 2 + 3 * BQ * 4;

// Rows [row0, row0 + rows) of one head's (L, 64) slice into a (rows, QLD)
// tile; rows >= L are zero.
__device__ __forceinline__ void load_rows(const __nv_bfloat16* __restrict__ src,
                                          __nv_bfloat16* dst, int n, int h,
                                          int row0, int rows, int L, int H) {
  for (int q = threadIdx.x; q < rows * (D / 8); q += THREADS) {
    const int row = q >> 3, chunk = q & 7;
    const int l = row0 + row;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (l < L)
      v = *reinterpret_cast<const uint4*>(
          src + (static_cast<size_t>(n) * L + l) * H + h * D + chunk * 8);
    *reinterpret_cast<uint4*>(dst + row * QLD + chunk * 8) = v;
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

// (32 rows of a, 64 keys) = a_tile (32, 64) @ kv_tile (64 keys, 64)^T into
// f32 ``out`` (leading dim ld); warp w owns rows (w & 1) * 16 and keys
// (w >> 1) * 32 + {0, 16}. Both passes form the scores and dP this way, so
// an element's products and their order are the same in both.
__device__ __forceinline__ void rows_by_keys(const __nv_bfloat16* a_tile,
                                             const __nv_bfloat16* kv_tile,
                                             float* out, int ld) {
  const int warp = threadIdx.x >> 5, wr = warp & 1, wc = warp >> 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, a_tile + wr * 16 * QLD + kk, QLD);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // kv^T as a col-major (d, key) operand straight from the (key, d) tile
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(b, kv_tile + (wc * 32 + j * 16) * QLD + kk, QLD);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(out + wr * 16 * ld + wc * 32 + j * 16, acc[j], ld,
                            wmma::mem_row_major);
}

__device__ __forceinline__ float score(float acc, float bias) {
  return __fadd_rn(__fmul_rn(acc, SCALE), bias);
}

// Pass 1: one block per (query tile, head, example).
__global__ void __launch_bounds__(THREADS)
mha_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const float* __restrict__ bias,
                  const __nv_bfloat16* __restrict__ g,
                  __nv_bfloat16* __restrict__ dq, float* __restrict__ row_max,
                  float* __restrict__ row_sum, float* __restrict__ row_d, int L,
                  int H, int n_heads) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lk = round64(L), SLD = sld(lk), DLD = dld(lk);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* gs = qs + BQ * QLD;
  __nv_bfloat16* kvs = gs + BQ * QLD;
  float* ss = reinterpret_cast<float*>(smem + TILES1_BYTES);
  float* dps = ss + BQ * SLD;
  __nv_bfloat16* dsb = reinterpret_cast<__nv_bfloat16*>(dps + BQ * SLD);
  float* os = ss;  // the dQ tile reuses the score rows once dS exists

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_rows(q, qs, n, h, q0, BQ, L, H);
  load_rows(g, gs, n, h, q0, BQ, L, H);
  for (int kb = 0; kb < lk; kb += BKV) {
    __syncthreads();
    load_rows(k, kvs, n, h, kb, BKV, L, H);
    __syncthreads();
    rows_by_keys(qs, kvs, ss + kb, SLD);
    __syncthreads();
    load_rows(v, kvs, n, h, kb, BKV, L, H);
    __syncthreads();
    rows_by_keys(gs, kvs, dps + kb, SLD);
  }
  __syncthreads();

  // softmax, D and dS in f32; each warp owns 8 rows
  const float* brow = bias + static_cast<size_t>(n) * L;
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    float* srow = ss + r * SLD;
    const float* drow = dps + r * SLD;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int c = lane; c < L; c += 32) {
      const float s = score(srow[c], brow[c]);
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
    __nv_bfloat16* dsrow = dsb + r * DLD;
    for (int c = lane; c < lk; c += 32)
      dsrow[c] = __float2bfloat16(c < L ? srow[c] * (drow[c] - dsum) : 0.0f);
    if (lane == 0 && q0 + r < L) {
      const size_t i = (static_cast<size_t>(n) * n_heads + h) * L + q0 + r;
      row_max[i] = mx;
      row_sum[i] = sum;
      row_d[i] = dsum;
    }
  }

  // dQ = dS k_h, 32 rows x 64 columns; warp w: rows (w & 1) * 16, columns
  // (w >> 1) * 32 + {0, 16}
  const int wr = warp & 1, wc = warp >> 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[2];
  wmma::fill_fragment(o[0], 0.0f);
  wmma::fill_fragment(o[1], 0.0f);
  for (int kb = 0; kb < lk; kb += BKV) {
    __syncthreads();
    load_rows(k, kvs, n, h, kb, BKV, L, H);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKV; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, dsb + wr * 16 * DLD + kb + kk, DLD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, kvs + kk * QLD + wc * 32 + j * 16, QLD);
        wmma::mma_sync(o[j], a, b, o[j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(os + wr * 16 * OLD + wc * 32 + j * 16, o[j], OLD,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int row = i / D, col = i % D, l = q0 + row;
    if (l < L)
      dq[(static_cast<size_t>(n) * L + l) * H + h * D + col] =
          __float2bfloat16(os[row * OLD + col] * SCALE);
  }
}

// Pass 2: one block per (key tile, head, example).
__global__ void __launch_bounds__(THREADS)
mha_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ bias,
                   const __nv_bfloat16* __restrict__ g,
                   const float* __restrict__ row_max,
                   const float* __restrict__ row_sum,
                   const float* __restrict__ row_d,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                   int L, int H, int n_heads) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + BKV * QLD;
  __nv_bfloat16* qs = vs + BKV * QLD;
  __nv_bfloat16* gs = qs + BQ * QLD;
  float* ss = reinterpret_cast<float*>(gs + BQ * QLD);
  float* dps = ss + BQ * OLD;
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(dps + BQ * OLD);
  __nv_bfloat16* dsb = pb + BQ * QLD;
  float* st = reinterpret_cast<float*>(dsb + BQ * QLD);  // max, sum, D
  float* os = ss;  // (64 keys, OLD) output tile over ss and dps at the end

  const int key0 = blockIdx.x * BKV, h = blockIdx.y, n = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const size_t stat0 = (static_cast<size_t>(n) * n_heads + h) * L;
  const float* brow = bias + static_cast<size_t>(n) * L;

  load_rows(k, ks, n, h, key0, BKV, L, H);
  load_rows(v, vs, n, h, key0, BKV, L, H);
  // warp w owns keys [w * 16, w * 16 + 16) of dV and dK, all 64 columns
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dva[4], dka[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::fill_fragment(dva[j], 0.0f);
    wmma::fill_fragment(dka[j], 0.0f);
  }

  for (int qb = 0; qb < L; qb += BQ) {
    __syncthreads();
    load_rows(q, qs, n, h, qb, BQ, L, H);
    load_rows(g, gs, n, h, qb, BQ, L, H);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const bool ok = qb + i < L;
      st[i] = ok ? row_max[stat0 + qb + i] : 0.0f;
      st[BQ + i] = ok ? row_sum[stat0 + qb + i] : 1.0f;
      st[2 * BQ + i] = ok ? row_d[stat0 + qb + i] : 0.0f;
    }
    __syncthreads();
    rows_by_keys(qs, ks, ss, OLD);
    rows_by_keys(gs, vs, dps, OLD);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BKV; i += THREADS) {
      const int r = i / BKV, c = i % BKV;
      float p = 0.0f, ds = 0.0f;
      if (qb + r < L && key0 + c < L) {
        const float s = score(ss[r * OLD + c], brow[key0 + c]);
        p = expf(s - st[r]) / st[BQ + r];
        ds = p * (dps[r * OLD + c] - st[2 * BQ + r]);
      }
      pb[r * QLD + c] = __float2bfloat16(p);
      dsb[r * QLD + c] = __float2bfloat16(ds);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BQ; kk += 16) {
      // P^T and dS^T as col-major (key, query) operands from (query, key) tiles
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> ap, ads;
      wmma::load_matrix_sync(ap, pb + kk * QLD + warp * 16, QLD);
      wmma::load_matrix_sync(ads, dsb + kk * QLD + warp * 16, QLD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bg, bq;
        wmma::load_matrix_sync(bg, gs + kk * QLD + j * 16, QLD);
        wmma::load_matrix_sync(bq, qs + kk * QLD + j * 16, QLD);
        wmma::mma_sync(dva[j], ap, bg, dva[j]);
        wmma::mma_sync(dka[j], ads, bq, dka[j]);
      }
    }
  }

  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(os + warp * 16 * OLD + j * 16,
                              pass ? dka[j] : dva[j], OLD, wmma::mem_row_major);
    __syncthreads();
    __nv_bfloat16* out = pass ? dk : dv;
    const float mul = pass ? SCALE : 1.0f;
    for (int i = threadIdx.x; i < BKV * D; i += THREADS) {
      const int row = i / D, col = i % D, l = key0 + row;
      if (l < L)
        out[(static_cast<size_t>(n) * L + l) * H + h * D + col] =
            __float2bfloat16(os[row * OLD + col] * mul);
    }
  }
}

}  // namespace

// q / k / v / g / dq / dk / dv (N, L, H) bf16, bias (N, L) f32, stats
// (3, N, n_heads, L) f32 scratch; H = n_heads * 64, L <= 512. Returns
// cudaGetLastError().
extern "C" int bft_mha_bwd(const void* q, const void* k, const void* v,
                           const void* bias, const void* g, void* dq, void* dk,
                           void* dv, void* stats, int N, int L, int H,
                           int n_heads, void* stream) {
  if (N < 1 || L < 1 || L > MAX_L || H != n_heads * D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem1 = smem1_bytes(round64(L));
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mha_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM2_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t nhl = static_cast<size_t>(N) * n_heads * L;
  float* m = static_cast<float*>(stats);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const auto* bb = static_cast<const float*>(bias);
  mha_bwd_dq_kernel<<<dim3((L + BQ - 1) / BQ, n_heads, N), THREADS, smem1, st>>>(
      qb, kb, vb, bb, gb, static_cast<__nv_bfloat16*>(dq), m, m + nhl,
      m + 2 * nhl, L, H, n_heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_dkv_kernel<<<dim3((L + BKV - 1) / BKV, n_heads, N), THREADS,
                       SMEM2_BYTES, st>>>(
      qb, kb, vb, bb, gb, m, m + nhl, m + 2 * nhl,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), L, H,
      n_heads);
  return static_cast<int>(cudaGetLastError());
}

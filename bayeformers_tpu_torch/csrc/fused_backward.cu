// reduce_abuv_anti: the paired dmu/drho reduce of the antithetic Bayesian
// linear backward on Hopper, for the frozen-MOPED prior centred on mu.
//
// Replaces bayeformers_tpu/ops/fused_backward.py::_kernel_anti (mixture=None,
// want_u=False). For an interleaved antithetic batch (pair t = samples 2t,
// 2t+1; only the even member's weights are read, since w1 - mu = -(w0 - mu)):
//   p0 = x[2t]^T g[2t],  p1 = x[2t+1]^T g[2t+1]            (K, N), f32 acc
//   wc = float(W[2t]) - mu                                  (bf16 residual)
//   A += p0 + p1
//   B += (p0 - p1) * wc
//   V += (g_p[2t] + g_p[2t+1]) * wc * wc                   (once per pair)
// and the elementwise finalize (ops/fused_backward.py::finalize) turns A, B,
// V into dmu and drho.
//
// Bound on the H100: the 2*S*M*K*N flops of the S products over the bf16
// tensor rate (0.012 ms at 768x768, 0.049 ms at 768x3072, S=10, M=1024);
// x, g and the even half of W are a few times fewer bytes. No (S, K, N)
// product ever reaches device memory. Design: one block of 4 warps owns a
// (64, 64) tile of A, B and V for the whole reduction (no split over pairs
// or tokens, no atomics: the gradients are bit-reproducible). It walks the
// pairs, and inside a pair the tokens in steps of 32, through a two-stage
// shared-memory pipeline (cp.async for 16-byte-aligned rows, element loads
// otherwise). The contraction is over tokens, so x^T is the A operand: the
// token-major x tile loads as a col-major WMMA fragment. When a pair's
// contraction is done, both members' f32 products go through shared memory
// (WMMA fragment layouts are unspecified) and each thread folds its 32
// elements into A, B and V, which it holds in registers, reading W[2t] and
// mu for exactly those elements. ptxas gives it 255 registers and spills
// about 0.5 KB a thread; a version with 8 warps and 16 elements a thread
// did not spill but took 1.2-1.9x as long (more fragment loads per MMA).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int TK = 64;          // output rows (K) per block
constexpr int TN = 64;          // output columns (N) per block
constexpr int TM = 32;          // tokens per pipeline step
constexpr int THREADS = 128;    // 4 warps: 2 (K) x 2 (N), 32 x 32 outputs each
constexpr int XLD = TK + 8;     // bf16 leading dims of the token-major tiles
constexpr int GLD = TN + 8;
constexpr int PLD = TN + 4;     // f32 leading dim of the per-pair products
constexpr int X_STAGE = 2 * TM * XLD;  // bf16 elements, both pair members
constexpr int G_STAGE = 2 * TM * GLD;
constexpr int PIPE_BYTES = 2 * (X_STAGE + G_STAGE) * 2;
constexpr int SMEM_BYTES = PIPE_BYTES + 2 * TK * PLD * 4;
constexpr int PER_THREAD = TK * TN / THREADS;  // output elements per thread
constexpr int VEC_PER_THREAD = 2 * TM * (TK / 8) / THREADS;  // 16-byte copies

struct Tiles {
  const __nv_bfloat16* x;
  const __nv_bfloat16* g;
  int M, K, N, k0, n0;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

// Rows [m0, m0 + TM) of both pair members of a (S, M, C) operand, columns
// [c0, c0 + 64), into a (2, TM, ld) token-major tile; zero outside the
// matrix. ``vec``: 16-byte asynchronous copies (C % 8 == 0, 16-byte aligned
// base), completed by cp_async_commit_wait(); otherwise element loads.
__device__ __forceinline__ void load_tile(const __nv_bfloat16* src, int s0,
                                          int M, int C, int m0, int c0,
                                          __nv_bfloat16* dst, int ld, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < VEC_PER_THREAD; ++i) {
      const int q = threadIdx.x + i * THREADS;
      const int chunk = q & 7, row = (q >> 3) & (TM - 1), h = q >> 8;
      const int m = m0 + row, c = c0 + chunk * 8;
      const bool ok = m < M && c < C;
      cp_async16(dst + (h * TM + row) * ld + chunk * 8,
                 src + (ok ? (static_cast<size_t>(s0 + h) * M + m) * C + c : 0),
                 ok);
    }
  } else {
    for (int q = threadIdx.x; q < 2 * TM * 64; q += THREADS) {
      const int col = q & 63, row = (q >> 6) & (TM - 1), h = q >> 11;
      const int m = m0 + row, c = c0 + col;
      __nv_bfloat16 v = __float2bfloat16(0.0f);
      if (m < M && c < C) v = src[(static_cast<size_t>(s0 + h) * M + m) * C + c];
      dst[(h * TM + row) * ld + col] = v;
    }
  }
}

__device__ __forceinline__ void cp_async_commit_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS)
reduce_abuv_anti_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ g,
                        const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ mu,
                        const float* __restrict__ g_p,
                        float* __restrict__ a_out, float* __restrict__ b_out,
                        float* __restrict__ v_out, int S, int M, int K, int N,
                        int x_vec, int g_vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs_base = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* gs_base = xs_base + 2 * X_STAGE;
  float* ps = reinterpret_cast<float*>(smem + PIPE_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int warp_k = warp & 1, warp_n = warp >> 1;
  const Tiles tl{x, g, M, K, N, blockIdx.y * TK, blockIdx.x * TN};
  const int n_mc = (M + TM - 1) / TM;
  const int n_steps = (S / 2) * n_mc;
  const size_t KN = static_cast<size_t>(K) * N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[h][i][j], 0.0f);
  float a_acc[PER_THREAD], b_acc[PER_THREAD], v_acc[PER_THREAD];
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) a_acc[e] = b_acc[e] = v_acc[e] = 0.0f;

  // step s covers pair s / n_mc, tokens [(s % n_mc) * TM, + TM); the
  // 16-byte-copy operands of a step stream in while the previous step's
  // MMAs run, the element-load operands follow the MMAs
  auto load_step = [&](int s, int stage, bool vec_part) {
    const int s0 = 2 * (s / n_mc), m0 = (s % n_mc) * TM;
    if (bool(x_vec) == vec_part)
      load_tile(tl.x, s0, M, K, m0, tl.k0, xs_base + stage * X_STAGE, XLD, vec_part);
    if (bool(g_vec) == vec_part)
      load_tile(tl.g, s0, M, N, m0, tl.n0, gs_base + stage * G_STAGE, GLD, vec_part);
  };

  load_step(0, 0, true);
  load_step(0, 0, false);
  cp_async_commit_wait();
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < n_steps;
    // the other stage was read last in step s - 1, before its barrier
    if (more) load_step(s + 1, cur ^ 1, true);
    const __nv_bfloat16* xs = xs_base + cur * X_STAGE;
    const __nv_bfloat16* gs = gs_base + cur * G_STAGE;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int kk = 0; kk < TM; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)  // x^T: (k, token) read from the (token, k) tile
          wmma::load_matrix_sync(
              af[i], xs + (h * TM + kk) * XLD + warp_k * 32 + i * 16, XLD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(
              bf[j], gs + (h * TM + kk) * GLD + warp_n * 32 + j * 16, GLD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[h][i][j], af[i], bf[j], acc[h][i][j]);
      }
    }
    if (more) {
      load_step(s + 1, cur ^ 1, false);
      cp_async_commit_wait();
    }
    __syncthreads();

    if (s % n_mc == n_mc - 1) {
      // pair t's contraction is complete: fold p0, p1 into A, B, V
      const int t = s / n_mc;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::store_matrix_sync(
                ps + (h * TK + warp_k * 32 + i * 16) * PLD + warp_n * 32 + j * 16,
                acc[h][i][j], PLD, wmma::mem_row_major);
            wmma::fill_fragment(acc[h][i][j], 0.0f);
          }
      __syncthreads();
      const float gps = g_p[2 * t] + g_p[2 * t + 1];
      const __nv_bfloat16* w0 = w + static_cast<size_t>(2 * t) * KN;
#pragma unroll
      for (int e = 0; e < PER_THREAD; ++e) {
        const int idx = tid + e * THREADS;
        const int r = idx / TN, c = idx % TN;
        const int k = tl.k0 + r, n = tl.n0 + c;
        const float p0 = ps[r * PLD + c];
        const float p1 = ps[(TK + r) * PLD + c];
        float wc = 0.0f;
        if (k < K && n < N) {
          const size_t o = static_cast<size_t>(k) * N + n;
          wc = __bfloat162float(w0[o]) - mu[o];
        }
        a_acc[e] += p0 + p1;
        b_acc[e] += (p0 - p1) * wc;
        v_acc[e] += gps * wc * wc;
      }
      // ps is written again only after the next step's barrier
    }
  }

#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int idx = tid + e * THREADS;
    const int k = tl.k0 + idx / TN, n = tl.n0 + idx % TN;
    if (k < K && n < N) {
      const size_t o = static_cast<size_t>(k) * N + n;
      a_out[o] = a_acc[e];
      b_out[o] = b_acc[e];
      v_out[o] = v_acc[e];
    }
  }
}

}  // namespace

// x (S, M, K) bf16, g (S, M, N) bf16, w (S, K, N) bf16 (even members read),
// mu (K, N) f32, g_p (S,) f32 -> A, B, V (K, N) f32. x_vec / g_vec: the rows
// of x / g may be copied 16 bytes at a time (K / N a multiple of 8, base
// 16-byte aligned). Returns cudaGetLastError().
extern "C" int bft_reduce_abuv_anti(const void* x, const void* g, const void* w,
                                    const void* mu, const void* g_p, void* a,
                                    void* b, void* v, int S, int M, int K, int N,
                                    int x_vec, int g_vec, void* stream) {
  if (S < 2 || S % 2 || M < 1 || K < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      reduce_abuv_anti_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + TN - 1) / TN, (K + TK - 1) / TK);
  reduce_abuv_anti_kernel<<<grid, THREADS, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(mu),
      static_cast<const float*>(g_p), static_cast<float*>(a),
      static_cast<float*>(b), static_cast<float*>(v), S, M, K, N, x_vec, g_vec);
  return static_cast<int>(cudaGetLastError());
}

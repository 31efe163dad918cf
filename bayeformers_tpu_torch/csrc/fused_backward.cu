// reduce_abuv / reduce_abuv_anti: the dmu/drho reduce of the Bayesian
// linear backward on Hopper, under each prior of prior.cuh.
//
// Replaces bayeformers_tpu/ops/fused_backward.py::_kernel (independent
// samples) with bft_reduce_abuv and ::_kernel_anti (antithetic pairs) with
// bft_reduce_abuv_anti. Over S independent samples:
//   p = x[s]^T g[s],  wc = float(W[s]) - mu                (K, N), f32 acc
//   A += p,  B += p * wc
//   ON_MU (want_u=False):  V += g_p[s] * wc * wc
//   GAUSSIAN (want_u):     U += g_p[s] * wc,  V += g_p[s] * wc * wc
//   MIXTURE:               U += g_p[s] * score(w),  V += g_p[s] * score(w) * wc
// Over an interleaved antithetic batch (pair t = samples 2t, 2t+1; only the
// even member's weights are read, since w1 - mu = -(w0 - mu)):
//   p0 = x[2t]^T g[2t],  p1 = x[2t+1]^T g[2t+1],  wc = float(W[2t]) - mu
//   A += p0 + p1
//   B += (p0 - p1) * wc
//   ON_MU:     V += (g_p[2t] + g_p[2t+1]) * wc * wc        (once per pair)
//   GAUSSIAN:  U += (g_p[2t] - g_p[2t+1]) * wc,  V as ON_MU
//   MIXTURE:   s0 = score(mu + wc), s1 = score(mu - wc),
//              U += g_p[2t] s0 + g_p[2t+1] s1,  V += (g_p[2t] s0 - g_p[2t+1] s1) * wc
// with score the mixture's (prior.cuh), taken on the W the reduce is given
// (the saved residual, bf16 in bf16 runs, or the regenerated f32 W), and the
// elementwise finalize (ops/fused_backward.py::finalize) turns A, B, U, V
// into dmu and drho.
//
// The prior terms read only W, mu and g_p, once per sample (the Pallas
// kernels take them under i == 0). ON_MU folds V in with A and B when a
// sample's products are complete, as it always has; GAUSSIAN and MIXTURE
// fold only A and B there and take U and V in an epilogue after the last
// sample, over each sample's W tile again, in the registers that held A and
// B: a fourth accumulator of 32 elements a thread would not fit beside the
// three of the product loop (the f32 pair instance already spills at 255).
//
// Three instances of one template over the types of x and g (TX) and of W
// (TW), as the reference feeds its reduce: (bf16, bf16) reads the bf16
// forward's W residual; (f32, f32) takes f32 activations with true f32
// products (3xTF32, mma.cuh) and their f32 residual or regenerated W; and
// (bf16, f32) is the regenerating backward at bf16, which, as the
// reference's _bwd_common (bayeformers_tpu/ops/fused_linear.py:1285-1288),
// hands the regenerated f32 W to the reduce. W enters only the f32 epilogue,
// (w - mu), so its type is a load, not another product path. The f32
// tiles double the pipeline's shared memory. The tensor cores add into
// their f32 accumulator without rounding to nearest: a sample's sum carried
// over all 1024 tokens in the accumulator drifted by 1.5e-5 of A's largest
// entry on the H100 (chip_smoke.py). So in f32 each step's products go
// through shared memory into a running sum (FADD) that each thread keeps
// for its own 32 elements, and no accumulator chain is longer than one step
// (32 or 64 tokens); 136 KB a block for a pair.
//
// Bound on the H100: the 2*S*M*K*N flops of the S products over the bf16
// tensor rate (0.012 ms at 768x768, 0.049 ms at 768x3072, S=10, M=1024);
// x, g and W are a few times fewer bytes (the independent reduce reads all
// S weight samples, twice the pair reduce's even half). No (S, K, N)
// product ever reaches device memory. Design: one template, H members per
// step (1: a sample, 2: a pair). One block of 4 warps owns a (64, 64) tile
// of A, B and V for the whole reduction (no split over samples or tokens,
// no atomics: the gradients are bit-reproducible). It walks the samples
// (pairs), and inside one the tokens in steps of 64 / H (a step holds 64
// token rows either way, so a sample's step does a pair's MMA work; with
// 32 tokens a sample took 1.6x the pair's time on an H100 80GB HBM3 at
// 700 W, chip_smoke.py), through a two-stage
// shared-memory pipeline (cp.async for 16-byte-aligned rows, element loads
// otherwise). The contraction is over tokens, so x^T is the A operand: the
// token-major x tile loads as a col-major WMMA fragment. When a sample's
// (pair's) contraction is done, its f32 products go through shared memory
// (WMMA fragment layouts are unspecified) and each thread folds its 32
// elements into A, B and V, which it holds in registers, reading W and mu
// for exactly those elements. For the pair, ptxas gives 255 registers and
// spills about 0.5 KB a thread; a version with 8 warps and 16 elements a
// thread did not spill but took 1.2-1.9x as long (more fragment loads per
// MMA).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "mma.cuh"
#include "prior.cuh"

using namespace nvcuda;
using bft::from_f32;
using bft::to_f32;

namespace {

constexpr int TK = 64;          // output rows (K) per block
constexpr int TN = 64;          // output columns (N) per block
constexpr int THREADS = 128;    // 4 warps: 2 (K) x 2 (N), 32 x 32 outputs each
constexpr int PLD = TN + 4;     // f32 leading dim of the per-pair products
constexpr int PER_THREAD = TK * TN / THREADS;  // output elements per thread

// Tiling of H members per step in operand type T: TM tokens of each, so
// that a step holds 64 token rows and the same MMA work for a sample as for
// a pair; two stages of their x and g tiles (leading dims padded by 16
// bytes), then their f32 products, and in f32 (PROMOTE, above) their
// running sums.
template <int H, typename T>
struct Smem {
  static constexpr bool PROMOTE = sizeof(T) == 4;
  static constexpr int TM = 64 / H;  // tokens per pipeline step
  static constexpr int LD = TK + 16 / static_cast<int>(sizeof(T));  // = TN + pad
  static constexpr int VEC = bft::Mma<T>::VEC;  // elements in a 16-byte copy
  static constexpr int X_STAGE = H * TM * LD;  // elements
  static constexpr int G_STAGE = H * TM * LD;
  static constexpr int PIPE_BYTES = 2 * (X_STAGE + G_STAGE) * static_cast<int>(sizeof(T));
  static constexpr int PS_BYTES = H * TK * PLD * 4;
  static constexpr int BYTES = PIPE_BYTES + (PROMOTE ? 2 : 1) * PS_BYTES;
  static constexpr int VEC_PER_THREAD = H * TM * (TK / VEC) / THREADS;  // 16-byte copies
};

template <typename T>
struct Tiles {
  const T* x;
  const T* g;
  int M, K, N, k0, n0;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

// Rows [m0, m0 + TM) of the H members s0 .. s0 + H - 1 of a (S, M, C)
// operand, columns [c0, c0 + 64), into a (H, TM, ld) token-major tile; zero
// outside the matrix. ``vec``: 16-byte asynchronous copies (rows of whole
// 16-byte chunks, 16-byte aligned base), completed by cp_async_commit_wait();
// otherwise element loads.
template <int H, typename T>
__device__ __forceinline__ void load_tile(const T* src, int s0, int M, int C,
                                          int m0, int c0, T* dst, int ld,
                                          bool vec) {
  constexpr int TM = Smem<H, T>::TM, VEC = Smem<H, T>::VEC;
  constexpr int CPR = 64 / VEC;  // 16-byte chunks per tile row
  if (vec) {
#pragma unroll
    for (int i = 0; i < Smem<H, T>::VEC_PER_THREAD; ++i) {
      const int q = threadIdx.x + i * THREADS;
      const int chunk = q % CPR, row = (q / CPR) & (TM - 1), h = q / (CPR * TM);
      const int m = m0 + row, c = c0 + chunk * VEC;
      const bool ok = m < M && c < C;
      cp_async16(dst + (h * TM + row) * ld + chunk * VEC,
                 src + (ok ? (static_cast<size_t>(s0 + h) * M + m) * C + c : 0),
                 ok);
    }
  } else {
    for (int q = threadIdx.x; q < H * TM * 64; q += THREADS) {
      const int col = q & 63, row = (q >> 6) & (TM - 1), h = q / (64 * TM);
      const int m = m0 + row, c = c0 + col;
      T v = from_f32<T>(0.0f);
      if (m < M && c < C) v = src[(static_cast<size_t>(s0 + h) * M + m) * C + c];
      dst[(h * TM + row) * ld + col] = v;
    }
  }
}

__device__ __forceinline__ void cp_async_commit_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// H members per step: step s covers samples H (s / n_mc) .. + H - 1.
template <int H, typename TX, typename TW, int PRIOR>
__global__ void __launch_bounds__(THREADS)
reduce_abuv_kernel(const TX* __restrict__ x,
                   const TX* __restrict__ g,
                   const TW* __restrict__ w,
                   const float* __restrict__ mu,
                   const float* __restrict__ g_p,
                   float* __restrict__ a_out, float* __restrict__ b_out,
                   float* __restrict__ u_out, float* __restrict__ v_out, int S,
                   int M, int K, int N, int x_vec, int g_vec, bft::Mixture mix) {
  static_assert(H == 1 || H == 2, "one sample or one antithetic pair per step");
  using S_ = Smem<H, TX>;
  constexpr int TM = S_::TM;
  constexpr int X_STAGE = S_::X_STAGE;
  constexpr int G_STAGE = S_::G_STAGE;
  constexpr int XLD = S_::LD, GLD = S_::LD;
  constexpr int KD = bft::Mma<TX>::KDEPTH;
  extern __shared__ __align__(128) unsigned char smem[];
  TX* xs_base = reinterpret_cast<TX*>(smem);
  TX* gs_base = xs_base + 2 * X_STAGE;
  float* ps = reinterpret_cast<float*>(smem + S_::PIPE_BYTES);
  // the sample's (pair's) products: ps itself, or (PROMOTE) their running sum
  float* run = reinterpret_cast<float*>(smem + S_::PIPE_BYTES +
                                        (S_::PROMOTE ? S_::PS_BYTES : 0));

  const int tid = threadIdx.x, warp = tid >> 5;
  const int warp_k = warp & 1, warp_n = warp >> 1;
  const Tiles<TX> tl{x, g, M, K, N, blockIdx.y * TK, blockIdx.x * TN};
  const int n_mc = (M + TM - 1) / TM;
  const int n_steps = (S / H) * n_mc;
  const size_t KN = static_cast<size_t>(K) * N;

  bft::Acc<TX> acc[H][2][2];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[h][i][j], 0.0f);
  float a_acc[PER_THREAD], b_acc[PER_THREAD], v_acc[PER_THREAD];
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) a_acc[e] = b_acc[e] = v_acc[e] = 0.0f;

  // step s covers member group s / n_mc, tokens [(s % n_mc) * TM, + TM);
  // the 16-byte-copy operands of a step stream in while the previous
  // step's MMAs run, the element-load operands follow the MMAs
  auto load_step = [&](int s, int stage, bool vec_part) {
    const int s0 = H * (s / n_mc), m0 = (s % n_mc) * TM;
    if (bool(x_vec) == vec_part)
      load_tile<H, TX>(tl.x, s0, M, K, m0, tl.k0, xs_base + stage * X_STAGE, XLD, vec_part);
    if (bool(g_vec) == vec_part)
      load_tile<H, TX>(tl.g, s0, M, N, m0, tl.n0, gs_base + stage * G_STAGE, GLD, vec_part);
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
    const TX* xs = xs_base + cur * X_STAGE;
    const TX* gs = gs_base + cur * G_STAGE;
#pragma unroll
    for (int h = 0; h < H; ++h) {
#pragma unroll
      for (int kk = 0; kk < TM; kk += KD) {
        bft::Operand<TX, wmma::matrix_a, wmma::col_major> af[2];
        bft::Operand<TX, wmma::matrix_b, wmma::row_major> bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)  // x^T: (k, token) read from the (token, k) tile
          af[i].load(xs + (h * TM + kk) * XLD + warp_k * 32 + i * 16, XLD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          bf[j].load(gs + (h * TM + kk) * GLD + warp_n * 32 + j * 16, GLD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            bft::mma(acc[h][i][j], af[i], bf[j]);
      }
    }
    if (more) {
      load_step(s + 1, cur ^ 1, false);
      cp_async_commit_wait();
    }
    __syncthreads();

    const bool last = s % n_mc == n_mc - 1;
    if (S_::PROMOTE || last) {
      // the products so far (PROMOTE: this step's) into ps
#pragma unroll
      for (int h = 0; h < H; ++h)
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
    }
    if (S_::PROMOTE) {
      // each thread adds its own elements of the step into the running sum
      const bool first = s % n_mc == 0;
#pragma unroll
      for (int e = 0; e < PER_THREAD; ++e) {
        const int idx = tid + e * THREADS;
        const int o = (idx / TN) * PLD + idx % TN;
#pragma unroll
        for (int h = 0; h < H; ++h)
          run[h * TK * PLD + o] =
              first ? ps[h * TK * PLD + o] : __fadd_rn(run[h * TK * PLD + o], ps[h * TK * PLD + o]);
      }
    }

    if (last) {
      // member group t's contraction is complete: fold its products into
      // A, B, V
      const int t = s / n_mc;
      const float gps = (H == 2) ? g_p[2 * t] + g_p[2 * t + 1] : g_p[t];
      const TW* w0 = w + static_cast<size_t>(H * t) * KN;
#pragma unroll
      for (int e = 0; e < PER_THREAD; ++e) {
        const int idx = tid + e * THREADS;
        const int r = idx / TN, c = idx % TN;
        const int k = tl.k0 + r, n = tl.n0 + c;
        float wc = 0.0f;
        if (k < K && n < N) {
          const size_t o = static_cast<size_t>(k) * N + n;
          wc = to_f32(w0[o]) - mu[o];
        }
        if (H == 2) {
          const float p0 = run[r * PLD + c];
          const float p1 = run[(TK + r) * PLD + c];
          a_acc[e] += p0 + p1;
          b_acc[e] += (p0 - p1) * wc;
        } else {
          const float p = run[r * PLD + c];
          a_acc[e] += p;
          b_acc[e] += p * wc;
        }
        if (PRIOR == bft::ON_MU) v_acc[e] += gps * wc * wc;
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
      if (PRIOR == bft::ON_MU) v_out[o] = v_acc[e];
    }
  }
  if (PRIOR == bft::ON_MU) return;

  // GAUSSIAN, MIXTURE: U and V over the samples (pairs) in order, each
  // thread on its own 32 elements of the tile (neighbouring threads on
  // neighbouring columns); A and B are dead, so these take their registers
  float u_e[PER_THREAD], v_e[PER_THREAD], mu_e[PER_THREAD];
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int idx = tid + e * THREADS;
    const int k = tl.k0 + idx / TN, n = tl.n0 + idx % TN;
    u_e[e] = v_e[e] = 0.0f;
    mu_e[e] = (k < K && n < N) ? mu[static_cast<size_t>(k) * N + n] : 0.0f;
  }
  for (int t = 0; t < S / H; ++t) {
    const TW* w0 = w + static_cast<size_t>(H * t) * KN;
    const float gp0 = g_p[H * t], gp1 = (H == 2) ? g_p[H * t + 1] : 0.0f;
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      const int idx = tid + e * THREADS;
      const int k = tl.k0 + idx / TN, n = tl.n0 + idx % TN;
      if (k >= K || n >= N) continue;
      const float wv = to_f32(w0[static_cast<size_t>(k) * N + n]);
      const float wc = wv - mu_e[e];
      if (PRIOR == bft::GAUSSIAN) {
        u_e[e] += (H == 2 ? gp0 - gp1 : gp0) * wc;
        v_e[e] += (H == 2 ? gp0 + gp1 : gp0) * wc * wc;
      } else if (H == 2) {
        const float s0 = gp0 * bft::mixture_score(mu_e[e] + wc, mix);
        const float s1 = gp1 * bft::mixture_score(mu_e[e] - wc, mix);
        u_e[e] += s0 + s1;
        v_e[e] += (s0 - s1) * wc;
      } else {
        const float s0 = gp0 * bft::mixture_score(wv, mix);
        u_e[e] += s0;
        v_e[e] += s0 * wc;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int idx = tid + e * THREADS;
    const int k = tl.k0 + idx / TN, n = tl.n0 + idx % TN;
    if (k < K && n < N) {
      const size_t o = static_cast<size_t>(k) * N + n;
      u_out[o] = u_e[e];
      v_out[o] = v_e[e];
    }
  }
}

template <int H, typename TX, typename TW, int PRIOR>
int launch(const void* x, const void* g, const void* w, const void* mu,
           const void* g_p, void* a, void* b, void* u, void* v, int S, int M,
           int K, int N, int x_vec, int g_vec, bft::Mixture mix, void* stream) {
  if (S < H || S % H || M < 1 || K < 1 || N < 1 ||
      (PRIOR != bft::ON_MU && u == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int BYTES = Smem<H, TX>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      reduce_abuv_kernel<H, TX, TW, PRIOR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + TN - 1) / TN, (K + TK - 1) / TK);
  reduce_abuv_kernel<H, TX, TW, PRIOR><<<grid, THREADS, BYTES,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(g),
      static_cast<const TW*>(w), static_cast<const float*>(mu),
      static_cast<const float*>(g_p), static_cast<float*>(a),
      static_cast<float*>(b), static_cast<float*>(u), static_cast<float*>(v), S,
      M, K, N, x_vec, g_vec, mix);
  return static_cast<int>(cudaGetLastError());
}

template <int H, int PRIOR>
int launch_by_types(int x_f32, int w_f32, const void* x, const void* g,
                    const void* w, const void* mu, const void* g_p, void* a,
                    void* b, void* u, void* v, int S, int M, int K, int N,
                    int x_vec, int g_vec, bft::Mixture mix, void* stream) {
  using bf16 = __nv_bfloat16;
  if (x_f32 && w_f32)
    return launch<H, float, float, PRIOR>(x, g, w, mu, g_p, a, b, u, v, S, M, K,
                                          N, x_vec, g_vec, mix, stream);
  if (x_f32) return static_cast<int>(cudaErrorInvalidValue);
  if (w_f32)
    return launch<H, bf16, float, PRIOR>(x, g, w, mu, g_p, a, b, u, v, S, M, K,
                                         N, x_vec, g_vec, mix, stream);
  return launch<H, bf16, bf16, PRIOR>(x, g, w, mu, g_p, a, b, u, v, S, M, K, N,
                                      x_vec, g_vec, mix, stream);
}

// The instance of (x's type, W's type, prior): (bf16, bf16), (f32, f32) or
// (bf16, f32); f32 x with bf16 W is refused.
template <int H>
int launch_by_type(int x_f32, int w_f32, int prior, const void* x, const void* g,
                   const void* w, const void* mu, const void* g_p, void* a,
                   void* b, void* u, void* v, int S, int M, int K, int N,
                   int x_vec, int g_vec, bft::Mixture mix, void* stream) {
  switch (prior) {
    case bft::ON_MU:
      return launch_by_types<H, bft::ON_MU>(x_f32, w_f32, x, g, w, mu, g_p, a, b,
                                            u, v, S, M, K, N, x_vec, g_vec, mix,
                                            stream);
    case bft::GAUSSIAN:
      return launch_by_types<H, bft::GAUSSIAN>(x_f32, w_f32, x, g, w, mu, g_p, a,
                                               b, u, v, S, M, K, N, x_vec, g_vec,
                                               mix, stream);
    case bft::MIXTURE:
      return launch_by_types<H, bft::MIXTURE>(x_f32, w_f32, x, g, w, mu, g_p, a,
                                              b, u, v, S, M, K, N, x_vec, g_vec,
                                              mix, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (S, M, K) and g (S, M, N) bf16 (x_f32 = 0) or f32 (x_f32 = 1), w (S, K,
// N) bf16 (w_f32 = 0) or f32 (w_f32 = 1; the antithetic reduce reads the
// even members only), mu (K, N) f32, g_p (S,) f32 -> A, B, V (K, N) f32 and,
// for prior GAUSSIAN (1) or MIXTURE (2), U (K, N) f32 (u may be null under
// ON_MU, 0); mix_*: the mixture's terms (prior.cuh::Mixture). x_vec / g_vec:
// the rows of x / g may be copied 16 bytes at a time (whole 16-byte chunks,
// base 16-byte aligned). Each returns cudaGetLastError().
extern "C" int bft_reduce_abuv(const void* x, const void* g, const void* w,
                               const void* mu, const void* g_p, void* a,
                               void* b, void* u, void* v, int S, int M, int K,
                               int N, int x_vec, int g_vec, int x_f32,
                               int w_f32, int prior, float mix_c1, float mix_c2,
                               float mix_inv_s1, float mix_inv_s2, void* stream) {
  return launch_by_type<1>(x_f32, w_f32, prior, x, g, w, mu, g_p, a, b, u, v, S,
                           M, K, N, x_vec, g_vec,
                           bft::Mixture{mix_c1, mix_c2, mix_inv_s1, mix_inv_s2},
                           stream);
}

extern "C" int bft_reduce_abuv_anti(const void* x, const void* g, const void* w,
                                    const void* mu, const void* g_p, void* a,
                                    void* b, void* u, void* v, int S, int M,
                                    int K, int N, int x_vec, int g_vec, int x_f32,
                                    int w_f32, int prior, float mix_c1,
                                    float mix_c2, float mix_inv_s1,
                                    float mix_inv_s2, void* stream) {
  return launch_by_type<2>(x_f32, w_f32, prior, x, g, w, mu, g_p, a, b, u, v, S,
                           M, K, N, x_vec, g_vec,
                           bft::Mixture{mix_c1, mix_c2, mix_inv_s1, mix_inv_s2},
                           stream);
}

// The draw pass: the sampled weights W of a set of draws from their seeds,
// and the forward's log-prob partial sums.
//
// Replaces bayeformers_tpu/ops/fused_linear.py::_fullk_regen_kernel
// (_pallas_fullk_regen), which the reference's non-saved VJPs (_bwd,
// _bwd_anti via _regen / _regen_anti) and sampled_weights call, and
// bayeformers_tpu/ops/sampled_linear.py::_regen_kernel
// (pallas_regenerate_weights), which the split ops' VJPs (sampled_dense's,
// sampled_logprobs') call: on the TPU the two differ by their eps streams
// (unit_eps against the VMEM-tiled tile_eps); the port's split ops draw from
// the one unit stream, so one kernel serves both (bft_regen), S independent
// draws of any mu (flipout's perturbation passes mu = 0). It is also the
// first stage of the Bayesian linear forward (bft_draw; bayes_linear.cu has
// the second, the product y[s] = x[s] @ W[s]), which on the TPU draws
// inside its matmul kernels (fused_linear.py::_kernel, ::_anti_kernel,
// ::_ktall_kernel, ::_ktall_anti_kernel; sampled_linear.py::_fused_kernel).
// For draw t with seed seeds[t]:
//   w0[k, n] = mu[k, n] + softplus(rho[k, n]) * eps_t[k, n]         (f32)
// on the absolute-unit stream of eps.cuh, with the product and the sum each
// rounded on its own (bft::sample_w): for the same seeds the result equals,
// bit for bit, the plain stream's W (ops/fused_linear.py::sample_weights).
// bft_regen can also write a bf16 copy of W in the same pass (flipout's VJP
// takes dx on it and hands the f32 W to the reduce, fused_backward.cu).
// Independent draws (H = 1) write W[t] = w0; antithetic pairs (H = 2) write
// W[2t] = w0 and W[2t + 1] = 2 mu - w0, rounded as the plain version
// rounds it. W is written in the forward's operand type T (bf16 or f32),
// rows ``ldw`` elements apart (the product's loads want 16-byte rows). No
// unit offsets: a (K, N) weight is one whole layer.
//
// Log-probs (PRIOR, prior.cuh; NONE writes none): per (draw, column tile of
// 64, row group of 8 unit rows) the sums of -eps^2 / 2 and of the log-prior
// terms of each member that has its own (both of a pair under a prior not
// centred on mu), taken at the f32 w, and per (column tile, row group) the
// sum of log sigma; each a fixed-order block sum. draw_finalize sums them in
// a fixed order (row groups in order within a column tile, then the tiles
// in order) and writes the per-tile sums and log_q / log_p: no float
// atomics, so the log-probs are bit-reproducible for a seed.
//
// Bound on the H100: the writes. At K = 3072, N = 768, five pairs in bf16
// (the FFN down-projection of the bf16 recipe) it writes 23.6 MB and reads
// mu and rho once (18.9 MB): 0.0127 ms at 3.35 TB/s. The draw itself is ALU
// work (Philox4x32-10, one log, sqrt, sin and cos per two normals), done
// once per weight element: the forward kernels before this pass redrew W in
// every row tile of their product (4 to 8 times at M = 1024). Design: one
// thread per (unit row r < 128, column pair): it owns rows r and r + 128 of
// its unit, which share their Box-Muller pairs (eps.cuh), and columns c and
// c + 1, which share one Philox call, so every normal is drawn once. It
// reads its four mu and rho once, forms the four sigmas once and walks the
// draws, writing four weights per draw and member (paired stores where the
// rows allow). A block of 256 threads covers 8 unit rows (16 weight rows)
// of one column tile of 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "eps.cuh"
#include "mma.cuh"
#include "prior.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE_N = 64;                 // columns of a block (32 pairs)
constexpr int GROUP_ROWS = THREADS / 32;   // unit rows of a block
constexpr int GROUPS_PER_UNIT = bft::UNIT_K / 2 / GROUP_ROWS;

// Log-prob partials per (draw, column tile, row group): log_q, then one
// log_p per member that has its own (a pair under a prior not centred on mu).
template <int H, int PRIOR>
struct LogP {
  static constexpr int N_LP = (H == 2 && PRIOR != bft::ON_MU) ? 2 : 1;
  static constexpr int N_PART = 1 + N_LP;
};

__device__ __forceinline__ float block_sum_fixed(float v, float* red) {
  // fixed-order block reduction: warp tree, then the warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < THREADS / 32; ++i) s += red[i];
  }
  return s;  // valid in thread 0
}

// Two neighbouring weights of one row (columns n, n + 1; ``both``: n + 1 is
// in the matrix), paired where the row's alignment allows.
template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b, bool both, bool paired) {
  if (paired && both) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(dst) = make_float2(a, b);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
    }
  } else {
    dst[0] = bft::from_f32<T>(a);
    if (both) dst[1] = bft::from_f32<T>(b);
  }
}

// H members per draw: draw t (seed seeds[t]) writes W[H t .. H t + H - 1];
// LO: also a bf16 copy of each W, w_lo, rows ldw apart (bft_regen's second
// output).
template <int H, typename T, int PRIOR, bool LO = false>
__global__ void __launch_bounds__(THREADS)
draw_kernel(const float* __restrict__ mu, const float* __restrict__ rho,
            const int32_t* __restrict__ seeds, const float* __restrict__ prior_mu,
            T* __restrict__ w, float* __restrict__ partials,
            float* __restrict__ ls_part, int n_draws, int K, int N, int ldw,
            float inv_sigma_p, bft::Mixture mix, __nv_bfloat16* __restrict__ w_lo = nullptr) {
  constexpr int N_PART = LogP<H, PRIOR>::N_PART;
  constexpr bool LP = PRIOR != bft::NONE;
  __shared__ float red[THREADS / 32];
  const int half = bft::UNIT_K / 2;
  const int tile_n = blockIdx.x, group = blockIdx.y;
  const int u = group / GROUPS_PER_UNIT;
  const int rr = (group % GROUPS_PER_UNIT) * GROUP_ROWS + (threadIdx.x >> 5);
  const int c = tile_n * TILE_N + 2 * (threadIdx.x & 31);
  const int krow[2] = {u * bft::UNIT_K + rr, u * bft::UNIT_K + rr + half};
  const uint32_t strip = static_cast<uint32_t>(c / bft::UNIT_N);
  const bool paired = (ldw % 2 == 0);  // 2-element-aligned pairs of columns
  const int n_groups = gridDim.y, n_tiles = gridDim.x;

  // element e: row krow[e >> 1], column c + (e & 1), as unit_normals4 orders
  // its outputs {cos(r, c), cos(r, c + 1), sin(r, c), sin(r, c + 1)}
  float m[4], sig[4], pm[4];
  bool ok[4];
  float ls = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = krow[e >> 1], n = c + (e & 1);
    ok[e] = k < K && n < N;
    m[e] = sig[e] = pm[e] = 0.0f;
    if (ok[e]) {
      const size_t idx = static_cast<size_t>(k) * N + n;
      m[e] = mu[idx];
      sig[e] = bft::softplus(rho[idx]);
      if (PRIOR == bft::GAUSSIAN) pm[e] = prior_mu[idx];
      if (LP) ls += logf(sig[e]);
    }
  }
  if (LP && ls_part != nullptr) {
    const float s = block_sum_fixed(ls, red);
    if (threadIdx.x == 0) ls_part[static_cast<size_t>(tile_n) * n_groups + group] = s;
  }
  const size_t KN = static_cast<size_t>(K) * ldw;
  for (int t = 0; t < n_draws; ++t) {
    float z[4];
    bft::unit_normals4(static_cast<uint32_t>(seeds[t]), static_cast<uint32_t>(u), strip,
                       rr, c % bft::UNIT_N, z);
    float w0[4], w1[4];
    float q = 0.0f, p0 = 0.0f, p1 = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float se = __fmul_rn(sig[e], z[e]);
      w0[e] = __fadd_rn(m[e], se);  // bft::sample_w, keeping se for log_p
      w1[e] = __fsub_rn(__fmul_rn(2.0f, m[e]), w0[e]);  // 2 mu - w0, as the plain version
      if (LP && ok[e]) {
        q += -0.5f * z[e] * z[e];
        if (PRIOR == bft::ON_MU) {
          const float zs = se * inv_sigma_p;
          p0 += -0.5f * zs * zs;
        } else if (PRIOR == bft::GAUSSIAN) {
          const float d0 = (w0[e] - pm[e]) * inv_sigma_p;
          p0 += -0.5f * d0 * d0;
          if (H == 2) {
            const float d1 = (w1[e] - pm[e]) * inv_sigma_p;
            p1 += -0.5f * d1 * d1;
          }
        } else {
          p0 += bft::mixture_log_pdf(w0[e], mix);
          if (H == 2) p1 += bft::mixture_log_pdf(w1[e], mix);
        }
      }
    }
    // rows: {cos row, sin row}; z order {cos c, cos c+1, sin c, sin c+1}
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = krow[r];
      if (k >= K || c >= N) continue;
      const bool both = c + 1 < N;
      T* dst = w + static_cast<size_t>(H) * t * KN + static_cast<size_t>(k) * ldw + c;
      store2(dst, w0[2 * r], w0[2 * r + 1], both, paired);
      if (H == 2) store2(dst + KN, w1[2 * r], w1[2 * r + 1], both, paired);
      if constexpr (LO) store2(w_lo + (dst - w), w0[2 * r], w0[2 * r + 1], both, paired);
    }
    if (LP && partials != nullptr) {
      float* part = partials + ((static_cast<size_t>(t) * n_tiles + tile_n) * n_groups + group) * N_PART;
      const float qs = block_sum_fixed(q, red);
      if (threadIdx.x == 0) part[0] = qs;
      const float ps = block_sum_fixed(p0, red);
      if (threadIdx.x == 0) part[1] = ps;
      if (N_PART == 3) {
        const float p1s = block_sum_fixed(p1, red);
        if (threadIdx.x == 0) part[2] = p1s;
      }
    }
  }
}

// One block per draw. Each thread sums a column tile's row groups in order
// into the per-tile partials (tile_part, n_part each) and the tile's log
// sigma; thread 0 then sums the tiles in order and writes log_q / log_p of
// the draw's members (a pair shares log_q, and log_p too when the draw has
// one, N_LP = 1). Dynamic shared memory: n_tiles * (N_PART + 1) floats.
template <int H, int N_LP>
__global__ void draw_finalize_kernel(const float* __restrict__ partials,
                                     const float* __restrict__ ls_part,
                                     float* __restrict__ tile_part, int n_tiles,
                                     int n_groups, float c_q, float c_p,
                                     float* __restrict__ logq, float* __restrict__ logp) {
  constexpr int N_PART = 1 + N_LP;
  extern __shared__ float tile_sums[];
  const int t = blockIdx.x;
  float* tp = tile_part + static_cast<size_t>(t) * n_tiles * N_PART;
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
    const float* src = partials + (static_cast<size_t>(t) * n_tiles + i) * n_groups * N_PART;
    const float* ls = ls_part + static_cast<size_t>(i) * n_groups;
    float s[N_PART];
#pragma unroll
    for (int j = 0; j < N_PART; ++j) s[j] = 0.0f;
    float lt = 0.0f;
    for (int gidx = 0; gidx < n_groups; ++gidx) {
#pragma unroll
      for (int j = 0; j < N_PART; ++j) s[j] += src[gidx * N_PART + j];
      lt += ls[gidx];
    }
#pragma unroll
    for (int j = 0; j < N_PART; ++j) {
      tp[i * N_PART + j] = s[j];
      tile_sums[i * (N_PART + 1) + j] = s[j];
    }
    tile_sums[i * (N_PART + 1) + N_PART] = lt;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float ls = 0.0f, q = 0.0f, p[N_LP];
#pragma unroll
  for (int j = 0; j < N_LP; ++j) p[j] = 0.0f;
  for (int i = 0; i < n_tiles; ++i) {
    const float* ts = tile_sums + i * (N_PART + 1);
    ls += ts[N_PART];
    q += ts[0];
#pragma unroll
    for (int j = 0; j < N_LP; ++j) p[j] += ts[1 + j];
  }
  const float lq = q - ls - c_q;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    logq[H * t + h] = lq;
    logp[H * t + h] = p[N_LP == 1 ? 0 : h] - c_p;
  }
}

dim3 draw_grid(int K, int N) {
  const int ku = (K + bft::UNIT_K - 1) / bft::UNIT_K;
  return dim3((N + TILE_N - 1) / TILE_N, ku * GROUPS_PER_UNIT);
}

template <int H, typename T, int PRIOR>
int launch_draw(const void* mu, const void* rho, const void* seeds, const void* prior_mu,
                void* w, void* partials, void* ls_part, int n_draws, int K, int N,
                int ldw, float inv_sigma_p, bft::Mixture mix, cudaStream_t st) {
  if (PRIOR == bft::GAUSSIAN && prior_mu == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  draw_kernel<H, T, PRIOR><<<draw_grid(K, N), THREADS, 0, st>>>(
      static_cast<const float*>(mu), static_cast<const float*>(rho),
      static_cast<const int32_t*>(seeds), static_cast<const float*>(prior_mu),
      static_cast<T*>(w), static_cast<float*>(partials), static_cast<float*>(ls_part),
      n_draws, K, N, ldw, inv_sigma_p, mix);
  return static_cast<int>(cudaGetLastError());
}

template <int H, typename T>
int launch_draw_prior(int prior, const void* mu, const void* rho, const void* seeds,
                      const void* prior_mu, void* w, void* partials, void* ls_part,
                      int n_draws, int K, int N, int ldw, float inv_sigma_p,
                      bft::Mixture mix, cudaStream_t st) {
#define BFT_DRAW(P)                                                                   \
  return launch_draw<H, T, P>(mu, rho, seeds, prior_mu, w, partials, ls_part, n_draws, \
                              K, N, ldw, inv_sigma_p, mix, st)
  switch (prior) {
    case bft::ON_MU: BFT_DRAW(bft::ON_MU);
    case bft::GAUSSIAN: BFT_DRAW(bft::GAUSSIAN);
    case bft::MIXTURE: BFT_DRAW(bft::MIXTURE);
    case bft::NONE: BFT_DRAW(bft::NONE);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BFT_DRAW
}

}  // namespace

// mu / rho (K, N) f32, seeds (S,) i32 -> w (S, K, N) f32, the draws of
// seeds on the unit stream, and, when w_lo is not null, the same W rounded
// to bf16 into w_lo (S, K, N) in the same pass (flipout's VJP takes dx = g
// W^T on it). Returns cudaGetLastError().
extern "C" int bft_regen(const void* mu, const void* rho, const void* seeds,
                         void* w, void* w_lo, int S, int K, int N, void* stream) {
  if (S < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bft::Mixture none{0.0f, 0.0f, 0.0f, 0.0f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_lo == nullptr)
    return launch_draw<1, float, bft::NONE>(mu, rho, seeds, nullptr, w, nullptr, nullptr,
                                            S, K, N, N, 0.0f, none, st);
  draw_kernel<1, float, bft::NONE, true><<<draw_grid(K, N), THREADS, 0, st>>>(
      static_cast<const float*>(mu), static_cast<const float*>(rho),
      static_cast<const int32_t*>(seeds), nullptr, static_cast<float*>(w), nullptr, nullptr,
      S, K, N, N, 0.0f, none, static_cast<__nv_bfloat16*>(w_lo));
  return static_cast<int>(cudaGetLastError());
}

// The forward's draw pass: mu / rho (K, N) f32, seeds (n_draws,) i32 and,
// for prior GAUSSIAN, prior_mu (K, N) f32 -> w (H n_draws, K, ldw) in bf16
// (w_f32 = 0) or f32, H = 2 for antithetic pairs (W[2t], W[2t+1] = 2 mu -
// W[2t]) or 1, and for prior ON_MU (0), GAUSSIAN (1) or MIXTURE (2) the
// partial sums (n_draws, ceil(N/64), n_groups, n_part) f32 (n_part 3 for a
// pair under GAUSSIAN or MIXTURE, else 2; n_groups = ceil(K/256) * 16) and,
// when ls_part is not null, the log-sigma sums (ceil(N/64), n_groups);
// prior NONE (3) writes W only. inv_sigma_p = 1 / softplus(1); mix_*: the
// mixture's terms (prior.cuh::Mixture). Returns cudaGetLastError().
extern "C" int bft_draw(const void* mu, const void* rho, const void* seeds,
                        const void* prior_mu, void* w, void* partials, void* ls_part,
                        int n_draws, int K, int N, int ldw, int pair, int w_f32,
                        int prior, float inv_sigma_p, float mix_c1, float mix_c2,
                        float mix_inv_s1, float mix_inv_s2, void* stream) {
  if (n_draws < 1 || K < 1 || N < 1 || ldw < N) return static_cast<int>(cudaErrorInvalidValue);
  const bft::Mixture mix{mix_c1, mix_c2, mix_inv_s1, mix_inv_s2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define BFT_ARGS                                                                    \
  prior, mu, rho, seeds, prior_mu, w, partials, ls_part, n_draws, K, N, ldw, inv_sigma_p, \
      mix, st
  if (pair) {
    if (w_f32) return launch_draw_prior<2, float>(BFT_ARGS);
    return launch_draw_prior<2, bf16>(BFT_ARGS);
  }
  if (w_f32) return launch_draw_prior<1, float>(BFT_ARGS);
  return launch_draw_prior<1, bf16>(BFT_ARGS);
#undef BFT_ARGS
}

// Sums bft_draw's partials in a fixed order: tile_part (n_draws,
// ceil(N/64), n_part) the per-tile sums, logq / logp (H n_draws,) f32 with
// the constants c_q = K N log sqrt(2 pi) and c_p (K N (log sqrt(2 pi) + log
// sigma_p) under the Gaussian priors, 0 under the mixture). n_lp: 2 for a
// pair under GAUSSIAN or MIXTURE, else 1. Returns cudaGetLastError().
extern "C" int bft_draw_finalize(const void* partials, const void* ls_part, void* tile_part,
                                 void* logq, void* logp, int n_draws, int K, int N,
                                 int pair, int n_lp, float c_q, float c_p, void* stream) {
  const dim3 g = draw_grid(K, N);
  const int n_tiles = static_cast<int>(g.x), n_groups = static_cast<int>(g.y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(partials);
  const float* ls = static_cast<const float*>(ls_part);
  float* tp = static_cast<float*>(tile_part);
  float* lq = static_cast<float*>(logq);
  float* lp = static_cast<float*>(logp);
  const int threads = n_tiles < 256 ? ((n_tiles + 31) / 32) * 32 : 256;
  const size_t shm = static_cast<size_t>(n_tiles) * (n_lp + 2) * sizeof(float);
  if (pair && n_lp == 2) {
    draw_finalize_kernel<2, 2><<<n_draws, threads, shm, st>>>(pa, ls, tp, n_tiles, n_groups,
                                                              c_q, c_p, lq, lp);
  } else if (pair) {
    draw_finalize_kernel<2, 1><<<n_draws, threads, shm, st>>>(pa, ls, tp, n_tiles, n_groups,
                                                              c_q, c_p, lq, lp);
  } else {
    draw_finalize_kernel<1, 1><<<n_draws, threads, shm, st>>>(pa, ls, tp, n_tiles, n_groups,
                                                              c_q, c_p, lq, lp);
  }
  return static_cast<int>(cudaGetLastError());
}

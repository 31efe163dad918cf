// logprob: the per-draw log-probs of sampled weights, the split op's KL
// terms, and their VJP, each for a whole group of weights in one launch.
//
// Replaces bayeformers_tpu/ops/logprob.py::_logprob_kernel
// (_pallas_logprobs) behind the port's sampled_logprobs_grouped (and
// sampled_logprobs, a group of one), and the W that the reference's VJPs
// (_mixture_bwd, _gaussian_bwd) rebuild through
// sampled_linear.py::_regen_kernel (Pallas #13). For leaf l, draw s with
// seed seeds_l[s], over every element of its (K, N) weight:
//   w = mu + softplus(rho) * eps_s      (eps_s: the unit stream of eps.cuh)
//   log_q[l, s] = sum(-eps^2 / 2) - sum(log sigma) - K N log sqrt(2 pi)
//   log_p[l, s] = sum(-((w - prior_mu) / sigma_p)^2 / 2)
//                 - K N (log sqrt(2 pi) + log sigma_p)             (GAUSSIAN)
//               = sum(mixture_log_pdf(w))                          (MIXTURE)
// w is rounded as bft::sample_w rounds it, so it equals, bit for bit, the W
// that regen.cu and the forward kernels draw for the same seed. The VJP,
// given the cotangents g_q, g_p (n_leaves, S), writes per element
//   dmu  = sum_s g_p[s] score(w_s)
//   drho = (sum_s g_p[s] score(w_s) eps_s - sum_s g_q[s] / sigma) sigmoid(rho)
// with score the mixture's (prior.cuh) or -(w - prior_mu) / sigma_p^2, and
// eps_s the drawn normal itself; no W reaches device memory.
//
// Bound on the H100: the forward reads mu and rho (and prior_mu under the
// Gaussian) once, 684 MB for BERT-base's 74 leaves, 0.20 ms at 3.35 TB/s;
// the VJP also writes dmu and drho, 1.37 GB, 0.41 ms. The work is
// transcendental: per element and draw a quarter of a Philox4x32-10 call,
// half a Box-Muller pair (log, sqrt, sin, cos) and, under the mixture, a
// logaddexp (the VJP: the score's exp and logaddexp); per element, softplus
// and log sigma (the VJP: sigmoid). Which of the two bounds holds is read
// from the compiled kernel's MUFU count (chip_smoke.py).
//
// Design. The TPU kernel walks one leaf's (BK, BN) tiles in a sequential
// grid, carrying its sums in SMEM, one call a leaf; here one launch covers
// every leaf of the group. A leaf table (a __grid_constant__ parameter:
// pointers, K, N, the leaf's first block and block count) maps each block
// to its leaf; a block covers QUADS * THREADS quads of one leaf, a quad being
// the four elements of one Philox call (rows r and r + 128 of a unit, which
// share their Box-Muller pairs, and columns c and c + 1), neighbouring
// threads on neighbouring column pairs so that mu and rho load coalesced.
// Each thread reads its mu and rho once, takes softplus and log sigma once
// per element, and draws every draw in registers (SC draws at a time, the
// template's chunk), carrying SC sums of -eps^2/2 and of the log-prior
// terms. Each block writes its per-draw sums and its sum of log sigma
// (fixed-order block sums); the last block of a leaf to arrive (a
// __threadfence and a per-leaf atomic ticket, which it resets) sums the
// leaf's partials in a fixed order and writes log_q and log_p with the
// constants. No float atomics: reruns are bit-equal.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "eps.cuh"
#include "prior.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QUADS = 8;  // quads a thread
constexpr int BLOCK_QUADS = QUADS * THREADS;
constexpr int MAX_DRAWS = 1024;
constexpr double LOG_SQRT_2PI = 0.91893853320467274178;

// One leaf of the group (ops/logprob.py::leaf_table packs it): 56 bytes.
struct Leaf {
  const float* mu;
  const float* rho;
  const float* prior_mu;  // GAUSSIAN only
  const int32_t* seeds;   // (S,)
  long long offset;       // the leaf's first element in the VJP's flat dmu / drho
  int K, N;
  int first_block, n_blocks;
};
static_assert(sizeof(Leaf) == 56, "ops/logprob.py::leaf_table packs 7 int64 a leaf");

// The leaf table as a kernel parameter: CAP leaves (kernel parameters may
// take 32764 bytes from CUDA 12.1 on).
template <int CAP>
struct Table {
  Leaf leaf[CAP];
};
constexpr int CAP_SMALL = 128, CAP_LARGE = 576;
static_assert(sizeof(Table<CAP_LARGE>) + 128 <= 32764, "kernel parameter limit");

// Per-leaf tickets of the forward's last-block finalize; the last block of
// a leaf resets its own. Grouped forwards on one device must not overlap
// (the port launches them on the current stream).
__device__ unsigned int g_ticket[CAP_LARGE];

template <int CAP>
__device__ __forceinline__ int leaf_of_block(const Table<CAP>& t, int n_leaves, int b) {
  int lo = 0, hi = n_leaves - 1;  // the last leaf whose first block is <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].first_block <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Fixed-order block sums of G values a thread: a warp tree, then the warps
// in order. Thread j < G returns the block's sum of value j.
template <int G>
__device__ __forceinline__ float block_sums(float (&v)[G], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[j] += __shfl_down_sync(0xffffffffu, v[j], o);
  }
  __syncthreads();  // red free from any earlier use
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j) red[j * WARPS + warp] = v[j];
  }
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < G) {
    for (int w = 0; w < WARPS; ++w) s += red[threadIdx.x * WARPS + w];
  }
  return s;
}

// A quad's place in its leaf: quad i of the order (unit row chunk u, row rr
// of the cos half, column pair cp); the rows and columns of its elements.
struct Quad {
  int u, rr, c;
};

// (a leaf's quads number below 2^31: ops/logprob.py checks it)
__device__ __forceinline__ Quad quad_at(int i, int np) {
  const int half = bft::UNIT_K / 2;
  Quad q;
  const int row = i / np;
  q.c = 2 * (i - row * np);
  q.rr = row % half;
  q.u = row / half;
  return q;
}

__device__ __forceinline__ long long leaf_quads(int K, int N) {
  return static_cast<long long>((K + bft::UNIT_K - 1) / bft::UNIT_K) * (bft::UNIT_K / 2) *
         ((N + 1) / 2);
}

// element e of a quad: row (rr | rr + 128) of unit u, column c + (e & 1), in
// unit_normals4's order {cos c, cos c + 1, sin c, sin c + 1}
__device__ __forceinline__ int elem_row(const Quad& q, int e) {
  return q.u * bft::UNIT_K + q.rr + (e >> 1) * (bft::UNIT_K / 2);
}

// partials: (2 S + 1, total_blocks) f32, quantity-major: rows s < S the
// per-block sums of -eps^2 / 2 of draw s, rows S + s those of log_p's terms,
// row 2 S the sums of log sigma.
template <int PRIOR, int SC, int CAP>
__global__ void __launch_bounds__(THREADS)
logprob_kernel(const __grid_constant__ Table<CAP> t, int n_leaves, int S, int total_blocks,
               float* __restrict__ partials, float* __restrict__ logq,
               float* __restrict__ logp, float inv_sigma_p, double c_p_unit,
               bft::Mixture mix) {
  static_assert(PRIOR == bft::GAUSSIAN || PRIOR == bft::MIXTURE,
                "the split op's priors: Gaussian on prior_mu, or the mixture");
  constexpr int G = 2 * SC + 1;
  __shared__ float red[G * WARPS];
  __shared__ float res[2 * MAX_DRAWS + 1];
  __shared__ bool last;
  const int b = blockIdx.x;
  const int l = leaf_of_block(t, n_leaves, b);
  const Leaf& lf = t.leaf[l];
  const int K = lf.K, N = lf.N, np = (N + 1) / 2;
  const long long total = leaf_quads(K, N);
  const long long base = static_cast<long long>(b - lf.first_block) * BLOCK_QUADS;

  for (int c0 = 0; c0 < S; c0 += SC) {
    uint32_t seed[SC];
#pragma unroll
    for (int d = 0; d < SC; ++d)
      seed[d] = c0 + d < S ? static_cast<uint32_t>(lf.seeds[c0 + d]) : 0u;
    float v[G];
#pragma unroll
    for (int j = 0; j < G; ++j) v[j] = 0.0f;
#pragma unroll 1  // one copy of the quad body (the MUFU count of chip_smoke.py)
    for (int j = 0; j < QUADS; ++j) {
      const long long i = base + static_cast<long long>(j) * THREADS + threadIdx.x;
      if (i >= total) break;
      const Quad qd = quad_at(static_cast<int>(i), np);
      float m[4], sig[4], pm[4];
      bool ok[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = elem_row(qd, e), n = qd.c + (e & 1);
        ok[e] = k < K && n < N;
        m[e] = sig[e] = pm[e] = 0.0f;
        if (ok[e]) {
          const size_t idx = static_cast<size_t>(k) * N + n;
          m[e] = lf.mu[idx];
          sig[e] = bft::softplus(lf.rho[idx]);
          if (PRIOR == bft::GAUSSIAN) pm[e] = lf.prior_mu[idx];
          if (c0 == 0) v[2 * SC] += logf(sig[e]);
        }
      }
#pragma unroll
      for (int d = 0; d < SC; ++d) {
        if (c0 + d >= S) break;
        float z[4];
        bft::unit_normals4(seed[d], static_cast<uint32_t>(qd.u),
                           static_cast<uint32_t>(qd.c / bft::UNIT_N), qd.rr,
                           qd.c % bft::UNIT_N, z);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!ok[e]) continue;
          const float w = bft::sample_w(m[e], sig[e], z[e]);
          v[d] += -0.5f * z[e] * z[e];
          if (PRIOR == bft::GAUSSIAN) {
            const float dd = (w - pm[e]) * inv_sigma_p;
            v[SC + d] += -0.5f * dd * dd;
          } else {
            v[SC + d] += bft::mixture_log_pdf(w, mix);
          }
        }
      }
    }
    const float s = block_sums<G>(v, red);
    const int j = threadIdx.x;
    if (j < SC && c0 + j < S) {
      partials[static_cast<size_t>(c0 + j) * total_blocks + b] = s;
    } else if (j >= SC && j < 2 * SC && c0 + j - SC < S) {
      partials[static_cast<size_t>(S + c0 + j - SC) * total_blocks + b] = s;
    } else if (j == 2 * SC && c0 == 0) {
      partials[static_cast<size_t>(2 * S) * total_blocks + b] = s;
    }
  }

  // the leaf's last block to arrive sums the leaf's partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int ticket = atomicAdd(&g_ticket[l], 1u);
    last = ticket == static_cast<unsigned int>(lf.n_blocks - 1);
    if (last) g_ticket[l] = 0u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n_part = 2 * S + 1;
  for (int q0 = 0; q0 < n_part; q0 += G) {
    float v[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      v[j] = 0.0f;
      if (q0 + j >= n_part) continue;
      const float* row = partials + static_cast<size_t>(q0 + j) * total_blocks + lf.first_block;
      for (int i = threadIdx.x; i < lf.n_blocks; i += THREADS) v[j] += __ldcg(row + i);
    }
    const float s = block_sums<G>(v, red);
    if (threadIdx.x < G && q0 + threadIdx.x < n_part) res[q0 + threadIdx.x] = s;
  }
  __syncthreads();
  const double kn = static_cast<double>(K) * N;
  const float c_q = static_cast<float>(kn * LOG_SQRT_2PI);
  const float c_p = static_cast<float>(kn * c_p_unit);
  for (int s = threadIdx.x; s < S; s += THREADS) {
    logq[static_cast<size_t>(l) * S + s] = res[s] - res[2 * S] - c_q;
    logp[static_cast<size_t>(l) * S + s] = res[S + s] - c_p;
  }
}

// The VJP: per element, the S draws regenerated in registers; dmu and drho
// written to the leaf's slice (its offset) of the flat outputs.
template <int PRIOR, int SC, int CAP>
__global__ void __launch_bounds__(THREADS)
logprob_vjp_kernel(const __grid_constant__ Table<CAP> t, int n_leaves, int S,
                   const float* __restrict__ g_q, const float* __restrict__ g_p,
                   float* __restrict__ dmu, float* __restrict__ drho, float sigma_p2,
                   bft::Mixture mix) {
  static_assert(PRIOR == bft::GAUSSIAN || PRIOR == bft::MIXTURE,
                "the split op's priors: Gaussian on prior_mu, or the mixture");
  const int b = blockIdx.x;
  const int l = leaf_of_block(t, n_leaves, b);
  const Leaf& lf = t.leaf[l];
  const int K = lf.K, N = lf.N, np = (N + 1) / 2;
  const long long total = leaf_quads(K, N);
  const long long base = static_cast<long long>(b - lf.first_block) * BLOCK_QUADS;
  const float* gq = g_q + static_cast<size_t>(l) * S;
  const float* gp = g_p + static_cast<size_t>(l) * S;
  float gq_sum = 0.0f;
  for (int s = 0; s < S; ++s) gq_sum += gq[s];
  float* out_mu = dmu + lf.offset;
  float* out_rho = drho + lf.offset;

#pragma unroll 1
  for (int j = 0; j < QUADS; ++j) {
    const long long i = base + static_cast<long long>(j) * THREADS + threadIdx.x;
    if (i >= total) break;
    const Quad qd = quad_at(static_cast<int>(i), np);
    float m[4], r[4], sig[4], pm[4], a_mu[4], a_rho[4];
    bool ok[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = elem_row(qd, e), n = qd.c + (e & 1);
      ok[e] = k < K && n < N;
      m[e] = r[e] = pm[e] = a_mu[e] = a_rho[e] = 0.0f;
      sig[e] = 1.0f;
      if (ok[e]) {
        const size_t idx = static_cast<size_t>(k) * N + n;
        m[e] = lf.mu[idx];
        r[e] = lf.rho[idx];
        sig[e] = bft::softplus(r[e]);
        if (PRIOR == bft::GAUSSIAN) pm[e] = lf.prior_mu[idx];
      }
    }
    for (int c0 = 0; c0 < S; c0 += SC) {
#pragma unroll
      for (int d = 0; d < SC; ++d) {
        if (c0 + d >= S) break;
        const float g = gp[c0 + d];
        float z[4];
        bft::unit_normals4(static_cast<uint32_t>(lf.seeds[c0 + d]),
                           static_cast<uint32_t>(qd.u),
                           static_cast<uint32_t>(qd.c / bft::UNIT_N), qd.rr,
                           qd.c % bft::UNIT_N, z);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float w = bft::sample_w(m[e], sig[e], z[e]);
          const float score = PRIOR == bft::GAUSSIAN ? -(w - pm[e]) / sigma_p2
                                                     : bft::mixture_score(w, mix);
          const float gs = g * score;
          a_mu[e] += gs;
          a_rho[e] += gs * z[e];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!ok[e]) continue;
      const size_t idx = static_cast<size_t>(elem_row(qd, e)) * N + qd.c + (e & 1);
      const float sigmoid = 1.0f / (1.0f + expf(-r[e]));
      out_mu[idx] = a_mu[e];
      out_rho[idx] = (a_rho[e] - gq_sum / sig[e]) * sigmoid;
    }
  }
}

template <int CAP>
bool fill_table(Table<CAP>* t, const void* host, int n_leaves) {
  if (n_leaves < 1 || n_leaves > CAP) return false;
  const Leaf* src = static_cast<const Leaf*>(host);
  for (int i = 0; i < n_leaves; ++i) t->leaf[i] = src[i];
  return true;
}

// The draws' chunk: 4 up to S = 4 (KL_DRAWS), else 8.
template <typename F>
int by_chunk(int S, F&& f) {
  if (S <= 4) return f(std::integral_constant<int, 4>());
  return f(std::integral_constant<int, 8>());
}

template <int CAP>
int launch_forward(const void* table, int n_leaves, int S, int total_blocks, int prior,
                   void* partials, void* logq, void* logp, float inv_sigma_p,
                   double c_p_unit, bft::Mixture mix, cudaStream_t st) {
  Table<CAP> t;
  if (!fill_table(&t, table, n_leaves)) return static_cast<int>(cudaErrorInvalidValue);
  float* pa = static_cast<float*>(partials);
  float* lq = static_cast<float*>(logq);
  float* lp = static_cast<float*>(logp);
  return by_chunk(S, [&](auto sc) {
    constexpr int SC = decltype(sc)::value;
    if (prior == bft::GAUSSIAN)
      logprob_kernel<bft::GAUSSIAN, SC, CAP><<<total_blocks, THREADS, 0, st>>>(
          t, n_leaves, S, total_blocks, pa, lq, lp, inv_sigma_p, c_p_unit, mix);
    else
      logprob_kernel<bft::MIXTURE, SC, CAP><<<total_blocks, THREADS, 0, st>>>(
          t, n_leaves, S, total_blocks, pa, lq, lp, inv_sigma_p, c_p_unit, mix);
    return static_cast<int>(cudaGetLastError());
  });
}

template <int CAP>
int launch_vjp(const void* table, int n_leaves, int S, int total_blocks, int prior,
               const void* g_q, const void* g_p, void* dmu, void* drho, float sigma_p2,
               bft::Mixture mix, cudaStream_t st) {
  Table<CAP> t;
  if (!fill_table(&t, table, n_leaves)) return static_cast<int>(cudaErrorInvalidValue);
  const float* gq = static_cast<const float*>(g_q);
  const float* gp = static_cast<const float*>(g_p);
  float* dm = static_cast<float*>(dmu);
  float* dr = static_cast<float*>(drho);
  return by_chunk(S, [&](auto sc) {
    constexpr int SC = decltype(sc)::value;
    if (prior == bft::GAUSSIAN)
      logprob_vjp_kernel<bft::GAUSSIAN, SC, CAP><<<total_blocks, THREADS, 0, st>>>(
          t, n_leaves, S, gq, gp, dm, dr, sigma_p2, mix);
    else
      logprob_vjp_kernel<bft::MIXTURE, SC, CAP><<<total_blocks, THREADS, 0, st>>>(
          t, n_leaves, S, gq, gp, dm, dr, sigma_p2, mix);
    return static_cast<int>(cudaGetLastError());
  });
}

bool valid(int n_leaves, int S, int total_blocks, int prior) {
  return n_leaves >= 1 && n_leaves <= CAP_LARGE && S >= 1 && S <= MAX_DRAWS &&
         total_blocks >= n_leaves && (prior == bft::GAUSSIAN || prior == bft::MIXTURE);
}

}  // namespace

// The grouped forward. table: n_leaves packed Leafs in host memory (mu, rho
// (K, N) f32, prior_mu (K, N) f32 under GAUSSIAN (1) else null, seeds (S,)
// i32; leaf l owns blocks [first_block, first_block + n_blocks), n_blocks =
// ceil(ceil(K / 256) * 128 * ceil(N / 2) / 2048), the leaves' ranges in
// order and together [0, total_blocks)). prior: GAUSSIAN 1 or MIXTURE 2.
// partials: (2 S + 1, total_blocks) f32 scratch; logq / logp: (n_leaves, S)
// f32. inv_sigma_p = 1 / sigma_p; c_p_unit = log sqrt(2 pi) + log sigma_p
// under the Gaussian, 0 under the mixture; mix_*: the mixture's terms
// (prior.cuh::Mixture). Returns cudaGetLastError().
extern "C" int bft_logprob(const void* table, int n_leaves, int S, int total_blocks,
                           int prior, void* partials, void* logq, void* logp,
                           float inv_sigma_p, double c_p_unit, float mix_c1, float mix_c2,
                           float mix_inv_s1, float mix_inv_s2, void* stream) {
  if (!valid(n_leaves, S, total_blocks, prior)) return static_cast<int>(cudaErrorInvalidValue);
  const bft::Mixture mix{mix_c1, mix_c2, mix_inv_s1, mix_inv_s2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_leaves <= CAP_SMALL)
    return launch_forward<CAP_SMALL>(table, n_leaves, S, total_blocks, prior, partials, logq,
                                     logp, inv_sigma_p, c_p_unit, mix, st);
  return launch_forward<CAP_LARGE>(table, n_leaves, S, total_blocks, prior, partials, logq,
                                   logp, inv_sigma_p, c_p_unit, mix, st);
}

// The grouped VJP over the same table (each Leaf's offset: its first element
// in dmu / drho): g_q, g_p (n_leaves, S) f32 -> dmu, drho (sum of K N) f32.
// sigma_p2 = sigma_p^2 (GAUSSIAN). Returns cudaGetLastError().
extern "C" int bft_logprob_vjp(const void* table, int n_leaves, int S, int total_blocks,
                               int prior, const void* g_q, const void* g_p, void* dmu,
                               void* drho, float sigma_p2, float mix_c1, float mix_c2,
                               float mix_inv_s1, float mix_inv_s2, void* stream) {
  if (!valid(n_leaves, S, total_blocks, prior)) return static_cast<int>(cudaErrorInvalidValue);
  const bft::Mixture mix{mix_c1, mix_c2, mix_inv_s1, mix_inv_s2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_leaves <= CAP_SMALL)
    return launch_vjp<CAP_SMALL>(table, n_leaves, S, total_blocks, prior, g_q, g_p, dmu, drho,
                                 sigma_p2, mix, st);
  return launch_vjp<CAP_LARGE>(table, n_leaves, S, total_blocks, prior, g_q, g_p, dmu, drho,
                               sigma_p2, mix, st);
}

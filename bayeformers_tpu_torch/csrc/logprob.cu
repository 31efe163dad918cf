// logprob: the per-draw log-probs of a sampled weight, the split op's KL
// terms.
//
// Replaces bayeformers_tpu/ops/logprob.py::_logprob_kernel
// (_pallas_logprobs), behind the port's sampled_logprobs. For draw s with
// seed seeds[s], over every element of a (K, N) weight:
//   w = mu + softplus(rho) * eps_s      (eps_s: the unit stream of eps.cuh)
//   log_q[s] = sum(-eps^2 / 2) - sum(log sigma) - K N log sqrt(2 pi)
//   log_p[s] = sum(-((w - prior_mu) / sigma_p)^2 / 2)
//              - K N (log sqrt(2 pi) + log sigma_p)                (GAUSSIAN)
//            = sum(mixture_log_pdf(w))                             (MIXTURE)
// w is rounded as bft::sample_w rounds it, so it equals, bit for bit, the W
// that regen.cu (the backward's W) and the forward kernels draw for the same
// seed. The TPU kernel draws per (BK, BN) VMEM tile and carries its sums in
// SMEM across its sequential grid; here blocks run in parallel, so each
// block writes one partial sum per draw (and, for draw 0, one of log sigma,
// which no draw changes) into a scratch, and a one-block finalize sums them
// in a fixed order with the constants: no float atomics, so the log-probs
// are bit-reproducible for a seed, as the forward's log-probs are.
//
// Bound on the H100: the bytes (mu and rho, and prior_mu under the Gaussian,
// read once; two floats a draw written): 18.9 MB at 768 x 3072, 5.6 us at
// 3.35 TB/s. The work is ALU: per element and draw, a quarter of a
// Philox4x32-10 call, half a Box-Muller pair, softplus and, under the
// mixture, its logaddexp. Design: one thread per QUADS quads, a quad being
// the four elements of one Philox call (rows r and r + 128 of a unit, which
// share their Box-Muller pairs, and columns c and c + 1); neighbouring
// threads take neighbouring column pairs, so the loads of mu and rho are
// coalesced. blockIdx.y is the draw: S draws re-read mu and rho (from L2 at
// these sizes) rather than hold S sums a thread.
#include <cuda_runtime.h>

#include <cstdint>

#include "eps.cuh"
#include "prior.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int QUADS = 8;  // quads a thread
constexpr int N_PART = 2;  // per (draw, block): sum -eps^2/2, sum of log_p's terms

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

template <int PRIOR>
__global__ void __launch_bounds__(THREADS)
logprob_kernel(const float* __restrict__ mu, const float* __restrict__ rho,
               const float* __restrict__ prior_mu, const int32_t* __restrict__ seeds,
               float* __restrict__ partials, float* __restrict__ ls_part, int K,
               int N, float inv_sigma_p, bft::Mixture mix) {
  static_assert(PRIOR == bft::GAUSSIAN || PRIOR == bft::MIXTURE,
                "the split op's priors: Gaussian on prior_mu, or the mixture");
  __shared__ float red[THREADS / 32];
  const int half = bft::UNIT_K / 2;
  const int np = (N + 1) / 2;
  const int ku = (K + bft::UNIT_K - 1) / bft::UNIT_K;
  const long long total = static_cast<long long>(ku) * half * np;
  const int s = blockIdx.y;
  const uint32_t seed = static_cast<uint32_t>(seeds[s]);
  float q = 0.0f, p = 0.0f, ls = 0.0f;
  for (int j = 0; j < QUADS; ++j) {
    const long long i =
        (static_cast<long long>(blockIdx.x) * QUADS + j) * THREADS + threadIdx.x;
    if (i >= total) break;
    const int cp = static_cast<int>(i % np);
    const int rr = static_cast<int>((i / np) % half);
    const int u = static_cast<int>(i / np / half);
    const int c = 2 * cp;
    float z[4];
    bft::unit_normals4(seed, static_cast<uint32_t>(u),
                       static_cast<uint32_t>(c / bft::UNIT_N), rr, c % bft::UNIT_N, z);
    // element e: row (rr | rr + 128) of unit u, column c + (e & 1), in
    // unit_normals4's order {cos c, cos c + 1, sin c, sin c + 1}
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = u * bft::UNIT_K + rr + (e >> 1) * half, n = c + (e & 1);
      if (k >= K || n >= N) continue;
      const size_t idx = static_cast<size_t>(k) * N + n;
      const float sig = bft::softplus(rho[idx]);
      const float w = bft::sample_w(mu[idx], sig, z[e]);
      q += -0.5f * z[e] * z[e];
      if (PRIOR == bft::GAUSSIAN) {
        const float d = (w - prior_mu[idx]) * inv_sigma_p;
        p += -0.5f * d * d;
      } else {
        p += bft::mixture_log_pdf(w, mix);
      }
      if (s == 0) ls += logf(sig);
    }
  }
  float* part = partials + (static_cast<size_t>(s) * gridDim.x + blockIdx.x) * N_PART;
  const float q_sum = block_sum_fixed(q, red);
  if (threadIdx.x == 0) part[0] = q_sum;
  const float p_sum = block_sum_fixed(p, red);
  if (threadIdx.x == 0) part[1] = p_sum;
  if (s == 0) {
    const float l_sum = block_sum_fixed(ls, red);
    if (threadIdx.x == 0) ls_part[blockIdx.x] = l_sum;
  }
}

// One thread per draw; every sum runs over the blocks in order.
__global__ void logprob_finalize(const float* __restrict__ partials,
                                 const float* __restrict__ ls_part, int n_blocks,
                                 int n_draws, float c_q, float c_p,
                                 float* __restrict__ logq, float* __restrict__ logp) {
  const int t = threadIdx.x;
  if (t >= n_draws) return;
  float ls = 0.0f, q = 0.0f, p = 0.0f;
  for (int i = 0; i < n_blocks; ++i) {
    ls += ls_part[i];
    q += partials[(static_cast<size_t>(t) * n_blocks + i) * N_PART];
    p += partials[(static_cast<size_t>(t) * n_blocks + i) * N_PART + 1];
  }
  logq[t] = q - ls - c_q;
  logp[t] = p - c_p;
}

template <int PRIOR>
int launch(const void* mu, const void* rho, const void* prior_mu, const void* seeds,
           void* partials, void* ls_part, void* logq, void* logp, int S, int K, int N,
           float inv_sigma_p, float c_q, float c_p, bft::Mixture mix, void* stream) {
  const long long total = static_cast<long long>((K + bft::UNIT_K - 1) / bft::UNIT_K) *
                          (bft::UNIT_K / 2) * ((N + 1) / 2);
  const int n_blocks = static_cast<int>((total + QUADS * THREADS - 1) / (QUADS * THREADS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  logprob_kernel<PRIOR><<<dim3(n_blocks, S), THREADS, 0, st>>>(
      static_cast<const float*>(mu), static_cast<const float*>(rho),
      static_cast<const float*>(prior_mu), static_cast<const int32_t*>(seeds),
      static_cast<float*>(partials), static_cast<float*>(ls_part), K, N, inv_sigma_p,
      mix);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  logprob_finalize<<<1, ((S + 31) / 32) * 32, 0, st>>>(
      static_cast<const float*>(partials), static_cast<const float*>(ls_part), n_blocks,
      S, c_q, c_p, static_cast<float*>(logq), static_cast<float*>(logp));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mu / rho (K, N) f32, prior_mu (K, N) f32 for prior = GAUSSIAN (1, else
// unread, may be null), seeds (S,) i32, S <= 1024 -> logq / logp (S,) f32.
// prior: GAUSSIAN 1 or MIXTURE 2 (prior.cuh). partials / ls_part: scratch of
// (S, n_blocks, 2) and (n_blocks,) floats, n_blocks = ceil(ceil(K / 256) *
// 128 * ceil(N / 2) / (QUADS * THREADS)). inv_sigma_p = 1 / sigma_p;
// c_q = K N log sqrt(2 pi); c_p = K N (log sqrt(2 pi) + log sigma_p) under
// the Gaussian, 0 under the mixture; mix_*: the mixture's terms
// (prior.cuh::Mixture). Returns cudaGetLastError().
extern "C" int bft_logprob(const void* mu, const void* rho, const void* prior_mu,
                           const void* seeds, void* partials, void* ls_part, void* logq,
                           void* logp, int S, int K, int N, int prior, float inv_sigma_p,
                           float c_q, float c_p, float mix_c1, float mix_c2,
                           float mix_inv_s1, float mix_inv_s2, void* stream) {
  if (S < 1 || S > 1024 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bft::Mixture mix{mix_c1, mix_c2, mix_inv_s1, mix_inv_s2};
  if (prior == bft::GAUSSIAN) {
    if (prior_mu == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch<bft::GAUSSIAN>(mu, rho, prior_mu, seeds, partials, ls_part, logq, logp,
                                 S, K, N, inv_sigma_p, c_q, c_p, mix, stream);
  }
  if (prior == bft::MIXTURE)
    return launch<bft::MIXTURE>(mu, rho, prior_mu, seeds, partials, ls_part, logq, logp,
                                S, K, N, inv_sigma_p, c_q, c_p, mix, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

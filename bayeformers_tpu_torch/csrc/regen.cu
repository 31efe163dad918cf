// regen: rebuild the sampled weights W of a set of draws from their seeds.
//
// Replaces bayeformers_tpu/ops/fused_linear.py::_fullk_regen_kernel
// (_pallas_fullk_regen), which the reference's non-saved VJPs (_bwd,
// _bwd_anti via _regen / _regen_anti) and sampled_weights call, and
// bayeformers_tpu/ops/sampled_linear.py::_regen_kernel
// (pallas_regenerate_weights), which the split ops' VJPs (sampled_dense's,
// sampled_logprobs') call: on the TPU the two differ by their eps streams
// (unit_eps against the VMEM-tiled tile_eps); the port's split ops draw from
// the one unit stream, so one kernel serves both, S independent draws of any
// mu (flipout's perturbation passes mu = 0). For draw s
// with seed seeds[s]:
//   W[s, k, n] = mu[k, n] + softplus(rho[k, n]) * eps_s[k, n]      (f32)
// on the absolute-unit stream of eps.cuh, with the product and the sum each
// rounded on its own (bft::sample_w): for the same seeds the result equals,
// bit for bit, the f32 W that the forward kernel (bayes_linear.cu) draws and
// writes, and the plain stream's W (ops/fused_linear.py::sample_weights).
// No unit offsets: a (K, N) weight is one whole layer.
//
// Bound on the H100: the writes. At K = 3072, N = 768, five draws (the
// FFN down-projection's antithetic pairs) it writes 47.2 MB and reads mu and
// rho once (18.9 MB): 0.0197 ms at 3.35 TB/s. The draw itself is ALU work
// (Philox4x32-10, one log, sqrt, sin and cos per two normals). Design: one
// thread per (unit row r < 128, column pair): it owns rows r and r + 128 of
// its unit, which share their Box-Muller pairs (eps.cuh), and columns c and
// c + 1, which share one Philox call, so every normal is drawn once. It
// reads its four mu and rho once, forms the four sigmas once and walks the
// draws, writing four weights per draw (two float2 stores when N is even).
// The antithetic interleave (w, 2 mu - w) stays outside, in torch, as it is
// outside the Pallas kernel (XLA) in the reference.
#include <cuda_runtime.h>

#include <cstdint>

#include "eps.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
regen_kernel(const float* __restrict__ mu, const float* __restrict__ rho,
             const int32_t* __restrict__ seeds, float* __restrict__ w, int S,
             int K, int N) {
  const int half = bft::UNIT_K / 2;
  const int np = (N + 1) / 2;
  const int ku = (K + bft::UNIT_K - 1) / bft::UNIT_K;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(ku) * half * np) return;
  const int cp = static_cast<int>(i % np);
  const int rr = static_cast<int>((i / np) % half);
  const int u = static_cast<int>(i / np / half);
  const int c = 2 * cp;
  const int krow[2] = {u * bft::UNIT_K + rr, u * bft::UNIT_K + rr + half};
  const uint32_t strip = static_cast<uint32_t>(c / bft::UNIT_N);
  const bool pair_vec = (N % 2 == 0);  // c + 1 < N and 8-byte aligned rows

  // element e: row krow[e >> 1], column c + (e & 1), as unit_normals4 orders
  // its outputs {cos(r, c), cos(r, c + 1), sin(r, c), sin(r, c + 1)}
  float m[4], sig[4];
  bool ok[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = krow[e >> 1], n = c + (e & 1);
    ok[e] = k < K && n < N;
    m[e] = 0.0f;
    sig[e] = 0.0f;
    if (ok[e]) {
      const size_t idx = static_cast<size_t>(k) * N + n;
      m[e] = mu[idx];
      sig[e] = bft::softplus(rho[idx]);
    }
  }
  const size_t KN = static_cast<size_t>(K) * N;
  for (int s = 0; s < S; ++s) {
    float z[4];
    bft::unit_normals4(static_cast<uint32_t>(seeds[s]), static_cast<uint32_t>(u),
                       strip, rr, c % bft::UNIT_N, z);
    float* ws = w + static_cast<size_t>(s) * KN;
    // rows: {cos row, sin row}; z order {cos c, cos c+1, sin c, sin c+1}
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = krow[h];
      if (k >= K) continue;
      const float w0 = bft::sample_w(m[2 * h], sig[2 * h], z[2 * h]);
      const float w1 = bft::sample_w(m[2 * h + 1], sig[2 * h + 1], z[2 * h + 1]);
      float* dst = ws + static_cast<size_t>(k) * N + c;
      if (pair_vec) {
        *reinterpret_cast<float2*>(dst) = make_float2(w0, w1);
      } else {
        if (ok[2 * h]) dst[0] = w0;
        if (ok[2 * h + 1]) dst[1] = w1;
      }
    }
  }
}

}  // namespace

// mu / rho (K, N) f32, seeds (S,) i32 -> w (S, K, N) f32, the draws of
// seeds on the unit stream. Returns cudaGetLastError().
extern "C" int bft_regen(const void* mu, const void* rho, const void* seeds,
                         void* w, int S, int K, int N, void* stream) {
  if (S < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int ku = (K + bft::UNIT_K - 1) / bft::UNIT_K;
  const long long total = static_cast<long long>(ku) * (bft::UNIT_K / 2) * ((N + 1) / 2);
  const long long blocks = (total + THREADS - 1) / THREADS;
  regen_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<const float*>(rho),
      static_cast<const int32_t*>(seeds), static_cast<float*>(w), S, K, N);
  return static_cast<int>(cudaGetLastError());
}

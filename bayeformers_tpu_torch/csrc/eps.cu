// unit_eps: the device eps stream written out, and its parts over every
// uniform it can form, for checking them against the plain-torch stream
// (bayeformers_tpu_torch/ops/common.py::unit_eps). No TPU
// kernel of its own: the stream lives inside the bayes_linear kernel, as
// ops/common.py::unit_eps lives inside the Pallas kernels.
#include <cuda_runtime.h>

#include <cstdint>

#include "eps.cuh"

namespace {

constexpr uint32_t STREAM_UNIFORMS = 1u << 24;

// One thread per (draw, half-unit row pair, column pair): writes the four
// normals of one Philox call and their words, for the (K, N) block whose
// [0, 0] corner sits at absolute element (k0, n0); k0 % 256 == 0 and
// n0 % 128 == 0, so local and absolute unit offsets coincide.
__global__ void unit_eps_kernel(const int32_t* __restrict__ seeds, int S, int K,
                                int N, int k0, int n0, float* __restrict__ eps,
                                uint32_t* __restrict__ bits) {
  const int half = bft::UNIT_K / 2;
  const int ku = (K + bft::UNIT_K - 1) / bft::UNIT_K;
  const int np = (N + 1) / 2;
  const long long total = static_cast<long long>(S) * ku * half * np;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int cp = static_cast<int>(i % np);
  const int rr = static_cast<int>((i / np) % half);
  const int u = static_cast<int>((i / np / half) % ku);
  const int s = static_cast<int>(i / np / half / ku);
  const int c = 2 * cp;
  const int kc = u * bft::UNIT_K + rr;
  const int n_abs = n0 + c;
  const uint32_t seed = static_cast<uint32_t>(seeds[s]);
  const uint32_t k_chunk = static_cast<uint32_t>(k0 / bft::UNIT_K + u);
  const uint32_t strip = static_cast<uint32_t>(n_abs / bft::UNIT_N);
  float z[4];
  bft::unit_normals4(seed, k_chunk, strip, rr, n_abs % bft::UNIT_N, z);
  const uint32_t ctr = static_cast<uint32_t>((rr * bft::UNIT_N + n_abs % bft::UNIT_N) >> 1);
  const bft::Philox4 p =
      bft::philox4x32_10(ctr, 0u, 0u, 0u, seed, k_chunk * bft::UNIT_STRIDE + strip);
  const uint32_t words[4] = {p.x0, p.x1, p.x2, p.x3};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int k = (e < 2) ? kc : kc + half;
    const int n = c + (e & 1);
    if (k < K && n < N) {
      const size_t idx = (static_cast<size_t>(s) * K + k) * N + n;
      eps[idx] = z[e];
      bits[2 * idx] = words[2 * (e & 1)];
      bits[2 * idx + 1] = words[2 * (e & 1) + 1];
    }
  }
}

// One thread per uniform the stream can form: u = uniform_from_bits(i << 8)
// for i < 2^24, its radius and the cos and sin of its angle.
__global__ void stream_parts_kernel(float* __restrict__ u, float* __restrict__ r,
                                    float* __restrict__ c, float* __restrict__ s) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= STREAM_UNIFORMS) return;
  u[i] = bft::uniform_from_bits(i << 8);
  r[i] = bft::box_muller_radius(u[i]);
  bft::box_muller_angle(u[i], &c[i], &s[i]);
}

}  // namespace

// The stream's parts over all its uniforms: u, r, c, s (2^24,) f32 (see
// stream_parts_kernel). Returns cudaGetLastError().
extern "C" int bft_stream_parts(void* u, void* r, void* c, void* s, void* stream) {
  stream_parts_kernel<<<STREAM_UNIFORMS / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(u), static_cast<float*>(r), static_cast<float*>(c),
      static_cast<float*>(s));
  return static_cast<int>(cudaGetLastError());
}

// seeds (S,) i32 -> eps (S, K, N) f32 and bits (S, K, N, 2) u32 (the two
// Philox words each element's Box-Muller pair used). Returns cudaGetLastError().
extern "C" int bft_unit_eps(const void* seeds, int S, int K, int N, int k0,
                            int n0, void* eps, void* bits, void* stream) {
  if (k0 % bft::UNIT_K || n0 % bft::UNIT_N) return static_cast<int>(cudaErrorInvalidValue);
  const int ku = (K + bft::UNIT_K - 1) / bft::UNIT_K;
  const long long total = static_cast<long long>(S) * ku * (bft::UNIT_K / 2) * ((N + 1) / 2);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  unit_eps_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seeds), S, K, N, k0, n0,
      static_cast<float*>(eps), static_cast<uint32_t*>(bits));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

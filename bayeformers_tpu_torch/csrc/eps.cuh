// The absolute-unit eps stream on the device.
//
// Same function as bayeformers_tpu_torch/ops/common.py::unit_eps (see the
// docstring there): the normal for weight element (k, n) of a draw is a pure
// function of (seed, k / 256, n / 128, k % 256, n % 128). Philox4x32-10 is
// keyed by (seed, k_chunk * 2^16 + col_strip); inside a unit, rows r and
// r + 128 share one Box-Muller pair (cos / sin branch) and columns c, c + 1
// (c even) share one Philox call, counter ((r * 128 + c) >> 1, 0, 0, 0).
//
// Built without --use_fast_math: logf / sincosf / sqrtf are the precise
// versions, and the uniform is formed with explicit round-to-nearest
// intrinsics, so the bits equal the plain-torch stream's and the normals agree
// to a few ulps. sincosf shares one range reduction between the two branches
// and one fma forms the uniform (its product is exact, so it rounds once, as
// the plain stream's multiply and add do). eps.cu's bft_stream_parts writes
// the uniform, the radius and both branches' cos and sin for every one of
// the 2^24 uniforms the stream can form; chip_smoke.py holds them bit for
// bit against the plain stream's torch ops on the card.
#pragma once

#include <cstdint>

namespace bft {

constexpr int UNIT_K = 256;
constexpr int UNIT_N = 128;
constexpr uint32_t UNIT_STRIDE = 1u << 16;

struct Philox4 {
  uint32_t x0, x1, x2, x3;
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                  uint32_t c2, uint32_t c3,
                                                  uint32_t k0, uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    const uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return Philox4{c0, c1, c2, c3};
}

__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  // (bits >> 8) * 2^-24 is exact in f32, so fused or not the sum rounds once.
  return __fmaf_rn(static_cast<float>(bits >> 8), 1.0f / 16777216.0f, 0.5f / 16777216.0f);
}

// The Box-Muller radius sqrt(-2 log u1).
__device__ __forceinline__ float box_muller_radius(float u1) {
  return sqrtf(__fmul_rn(-2.0f, logf(u1)));
}

// cos and sin of the Box-Muller angle 2 pi u2.
__device__ __forceinline__ void box_muller_angle(float u2, float* cs, float* sn) {
  sincosf(__fmul_rn(6.28318530717958647692f, u2), sn, cs);
}

// Both Box-Muller branches from one pair of words.
__device__ __forceinline__ void box_muller_pair(uint32_t b1, uint32_t b2,
                                                float* z_cos, float* z_sin) {
  const float r = box_muller_radius(uniform_from_bits(b1));
  float cs, sn;
  box_muller_angle(uniform_from_bits(b2), &cs, &sn);
  *z_cos = __fmul_rn(r, cs);
  *z_sin = __fmul_rn(r, sn);
}

// The four normals of one Philox call: elements (r, c), (r, c + 1) of the cos
// half and (r + 128, c), (r + 128, c + 1) of the sin half of the unit
// (k_chunk, col_strip); r in [0, 128), c even in [0, 128).
// out = {cos(r, c), cos(r, c + 1), sin(r, c), sin(r, c + 1)}.
__device__ __forceinline__ void unit_normals4(uint32_t seed, uint32_t k_chunk,
                                              uint32_t col_strip, int r, int c,
                                              float out[4]) {
  const uint32_t unit = k_chunk * UNIT_STRIDE + col_strip;
  const uint32_t ctr = static_cast<uint32_t>((r * UNIT_N + c) >> 1);
  const Philox4 p = philox4x32_10(ctr, 0u, 0u, 0u, seed, unit);
  box_muller_pair(p.x0, p.x1, &out[0], &out[2]);
  box_muller_pair(p.x2, p.x3, &out[1], &out[3]);
}

// sigma = softplus(rho) in the logaddexp(rho, 0) form that jax.nn.softplus
// and the plain version (core/distributions.py::sigma_from_rho) use: no
// product, so nothing for the compiler to contract.
__device__ __forceinline__ float softplus(float r) {
  return fmaxf(r, 0.0f) + log1pf(expf(-fabsf(r)));
}

// One sampled weight w = mu + sigma * eps, the product and the sum each
// rounded on its own (no FMA), as torch's plain version rounds them: the
// forward kernel's W and the regeneration kernel's W are then equal, bit for
// bit, to each other and to the plain W at the same normals.
__device__ __forceinline__ float sample_w(float mu, float sigma, float z) {
  return __fadd_rn(mu, __fmul_rn(sigma, z));
}

}  // namespace bft

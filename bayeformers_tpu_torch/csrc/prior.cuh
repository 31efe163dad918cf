// The priors of the Bayesian linear op, shared by the forward (bayes_linear.cu)
// and the reduce (fused_backward.cu). Counterparts of the branches of
// bayeformers_tpu/ops/fused_linear.py::_kernel (:208-218), ::_anti_kernel
// (:719-731) and bayeformers_tpu/ops/fused_backward.py::_kernel (:130-140),
// ::_kernel_anti (:244-255):
//   ON_MU     the MOPED Gaussian prior centred on mu itself (frozen mu);
//   GAUSSIAN  the MOPED Gaussian prior centred on a separate prior_mu;
//   MIXTURE   the zero-mean scale mixture pi N(0, s1^2) + (1 - pi) N(0, s2^2);
//   NONE      no prior and no log-probs: the forward's sampled matmul alone
//             (bayes_linear.cu's bft_sampled_dense, the split op of
//             bayeformers_tpu/ops/sampled_linear.py::_fused_kernel).
// Each kernel takes the prior as a template parameter, so an instance
// carries only its own prior's work.
//
// The mixture's log-density is max(a1, a2) + log1p(exp(-|a1 - a2|)) with
// a_i = log(weight_i) - log sqrt(2 pi) - log s_i - (w / s_i)^2 / 2: with
// s2 = e^-6 the narrow component's exponent reaches about -3,000 at
// |w| = 0.2, where log(exp(a1) + exp(a2)) would take the log of an
// underflowed term. Built without --use_fast_math (expf, log1pf precise),
// as the plain versions' torch.logaddexp takes the same form.
#pragma once

namespace bft {

enum Prior : int { ON_MU = 0, GAUSSIAN = 1, MIXTURE = 2, NONE = 3 };

// c1 = log(pi) - log sqrt(2 pi) - log s1, c2 = log(1 - pi) - log sqrt(2 pi)
// - log s2, and the inverse scales (ops/logprob.py::mixture_constants).
struct Mixture {
  float c1, c2, inv_s1, inv_s2;
};

__device__ __forceinline__ void mixture_logs(float w, const Mixture& m, float* a1,
                                             float* a2) {
  const float z1 = w * m.inv_s1, z2 = w * m.inv_s2;
  *a1 = m.c1 - 0.5f * z1 * z1;
  *a2 = m.c2 - 0.5f * z2 * z2;
}

__device__ __forceinline__ float logaddexp(float a1, float a2) {
  return fmaxf(a1, a2) + log1pf(expf(-fabsf(a1 - a2)));
}

// log(pi N(w; 0, s1^2) + (1 - pi) N(w; 0, s2^2))
__device__ __forceinline__ float mixture_log_pdf(float w, const Mixture& m) {
  float a1, a2;
  mixture_logs(w, m, &a1, &a2);
  return logaddexp(a1, a2);
}

// d/dw of mixture_log_pdf: -w (r1 / s1^2 + (1 - r1) / s2^2), with the first
// component's responsibility r1 = exp(a1 - logaddexp(a1, a2)).
__device__ __forceinline__ float mixture_score(float w, const Mixture& m) {
  float a1, a2;
  mixture_logs(w, m, &a1, &a2);
  const float r1 = expf(a1 - logaddexp(a1, a2));
  return -w * (r1 * (m.inv_s1 * m.inv_s1) + (1.0f - r1) * (m.inv_s2 * m.inv_s2));
}

}  // namespace bft

// Warp-level tensor-core products for the port's kernels, in bf16 or in f32.
//
// Every kernel of the port is a template over its operand type T:
//   * T = __nv_bfloat16: one WMMA m16n16k16 product, bf16 operands, f32
//     accumulation (the bf16 instances, unchanged since they were written);
//   * T = float: a true f32 product as 3xTF32 on WMMA m16n16k8. Each
//     operand a splits into a_hi = tf32(a) and a_lo = tf32(a - a_hi) (the
//     difference is exact in f32), and a b = a_hi b_lo + a_lo b_hi + a_hi
//     b_hi, the small terms first; the dropped a_lo b_lo is ~2^-22 of a b.
//     Plain TF32 (one product of the rounded operands) keeps ~2^-11 and is
//     never used: it would be a downgrade of f32 hidden inside the kernel.
//     The reference's f32 kernels take their dot operands in f32 at the
//     global (highest) precision (bayeformers_tpu/ops/config.py::
//     kernel_dot_precision).
// Operand<T, Use, Layout> holds one 16 x KDEPTH (or KDEPTH x 16) operand,
// split once at its load so that it feeds several products.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

namespace bft {

namespace wmma = nvcuda::wmma;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Depth (K) of one fragment product, in elements.
template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  static constexpr int KDEPTH = 16;
  static constexpr int VEC = 8;  // elements in a 16-byte copy
};
template <>
struct Mma<float> {
  static constexpr int KDEPTH = 8;
  static constexpr int VEC = 4;
};

template <typename T>
using Acc = wmma::fragment<wmma::accumulator, 16, 16, Mma<T>::KDEPTH, float>;

template <typename T, typename Use, typename Layout>
struct Operand;

template <typename Use, typename Layout>
struct Operand<__nv_bfloat16, Use, Layout> {
  wmma::fragment<Use, 16, 16, 16, __nv_bfloat16, Layout> f;
  __device__ __forceinline__ void load(const __nv_bfloat16* p, unsigned ld) {
    wmma::load_matrix_sync(f, p, ld);
  }
};

template <typename Use, typename Layout>
struct Operand<float, Use, Layout> {
  wmma::fragment<Use, 16, 16, 8, wmma::precision::tf32, Layout> hi, lo;
  __device__ __forceinline__ void load(const float* p, unsigned ld) {
    wmma::load_matrix_sync(hi, p, ld);
#pragma unroll
    for (int i = 0; i < hi.num_elements; ++i) {
      const float v = hi.x[i];
      const float h = wmma::__float_to_tf32(v);
      hi.x[i] = h;
      lo.x[i] = wmma::__float_to_tf32(v - h);
    }
  }
};

// acc += a b
template <typename LA, typename LB>
__device__ __forceinline__ void mma(Acc<__nv_bfloat16>& acc,
                                    const Operand<__nv_bfloat16, wmma::matrix_a, LA>& a,
                                    const Operand<__nv_bfloat16, wmma::matrix_b, LB>& b) {
  wmma::mma_sync(acc, a.f, b.f, acc);
}

template <typename LA, typename LB>
__device__ __forceinline__ void mma(Acc<float>& acc,
                                    const Operand<float, wmma::matrix_a, LA>& a,
                                    const Operand<float, wmma::matrix_b, LB>& b) {
  wmma::mma_sync(acc, a.lo, b.hi, acc);
  wmma::mma_sync(acc, a.hi, b.lo, acc);
  wmma::mma_sync(acc, a.hi, b.hi, acc);
}

// acc += part element by element, rounded to nearest (FADD): a long f32
// product whose steps each start a fresh fragment, so that no chain in the
// tensor cores' accumulator, which does not round to nearest, is longer
// than one step.
template <typename Fragment>
__device__ __forceinline__ void add_into(Fragment& acc, const Fragment& part) {
#pragma unroll
  for (int e = 0; e < acc.num_elements; ++e) acc.x[e] = __fadd_rn(acc.x[e], part.x[e]);
}

}  // namespace bft

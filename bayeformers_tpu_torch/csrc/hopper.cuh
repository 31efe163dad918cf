// Hopper (sm_90a) building blocks of the port's bf16 products: mbarriers,
// TMA tile loads, wgmma descriptors and the m64n128k16 bf16 wgmma, plus the
// host-side encoding of a TMA tensor map.
//
// The forward's product (bayes_linear.cu) and the reduce (fused_backward.cu)
// load their operand tiles by TMA into a ring of shared-memory stages, each
// with a "full" mbarrier (the TMA's bytes arrived) and an "empty" one (every
// warp of the consumers finished the wgmmas that read it), and run wgmma on
// them from shared memory. Every tile is 128 bytes wide (64 bf16) and stored
// with the 128-byte swizzle, which TMA writes and wgmma reads: chunk c (16
// bytes) of row r lands at chunk c ^ (r % 8), so the 8 rows of a core matrix
// fall in distinct banks. A stage's base is 1024-byte aligned (the swizzle
// repeats every 8 rows of 128 bytes).
//
// Descriptors (PTX ISA, "matrix descriptor"; CUTLASS's GmmaDescriptor): the
// start address, a leading and a stride byte offset (in 16-byte units) and
// the swizzle mode (1: 128 bytes). With the 128-byte swizzle
//  * a K-major operand (rows along M or N, 64 contiguous K values each) has
//    SBO = 1024 bytes, the stride of 8-row groups; LBO is unused. The 16 K
//    values of one wgmma start 32 bytes further per step along K;
//  * an MN-major operand (rows along K, 64 contiguous M or N values each)
//    has SBO = 1024 bytes, the stride of 8-row groups along K, and LBO the
//    stride between 64-wide chunks along M or N. One wgmma's 16 K rows start
//    2048 bytes further per step along K. wgmma takes an MN-major bf16
//    operand through its transpose bit.
//
// The accumulator of an m64nN wgmma lives in registers: thread i of the
// warpgroup (warp w = i / 32, lane l) holds, for each 8-column block j,
// d[4j] and d[4j + 1] at row 16 w + l / 4, columns 8 j + 2 (l % 4) and + 1,
// and d[4j + 2], d[4j + 3] at the same columns of row 16 w + l / 4 + 8.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace bft {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive and expect ``bytes`` of TMA transfers on the barrier's phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive where ``pred`` holds: a predicate and not a branch, since ptxas
// serializes every wgmma of a kernel whose warpgroups branch by thread
// around their wgmma work (one lane a warp arrives).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(static_cast<int>(pred))
      : "memory");
}

// Spin until the barrier's phase ``parity`` has completed. The loop is
// inside the asm, so the compiler sees no divergent loop. A phase that
// never completes (a fault in the kernel's bookkeeping) traps after 2^28
// polls, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u32 n;\n"
      "mov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.eq.u32 p, n, 268435456;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---- TMA ----
// The box of a 3-D map at element coordinates (c0 innermost, c1, c2) into
// shared memory; its bytes complete on ``bar``. Coordinates outside the
// tensor read as zero (and count towards the expected bytes).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// ---- predicated stores (no branch around a read of an accumulator, for
// the same reason as mbar_arrive) ----
__device__ __forceinline__ void st_b32(void* ptr, uint32_t v, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p st.global.b32 [%0], %1;\n"
      "}\n" ::"l"(ptr),
      "r"(v), "r"(static_cast<int>(pred))
      : "memory");
}

__device__ __forceinline__ void st_b16(void* ptr, uint16_t v, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p st.global.b16 [%0], %1;\n"
      "}\n" ::"l"(ptr),
      "h"(v), "r"(static_cast<int>(pred))
      : "memory");
}

// ---- wgmma ----
// A shared-memory operand with the 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* smem, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (smem_u32(smem) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// Hand registers back (dec) or take them (inc) for the calling warpgroup,
// a multiple of 8 between 24 and 256 a thread.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across a
// wgmma fence or wait (the asynchronous wgmma writes it behind its back).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32, the wgmma accumulator layout) += or = a b, m64n128k16,
// bf16 operands from shared memory through their descriptors. TRANS_A /
// TRANS_B: 1 for an MN-major operand. accumulate = 0 overwrites d.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}


}  // namespace sm90

// ---- host: TMA tensor maps ----
// cuTensorMapEncodeTiled from the driver, found through the runtime (no link
// against libcuda).
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                   void*, const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D map of a bf16 (batch, rows, cols) tensor whose rows are ``ld``
// elements apart (a multiple of 8, base 16-byte aligned): boxes of (1,
// box_rows, 64) elements, 128-byte swizzle, zero outside the tensor. Returns
// a CUDA error code (0: success).
inline int make_map_bf16(CUtensorMap* map, const void* base, int batch, int rows,
                         int cols, int ld, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (ld % 8 || reinterpret_cast<uintptr_t>(base) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(ld) * rows * 2};
  const cuuint32_t box[3] = {64u, static_cast<cuuint32_t>(box_rows), 1u};
  const cuuint32_t estr[3] = {1u, 1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                        dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace bft

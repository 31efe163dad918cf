// The Bayesian linear forward's product on Hopper: y[s] = x[s] @ W[s].
//
// Replaces the matmul half of bayeformers_tpu/ops/fused_linear.py::_kernel
// (independent draws, Kp < 2048), ::_ktall_kernel (Kp >= 2048, the FFN
// down-projection), ::_anti_kernel / ::_ktall_anti_kernel (antithetic pairs)
// and bayeformers_tpu/ops/sampled_linear.py::_fused_kernel (the split op's
// sampled matmul, no prior). On the TPU each draws W inside its matmul, tile
// by tile of VMEM; the port splits the op in two stages: the draw pass
// (regen.cu, bft_draw) writes the (S, K, N) W of every sample once, in the
// operand type, with the log-prob partials, and this kernel multiplies;
// bft_bayes_linear launches the two, chunk of draws by chunk, and the
// log-probs' fixed-order finalize, for the wrappers
// (ops/fused_linear.py::bayes_linear_cuda,
// ops/sampled_linear.py::sampled_dense_cuda). On the training path W is
// the saved residual anyway, so the split adds only its read; serving adds
// S K N bytes written and read (11.8 MB at 768 x 768, S = 10, bf16), most
// of it out of the 50 MB L2.
//
// Bound on the H100: the 2 S M K N flops at the tensor rate (989 TFLOP/s in
// bf16: 0.0122 ms at 768 x 768, S = 10, M = 1024; 165 TFLOP/s for f32 as
// 3xTF32); x, W and y are a few times fewer bytes. A draw inside the
// product would be redone in every row tile (4 to 8 times at M = 1024) and
// hold the tensor cores while it ran; drawn once, W costs its write and
// read.
//
// bf16 (bmm_bf16_kernel): a persistent grid, one block an SM, walks the
// (sample, 128-row tile, 128-column tile) tiles (480 at 768 x 768). Two
// consumer warpgroups each own 64 rows of the tile and run wgmma
// m64n128k16 (f32 accumulation in registers) on 64-deep K steps that TMA
// loads into a ring of 5 shared-memory stages (hopper.cuh): x's (128, 64)
// tile K-major, W's (64, 128) tile as two N-contiguous (64, 64) boxes,
// which wgmma reads through its transpose bit. A producer warp issues the
// loads, up to 5 steps ahead, across tile boundaries, so a tile's epilogue
// (y stored from the accumulator registers) overlaps the next tile's
// loads; a stage is refilled when all 8 consumer warps have released it (an
// mbarrier each way). One wgmma group stays in flight while the next
// stage's is issued. The consumers branch on nothing that differs between
// their threads (a branch by thread around wgmma work makes ptxas
// serialize every wgmma of the kernel).
//
// f32 (bmm_f32_kernel): true f32 products as 3xTF32 (mma.cuh) on WMMA, not
// wgmma: TF32 wgmma takes a shared-memory operand only K-major, and W is
// N-major; a K-major hi/lo copy of W would double the draw pass's writes.
// The tensor cores add into their f32 accumulator without rounding to
// nearest: a sum carried across all of K = 3072 in the accumulator drifted
// by 5e-5 of max |y| on the H100 (chip_smoke.py), against a 2e-5 gate, so
// each 32-deep K step's products go into a fresh fragment that is added to
// the running sum in registers (FADD); no accumulator chain is longer than
// one step (12 products). A persistent grid of blocks of 8 warps (4 x 2,
// 32 x 32 outputs each: two A and two B fragments feed four products), two
// blocks an SM, walks the (sample, 128-row, 64-column) tiles through a
// two-stage cp.async pipeline.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "hopper.cuh"
#include "mma.cuh"

using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;
using bft::allow_smem;
using bft::sm_count;

// ---------------------------------------------------------------- bf16 ----
namespace wg {

constexpr int TM = 128, TN = 128, TK = 64, STAGES = 5;
constexpr int CONSUMERS = 256;                // two warpgroups, 64 rows each
constexpr int THREADS = CONSUMERS + 32;       // and one producer warp
constexpr int A_BYTES = TM * TK * 2;          // x tile, 16 KB
constexpr int B_BYTES = TK * TN * 2;          // W tile, two 8 KB boxes
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

__global__ void __launch_bounds__(THREADS, 1)
bmm_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w, bf16* __restrict__ y,
                int M, int N, int n_k, int tiles_m, int tiles_n, int n_tiles) {
  using namespace bft::sm90;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int my_tiles =
      static_cast<int>(blockIdx.x) < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = my_tiles * n_k;

  if (threadIdx.x >= CONSUMERS) {
    // the producer warp: one thread keeps the ring full, STAGES steps ahead
    // of the consumers, across tile boundaries; step j is tile blockIdx.x +
    // (j / n_k) gridDim.x, K step j % n_k
    if (threadIdx.x != CONSUMERS) return;
    for (int j = 0; j < total; ++j) {
      const int slot = j % STAGES;
      if (j >= STAGES) mbar_wait(&empty[slot], ((j / STAGES) + 1) & 1);
      const int tile = blockIdx.x + (j / n_k) * gridDim.x, kt = j % n_k;
      const int tn = tile % tiles_n, tm = (tile / tiles_n) % tiles_m,
                s = tile / (tiles_n * tiles_m);
      unsigned char* st = smem + slot * STAGE_BYTES;
      mbar_expect_tx(&full[slot], STAGE_BYTES);
      tma_load_3d(st, &map_x, &full[slot], kt * TK, tm * TM, s);
      tma_load_3d(st + A_BYTES, &map_w, &full[slot], tn * TN, kt * TK, s);
      tma_load_3d(st + A_BYTES + TK * 128, &map_w, &full[slot], tn * TN + 64, kt * TK, s);
    }
    return;
  }

  // the consumers: no branch on the thread inside, so ptxas keeps the
  // wgmmas asynchronous
  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bool paired = (N % 2 == 0);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  int j = 0;
  for (int ti = 0; ti < my_tiles; ++ti) {
    for (int kt = 0; kt < n_k; ++kt, ++j) {
      const int slot = j % STAGES;
      mbar_wait(&full[slot], (j / STAGES) & 1);
      const unsigned char* st = smem + slot * STAGE_BYTES;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const uint64_t da = desc_sw128(st + wgi * 64 * 128 + kk * 32, 16, 1024);
        const uint64_t db = desc_sw128(st + A_BYTES + kk * 2048, TK * 128, 1024);
        wgmma_m64n128k16<0, 1>(acc, da, db, (kt > 0 || kk > 0) ? 1 : 0);
      }
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();  // the previous step's group is done: release its stage
      fence_acc(acc);
      if (kt > 0) mbar_arrive(&empty[(j - 1) % STAGES], lane == 0);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(&empty[(j - 1) % STAGES], lane == 0);
    // epilogue: the tile's y from the accumulator registers, predicated
    // stores; the next tile's loads are already in flight
    const int tile = blockIdx.x + ti * gridDim.x;
    const int tn = tile % tiles_n, tm = (tile / tiles_n) % tiles_m, s = tile / (tiles_n * tiles_m);
    const int r0 = tm * TM + wgi * 64 + warp * 16 + (lane >> 2);
    const int c0 = tn * TN + 2 * (lane & 3);
    bf16* ys = y + static_cast<size_t>(s) * M * N;
#pragma unroll
    for (int jn = 0; jn < TN / 8; ++jn) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + 8 * hf, col = c0 + 8 * jn;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(acc[4 * jn + 2 * hf], acc[4 * jn + 2 * hf + 1]);
        bf16* dst = ys + static_cast<size_t>(row) * N + col;
        const bool in = row < M && col < N;
        if (paired) {
          st_b32(dst, *reinterpret_cast<const uint32_t*>(&v), in);
        } else {
          st_b16(dst, __bfloat16_as_ushort(v.x), in);
          st_b16(dst + 1, __bfloat16_as_ushort(v.y), in && col + 1 < N);
        }
      }
    }
  }
}

}  // namespace wg

// ----------------------------------------------------------------- f32 ----
namespace tf32 {

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int THREADS = 256;        // 8 warps: 4 (rows) x 2 (cols), 32 x 32 each
constexpr int XLD = BK + 4, WLD = BN + 4, CLD = BN + 4;  // padded by 16 bytes
constexpr int XS = BM * XLD, WS = BK * WLD;  // floats a stage
constexpr int PIPE_BYTES = 2 * (XS + WS) * 4;
constexpr int CS_BYTES = BM * CLD * 4;
constexpr int SMEM_BYTES = PIPE_BYTES > CS_BYTES ? PIPE_BYTES : CS_BYTES;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The x tile (rows m0.., columns k0..k0 + 31) and the W tile (rows k0..,
// columns n0..n0 + 63) of one K step into a stage; zero outside the
// matrices. x: 16-byte asynchronous copies when its rows allow (x_vec),
// else element loads; W's rows (ldw, a multiple of 4) always allow them.
// Columns of W between N and ldw are read as they are: they reach only
// y's columns past N, which are not stored.
__device__ __forceinline__ void load_step(const float* xs, const float* ws, int M, int K,
                                          int N, int ldw, int m0, int n0, int k0,
                                          bool x_vec, float* xt, float* wt) {
  if (x_vec) {
#pragma unroll
    for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
      const int q = threadIdx.x + i * THREADS;
      const int chunk = q % (BK / 4), row = q / (BK / 4);
      const int m = m0 + row, k = k0 + chunk * 4;
      const bool ok = m < M && k < K;
      cp_async16(xt + row * XLD + chunk * 4, xs + (ok ? static_cast<size_t>(m) * K + k : 0), ok);
    }
  } else {
    for (int q = threadIdx.x; q < BM * BK; q += THREADS) {
      const int col = q % BK, row = q / BK;
      const int m = m0 + row, k = k0 + col;
      xt[row * XLD + col] = (m < M && k < K) ? xs[static_cast<size_t>(m) * K + k] : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
    const int q = threadIdx.x + i * THREADS;
    const int chunk = q % (BN / 4), row = q / (BN / 4);
    const int k = k0 + row, n = n0 + chunk * 4;
    const bool ok = k < K && n < N;
    cp_async16(wt + row * WLD + chunk * 4, ws + (ok ? static_cast<size_t>(k) * ldw + n : 0), ok);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
bmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ y, int M, int K, int N, int ldw, int x_vec,
               int tiles_m, int tiles_n, int n_tiles) {
  using AFrag = bft::Operand<float, wmma::matrix_a, wmma::row_major>;
  using BFrag = bft::Operand<float, wmma::matrix_b, wmma::row_major>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xt_base = reinterpret_cast<float*>(smem);
  float* wt_base = xt_base + 2 * XS;
  float* cs = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5, warp_m = warp & 3, warp_n = warp >> 2;
  const int n_steps = (K + BK - 1) / BK;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int tn = tile % tiles_n, tm = (tile / tiles_n) % tiles_m, s = tile / (tiles_n * tiles_m);
    const int m0 = tm * BM, n0 = tn * BN;
    const float* xs = x + static_cast<size_t>(s) * M * K;
    const float* ws = w + static_cast<size_t>(s) * K * ldw;
    bft::Acc<float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    load_step(xs, ws, M, K, N, ldw, m0, n0, 0, x_vec, xt_base, wt_base);
    cp_async_wait();
    __syncthreads();
    for (int st = 0; st < n_steps; ++st) {
      const int cur = st & 1;
      if (st + 1 < n_steps)
        load_step(xs, ws, M, K, N, ldw, m0, n0, (st + 1) * BK, x_vec,
                  xt_base + (cur ^ 1) * XS, wt_base + (cur ^ 1) * WS);
      const float* xt = xt_base + cur * XS;
      const float* wt = wt_base + cur * WS;
      bft::Acc<float> part[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(part[i][j], 0.0f);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        AFrag a[2];
        BFrag b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i].load(xt + (warp_m * 32 + i * 16) * XLD + kk, XLD);
#pragma unroll
        for (int j = 0; j < 2; ++j) b[j].load(wt + kk * WLD + warp_n * 32 + j * 16, WLD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) bft::mma(part[i][j], a[i], b[j]);
      }
      // the step's products into the running sum, rounded to nearest
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < part[i][j].num_elements; ++e)
            acc[i][j].x[e] = __fadd_rn(acc[i][j].x[e], part[i][j].x[e]);
      if (st + 1 < n_steps) cp_async_wait();
      __syncthreads();
    }
    // epilogue: the f32 tile through shared memory
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (warp_m * 32 + i * 16) * CLD + warp_n * 32 + j * 16,
                                acc[i][j], CLD, wmma::mem_row_major);
    __syncthreads();
    float* ys = y + static_cast<size_t>(s) * M * N;
    for (int q = threadIdx.x; q < BM * BN; q += THREADS) {
      const int row = q / BN, col = q % BN;
      const int m = m0 + row, n = n0 + col;
      if (m < M && n < N) ys[static_cast<size_t>(m) * N + n] = cs[row * CLD + col];
    }
    __syncthreads();
  }
}

}  // namespace tf32

}  // namespace

// y (S, M, N) = x (S, M, K) @ w (S, K, ldw)[..., :N], in bf16 (x_f32 = 0:
// bf16 x, W and y, f32 accumulation) or f32 (x_f32 = 1, 3xTF32). bf16: x's
// rows are ldx elements apart (ldx >= K, a multiple of 8, base 16-byte
// aligned; columns K..ldx zero), ldw a multiple of 8. f32: x contiguous (ldx
// = K; x_vec: its rows may be copied 16 bytes at a time), ldw a multiple of
// 4. Returns cudaGetLastError().
extern "C" int bft_bmm(const void* x, const void* w, void* y, int S, int M, int K, int N,
                       int ldx, int ldw, int x_f32, int x_vec, void* stream) {
  if (S < 1 || M < 1 || K < 1 || N < 1 || ldw < N) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_sm = sm_count();
  if (x_f32) {
    using namespace tf32;
    if (ldw % 4) return static_cast<int>(cudaErrorInvalidValue);
    const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
    const int n_tiles = S * tiles_m * tiles_n;
    cudaError_t err = allow_smem<bmm_f32_kernel>(SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = n_tiles < 2 * n_sm ? n_tiles : 2 * n_sm;
    bmm_f32_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), M,
        K, N, ldw, x_vec, tiles_m, tiles_n, n_tiles);
    return static_cast<int>(cudaGetLastError());
  }
  using namespace wg;
  if (ldx < K) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  int e = bft::make_map_bf16(&map_x, x, S, M, ldx, ldx, TM);
  if (e) return e;
  e = bft::make_map_bf16(&map_w, w, S, K, N, ldw, TK);
  if (e) return e;
  const int tiles_m = (M + TM - 1) / TM, tiles_n = (N + TN - 1) / TN;
  const int n_tiles = S * tiles_m * tiles_n;
  cudaError_t err = allow_smem<bmm_bf16_kernel>(SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = n_tiles < n_sm ? n_tiles : n_sm;
  bmm_bf16_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(map_x, map_w, static_cast<bf16*>(y), M, N,
                                                     (ldx + TK - 1) / TK, tiles_m, tiles_n,
                                                     n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// The stages in regen.cu.
extern "C" int bft_draw(const void* mu, const void* rho, const void* seeds,
                        const void* prior_mu, void* w, void* partials, void* ls_part,
                        int n_draws, int K, int N, int ldw, int pair, int w_f32, int prior,
                        int k_unit0, int n_unit0, float inv_sigma_p, float mix_c1,
                        float mix_c2, float mix_inv_s1, float mix_inv_s2, void* stream);
extern "C" int bft_draw_finalize(const void* partials, const void* ls_part, void* tile_part,
                                 void* logq, void* logp, int n_draws, int K, int N, int pair,
                                 int n_lp, float c_q, float c_p, void* stream);

// The Bayesian linear forward, both stages and the log-probs' finalize in
// one call: x (S, M, K) bf16 (x_f32 = 0) or f32, rows ldx apart (bf16: see
// bft_bmm), mu / rho (K, N) f32, seeds (S / H,) i32 (H = 2 for pairs),
// prior_mu (K, N) f32 under GAUSSIAN -> y (S, M, N) in x's type, w (H *
// chunk, K, ldw) in x's type (the draws of each chunk of ``chunk`` draws
// in turn: the whole W when chunk = S / H), drawn at the unit offsets
// (k_unit0, n_unit0) of a shard, and under a prior (not NONE) partials
// (part_per_draw floats a draw) / ls_part / tile_part (bft_draw,
// bft_draw_finalize) and logq / logp (S,) f32. Returns the first CUDA
// error.
extern "C" int bft_bayes_linear(const void* x, const void* mu, const void* rho,
                                const void* seeds, const void* prior_mu, void* y, void* w,
                                void* partials, void* ls_part, void* tile_part, void* logq,
                                void* logp, int S, int M, int K, int N, int ldx, int ldw,
                                int chunk, int part_per_draw, int pair, int x_f32, int x_vec,
                                int prior, int k_unit0, int n_unit0, float inv_sigma_p, float c_q, float c_p, float mix_c1,
                                float mix_c2, float mix_inv_s1, float mix_inv_s2,
                                void* stream) {
  const int h = pair ? 2 : 1, n_draws = S / h;
  if (S < 1 || S % h || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool lp = prior != 3;  // prior.cuh::NONE writes no log-probs
  const size_t isz = x_f32 ? 4 : 2;
  for (int t0 = 0; t0 < n_draws; t0 += chunk) {
    const int n = n_draws - t0 < chunk ? n_draws - t0 : chunk;
    int err = bft_draw(mu, rho, static_cast<const int32_t*>(seeds) + t0, prior_mu, w,
                       lp ? static_cast<float*>(partials) + static_cast<size_t>(t0) * part_per_draw
                          : nullptr,
                       lp && t0 == 0 ? ls_part : nullptr, n, K, N, ldw, pair, x_f32, prior,
                       k_unit0, n_unit0, inv_sigma_p, mix_c1, mix_c2, mix_inv_s1, mix_inv_s2,
                       stream);
    if (err) return err;
    err = bft_bmm(static_cast<const char*>(x) + static_cast<size_t>(h) * t0 * M * ldx * isz, w,
                  static_cast<char*>(y) + static_cast<size_t>(h) * t0 * M * N * isz, h * n, M,
                  K, N, ldx, ldw, x_f32, x_vec, stream);
    if (err) return err;
  }
  if (!lp) return 0;
  return bft_draw_finalize(partials, ls_part, tile_part, logq, logp, n_draws, K, N, pair,
                           pair && prior != 0 ? 2 : 1, c_q, c_p, stream);
}

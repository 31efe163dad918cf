// reduce_abuv / reduce_abuv_anti: the dmu/drho reduce of the Bayesian
// linear backward on Hopper, under each prior of prior.cuh.
//
// Replaces bayeformers_tpu/ops/fused_backward.py::_kernel (independent
// samples) with bft_reduce_abuv and ::_kernel_anti (antithetic pairs) with
// bft_reduce_abuv_anti. Over S independent samples:
//   p = x[s]^T g[s],  wc = float(W[s]) - mu                (K, N), f32 acc
//   A += p,  B += p * wc
//   ON_MU (want_u=False):  V += g_p[s] * wc * wc
//   GAUSSIAN (want_u):     U += g_p[s] * wc,  V += g_p[s] * wc * wc
//   MIXTURE:               U += g_p[s] * score(w),  V += g_p[s] * score(w) * wc
// Over an interleaved antithetic batch (pair t = samples 2t, 2t+1; only the
// even member's weights are read, since w1 - mu = -(w0 - mu)):
//   p0 = x[2t]^T g[2t],  p1 = x[2t+1]^T g[2t+1],  wc = float(W[2t]) - mu
//   A += p0 + p1
//   B += (p0 - p1) * wc
//   ON_MU:     V += (g_p[2t] + g_p[2t+1]) * wc * wc        (once per pair)
//   GAUSSIAN:  U += (g_p[2t] - g_p[2t+1]) * wc,  V as ON_MU
//   MIXTURE:   s0 = score(mu + wc), s1 = score(mu - wc),
//              U += g_p[2t] s0 + g_p[2t+1] s1,  V += (g_p[2t] s0 - g_p[2t+1] s1) * wc
// with score the mixture's (prior.cuh), taken on the W the reduce is given
// (the saved residual, bf16 in bf16 runs, or the regenerated f32 W), and the
// elementwise finalize (ops/fused_backward.py::finalize) turns A, B, U, V
// into dmu and drho.
//
// Bound on the H100: the 2*S*M*K*N flops of the S products over the bf16
// tensor rate (0.012 ms at 768x768, 0.049 ms at 768x3072, S=10, M=1024);
// x, g and W are a few times fewer bytes. No (S, K, N) product reaches
// device memory.
//
// Two passes. The main pass (reduce_bf16_kernel, reduce_f32_kernel) takes A
// and B only, which need the products; the sum pass (reduce_sum_kernel)
// sums its partials in a fixed order and takes the prior's U and V, which
// read only W, mu and g_p, element by element.
//
// The split: the walk over (output tile, pair or sample, chunk of tokens)
// steps is cut into G equal contiguous ranges, one per block of a grid
// that fills the card once (ops/fused_backward.py::plan_slices, the same
// integer arithmetic): block b takes steps [b T / G, (b + 1) T / G) of the
// T in all. Where a range starts or ends inside a tile, that tile's sum is
// split between blocks: each block writes f32 partial A and B for every
// tile it touches into its own slot (tile t, block b: slot t + b, so the
// slots number tiles + G - 1), and the sum pass adds a tile's slots in
// block order. No float atomics: reruns are bit-equal.
//
// The bf16 kernel walks the samples one after the other, each sample's
// tokens in steps, into one accumulator P; when the sample ends (or the
// block's range does) it folds P into A and B, which it holds in registers
// for the current tile: A += p, B += p * wc, wc = w - mu of the sample or,
// for a pair's second member, of the first with its sign turned (w1 - mu =
// -(w0 - mu)), reading W and mu at the accumulator's own elements. So a
// pair's B is p0 wc - p1 wc, rounded once more than the reference's (p0 -
// p1) wc. P restarts at each fold: the tensor cores' f32 accumulator does
// not round to nearest, and A carried over all five pairs of the 768 x 3072
// reduce in it drifted by 1.1e-5 of its largest entry on the H100, over the
// 1e-5 gate of the (bf16 x, f32 W) instance; a chain of one sample (1024
// tokens) stays within it. The producer warpgroup hands its registers to
// the consumers (setmaxnreg), which hold P, A and B: 192 floats a thread.
// A and B in device memory would make each fold a read-modify-write of
// both tiles, more traffic than the products'; in shared memory they would
// leave room for three stages only.
//
// bf16 x and g (reduce_bf16_kernel; W bf16 or, behind the regenerating
// backward, f32): blocks of two consumer warpgroups own a 128 x 128 tile
// (each warpgroup 64 rows of it) and run wgmma m64n128k16 on steps of 64
// tokens of one sample, which a producer warp loads by TMA into a ring of
// six shared-memory stages (hopper.cuh). The
// contraction runs over tokens, so both operands are MN-major: x's (64
// tokens, 128 K) tile as A and g's (64 tokens, 128 N) tile as B, through
// wgmma's transpose bits. The consumers branch on nothing that differs
// between their threads (ptxas serializes every wgmma of a kernel with a
// branch by thread around wgmma work).
//
// f32 x and g (reduce_f32_kernel): 3xTF32 on WMMA (mma.cuh): TF32 wgmma
// takes shared-memory operands only K-major, here token-major, which x and
// g are not. Blocks of 4 warps own a 64 x 64 tile; a step holds 64 token
// rows (32 tokens of each member of a pair) in a two-stage cp.async
// pipeline, two blocks an SM. A sample's sum carried over all 1024 tokens
// in the f32 accumulator drifted by 1.5e-5 of A's largest entry on the
// H100 (chip_smoke.py), against a 1e-5 gate, so each step's products go
// into a fresh fragment that is added into A and into D (p0 - p1, or p) in
// registers (FADD); at a fold D passes through shared memory (fragment
// layouts are unspecified) into the slot's B, and A reaches the slot when
// the block leaves the tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "hopper.cuh"
#include "mma.cuh"
#include "prior.cuh"

using namespace nvcuda;
using bft::from_f32;
using bft::to_f32;

namespace {

using bf16 = __nv_bfloat16;
using bft::allow_smem;

// The split of T steps into G ranges: block b's first step, and the block
// whose range holds step j (ops/fused_backward.py::plan_slices).
__host__ __device__ __forceinline__ long long range_begin(long long b, long long total,
                                                          long long G) {
  return b * total / G;
}

__device__ __forceinline__ long long block_of(long long j, long long total, long long G) {
  return ((j + 1) * G + total - 1) / total - 1;
}

// The bf16 kernel walks tile t's samples from sample rot(t) on (then 0, 1,
// ...): the sample at which the block that reaches t's first step would be
// if it had walked its range from sample 0 (even for pairs), so that the
// blocks, which start together, walk the samples nearly in step and share
// each sample's x and g in L2 (ops/fused_backward.py::SlicePlan.rotation).
__device__ __forceinline__ int sample_rotation(int t, int T, int total, int G, int n_mc,
                                               int S, int H) {
  const long long first = static_cast<long long>(t) * T;
  const long long b = block_of(first, total, G);
  const int r = static_cast<int>(((first - range_begin(b, total, G)) / n_mc) % S);
  return H == 2 ? r & ~1 : r;
}

// ---------------------------------------------------------------- bf16 ----
namespace wg {

constexpr int TILE = 128;      // output rows (K) and columns (N) of a block
constexpr int TOK = 64;        // tokens of each member in a step
constexpr int CONSUMERS = 256;  // two warpgroups, 64 rows each
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
constexpr int BOX = TOK * 128; // one (64 tokens, 64 columns) bf16 box, 8 KB

// A stage holds one sample's step: x's two (64 tokens, 64 K) boxes and g's
// two (64 tokens, 64 N) boxes.
constexpr int STAGE = 4 * BOX;
constexpr int STAGES = 6;
constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;

// float(W) - mu at (k, n), 0 outside the matrix (selects, no branch)
template <typename TW>
__device__ __forceinline__ float wc_at(const TW* w0, const float* mu, int K, int N, int k,
                                       int n) {
  const bool ok = k < K && n < N;
  const size_t o = ok ? static_cast<size_t>(k) * N + n : 0;
  const float v = to_f32(w0[o]) - mu[o];
  return ok ? v : 0.0f;
}

// Step q of tile t covers sample (q / n_mc + rot(t)) mod S, tokens [(q %
// n_mc) TOK, + TOK); H = 2: samples 2u and 2u + 1 are pair u.
template <int H, typename TW>
__global__ void __launch_bounds__(THREADS, 1)
reduce_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_g, const TW* __restrict__ w,
                   const float* __restrict__ mu, float* __restrict__ part, int S, int K, int N,
                   int n_mc, int tiles_n, int steps_per_tile, int total) {
  using namespace bft::sm90;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const int G = gridDim.x, T = steps_per_tile;
  const int beg = static_cast<int>(range_begin(blockIdx.x, total, G));
  const int n_steps = static_cast<int>(range_begin(blockIdx.x + 1, total, G)) - beg;

  if (threadIdx.x >= CONSUMERS) {
    // the producer warpgroup hands most of its registers to the consumers;
    // one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x != CONSUMERS) return;
    int tile = beg / T, q = beg % T, rot = sample_rotation(tile, T, total, G, n_mc, S, H);
    for (int i = 0; i < n_steps; ++i) {
      const int slot = i % STAGES;
      if (i >= STAGES) mbar_wait(&empty[slot], ((i / STAGES) + 1) & 1);
      const int s = (q / n_mc + rot) % S, m0 = (q % n_mc) * TOK;
      const int k0 = (tile / tiles_n) * TILE, n0 = (tile % tiles_n) * TILE;
      unsigned char* st = smem + slot * STAGE;
      mbar_expect_tx(&full[slot], STAGE);
      tma_load_3d(st, &map_x, &full[slot], k0, m0, s);
      tma_load_3d(st + BOX, &map_x, &full[slot], k0 + 64, m0, s);
      tma_load_3d(st + 2 * BOX, &map_g, &full[slot], n0, m0, s);
      tma_load_3d(st + 3 * BOX, &map_g, &full[slot], n0 + 64, m0, s);
      if (++q == T) {
        q = 0;
        ++tile;
        rot = sample_rotation(tile, T, total, G, n_mc, S, H);
      }
    }
    return;
  }

  // the consumers: no branch on the thread inside, so ptxas keeps the
  // wgmmas asynchronous. P: the current sample's product over its tokens so
  // far, restarted at each fold, so no accumulator chain spans more than
  // one sample; A and B: the block's sums for the current tile in f32.
  setmaxnreg_inc<232>();
  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  float P[64], A[64], B[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) P[e] = A[e] = B[e] = 0.0f;
  const int rl = wgi * 64 + warp * 16 + (lane >> 2);  // this thread's first row in the tile
  const int cl = 2 * (lane & 3);                       // and first column
  const size_t KN = static_cast<size_t>(K) * N;
  int i = 0;
  while (i < n_steps) {
    // a run of steps up to the end of its sample or of the range
    const int tile = (beg + i) / T, q0 = (beg + i) % T;
    const int left = n_mc - q0 % n_mc;
    const int len = left < n_steps - i ? left : n_steps - i;
    for (int r = 0; r < len; ++r, ++i) {
      const int slot = i % STAGES;
      mbar_wait(&full[slot], (i / STAGES) & 1);
      const unsigned char* st = smem + slot * STAGE;
      fence_acc(P);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TOK / 16; ++kk) {
        const uint64_t da = desc_sw128(st + wgi * BOX + kk * 2048, BOX, 1024);
        const uint64_t db = desc_sw128(st + 2 * BOX + kk * 2048, BOX, 1024);
        wgmma_m64n128k16<1, 1>(P, da, db, 1);
      }
      wgmma_commit();
      fence_acc(P);
      wgmma_wait<1>();  // the previous step's group is done: release its stage
      fence_acc(P);
      if (r > 0) mbar_arrive(&empty[(i - 1) % STAGES], lane == 0);
    }
    wgmma_wait<0>();
    fence_acc(P);
    mbar_arrive(&empty[(i - 1) % STAGES], lane == 0);
    // fold the sample at the accumulator's elements, W and mu read there: A
    // += p, B += p * wc, wc = w - mu of the sample (of the pair's first
    // member: the second's is -wc)
    const int s = (q0 / n_mc + sample_rotation(tile, T, total, G, n_mc, S, H)) % S;
    const float sign = (H == 2 && (s & 1)) ? -1.0f : 1.0f;
    const int k0 = (tile / tiles_n) * TILE, n0 = (tile % tiles_n) * TILE;
    const TW* w0 = w + static_cast<size_t>(H == 2 ? s & ~1 : s) * KN;
#pragma unroll
    for (int jn = 0; jn < TILE / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * jn + e;
        const int k = k0 + rl + 8 * (e >> 1), n = n0 + cl + 8 * jn + (e & 1);
        A[idx] += P[idx];
        B[idx] += P[idx] * (sign * wc_at(w0, mu, K, N, k, n));
        P[idx] = 0.0f;
      }
      // keep later columns' loads from being hoisted above this group
      // (hoisting them all spilled the accumulators), 16 elements at a time
      if ((jn & 3) == 3) asm volatile("" ::: "memory");
    }
    if (i != n_steps && (beg + i) % T != 0) continue;
    // the block leaves the tile: its A and B into the tile's slot
    float* pa = part + (static_cast<size_t>(tile) + blockIdx.x) * 2 * TILE * TILE;
    float* pb = pa + TILE * TILE;
#pragma unroll
    for (int jn = 0; jn < TILE / 8; ++jn) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int o = (rl + 8 * hf) * TILE + cl + 8 * jn;
        const int idx = 4 * jn + 2 * hf;
        *reinterpret_cast<float2*>(pa + o) = make_float2(A[idx], A[idx + 1]);
        *reinterpret_cast<float2*>(pb + o) = make_float2(B[idx], B[idx + 1]);
        A[idx] = A[idx + 1] = B[idx] = B[idx + 1] = 0.0f;
      }
    }
  }
}

}  // namespace wg

// ----------------------------------------------------------------- f32 ----
namespace tf32 {

constexpr int TILE = 64;       // output rows (K) and columns (N) of a block
constexpr int THREADS = 128;   // 4 warps: 2 (K) x 2 (N), 32 x 32 outputs each
constexpr int LD = TILE + 4;   // padded leading dim of the operand tiles
constexpr int PLD = TILE + 4;  // of the folded D
constexpr int PER_THREAD = TILE * TILE / THREADS;

template <int H>
struct Smem {
  static constexpr int TM = 64 / H;             // tokens of each member a step
  static constexpr int STAGE = 2 * H * TM * LD;  // x and g, floats
  static constexpr int BYTES = (2 * STAGE + TILE * PLD) * 4;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [m0, m0 + TM) of members s0 .. s0 + H - 1 of a (S, M, C) operand,
// columns [c0, c0 + 64), into a (H, TM, LD) token-major tile; zero outside
// the matrix. vec: 16-byte asynchronous copies (rows of whole chunks,
// aligned base), completed by cp_async_commit_wait(); else element loads.
template <int H>
__device__ __forceinline__ void load_tile(const float* src, int s0, int M, int C, int m0,
                                          int c0, float* dst, bool vec) {
  constexpr int TM = Smem<H>::TM;
  if (vec) {
#pragma unroll
    for (int i = 0; i < H * TM * (TILE / 4) / THREADS; ++i) {
      const int q = threadIdx.x + i * THREADS;
      const int chunk = q % (TILE / 4), row = (q / (TILE / 4)) % TM, h = q / ((TILE / 4) * TM);
      const int m = m0 + row, c = c0 + chunk * 4;
      const bool ok = m < M && c < C;
      cp_async16(dst + (h * TM + row) * LD + chunk * 4,
                 src + (ok ? (static_cast<size_t>(s0 + h) * M + m) * C + c : 0), ok);
    }
  } else {
    for (int q = threadIdx.x; q < H * TM * TILE; q += THREADS) {
      const int col = q % TILE, row = (q / TILE) % TM, h = q / (TILE * TM);
      const int m = m0 + row, c = c0 + col;
      dst[(h * TM + row) * LD + col] =
          (m < M && c < C) ? src[(static_cast<size_t>(s0 + h) * M + m) * C + c] : 0.0f;
    }
  }
}

template <int H, typename TW>
__global__ void __launch_bounds__(THREADS)
reduce_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const TW* __restrict__ w, const float* __restrict__ mu,
                  float* __restrict__ part, int M, int K, int N, int x_vec, int g_vec,
                  int n_mc, int tiles_n, long long steps_per_tile, long long total) {
  using S_ = Smem<H>;
  constexpr int TM = S_::TM;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage_base = reinterpret_cast<float*>(smem);
  float* ps = stage_base + 2 * S_::STAGE;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int warp_k = warp & 1, warp_n = warp >> 1;
  const long long G = gridDim.x, T = steps_per_tile;
  const long long beg = range_begin(blockIdx.x, total, G);
  const long long end = range_begin(blockIdx.x + 1, total, G);
  const size_t KN = static_cast<size_t>(K) * N;

  auto load = [&](long long j, int stage, bool vec_part) {
    const int tile = static_cast<int>(j / T), q = static_cast<int>(j % T);
    const int s0 = H * (q / n_mc), m0 = (q % n_mc) * TM;
    const int k0 = (tile / tiles_n) * TILE, n0 = (tile % tiles_n) * TILE;
    float* xs = stage_base + stage * S_::STAGE;
    float* gs = xs + H * TM * LD;
    if (bool(x_vec) == vec_part) load_tile<H>(x, s0, M, K, m0, k0, xs, vec_part);
    if (bool(g_vec) == vec_part) load_tile<H>(g, s0, M, N, m0, n0, gs, vec_part);
  };

  bft::Acc<float> A[2][2], D[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      wmma::fill_fragment(A[i][jj], 0.0f);
      wmma::fill_fragment(D[i][jj], 0.0f);
    }
  bool first_fold = true;  // of the block's run in the current tile

  if (beg < end) {
    load(beg, 0, true);
    load(beg, 0, false);
    cp_async_commit_wait();
  }
  __syncthreads();
  for (long long j = beg; j < end; ++j) {
    const int cur = static_cast<int>((j - beg) & 1);
    const bool more = j + 1 < end;
    if (more) load(j + 1, cur ^ 1, true);
    const float* xs = stage_base + cur * S_::STAGE;
    const float* gs = xs + H * TM * LD;
#pragma unroll 1
    for (int h = 0; h < H; ++h) {
      bft::Acc<float> p[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) wmma::fill_fragment(p[i][jj], 0.0f);
#pragma unroll
      for (int kk = 0; kk < TM; kk += 8) {
        bft::Operand<float, wmma::matrix_a, wmma::col_major> af[2];
        bft::Operand<float, wmma::matrix_b, wmma::row_major> bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)  // x^T: (k, token) read from the (token, k) tile
          af[i].load(xs + (h * TM + kk) * LD + warp_k * 32 + i * 16, LD);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          bf[jj].load(gs + (h * TM + kk) * LD + warp_n * 32 + jj * 16, LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) bft::mma(p[i][jj], af[i], bf[jj]);
      }
      // the step's products into A and D, rounded to nearest
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < p[i][jj].num_elements; ++e) {
            A[i][jj].x[e] = __fadd_rn(A[i][jj].x[e], p[i][jj].x[e]);
            D[i][jj].x[e] = h ? __fsub_rn(D[i][jj].x[e], p[i][jj].x[e])
                              : __fadd_rn(D[i][jj].x[e], p[i][jj].x[e]);
          }
    }
    if (more) {
      load(j + 1, cur ^ 1, false);
      cp_async_commit_wait();
    }
    __syncthreads();

    const int tile = static_cast<int>(j / T), q = static_cast<int>(j % T);
    const bool group_end = q % n_mc == n_mc - 1;
    const bool seg_end = !more || (j + 1) % T == 0;
    if (!group_end && !seg_end) continue;
    // fold D into B through shared memory, each thread on its own elements
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        wmma::store_matrix_sync(ps + (warp_k * 32 + i * 16) * PLD + warp_n * 32 + jj * 16,
                                D[i][jj], PLD, wmma::mem_row_major);
        wmma::fill_fragment(D[i][jj], 0.0f);
      }
    __syncthreads();
    const int k0 = (tile / tiles_n) * TILE, n0 = (tile % tiles_n) * TILE;
    const TW* w0 = w + static_cast<size_t>(H) * (q / n_mc) * KN;
    float* pa = part + (static_cast<size_t>(tile) + blockIdx.x) * 2 * TILE * TILE;
    float* pb = pa + TILE * TILE;
    // the slot's B += D * wc, each thread on its own elements
#pragma unroll 4
    for (int e = 0; e < PER_THREAD; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / TILE, c = idx % TILE;
      const int k = k0 + r, n = n0 + c;
      float wc = 0.0f;
      if (k < K && n < N) {
        const size_t o = static_cast<size_t>(k) * N + n;
        wc = to_f32(w0[o]) - mu[o];
      }
      const float v = ps[r * PLD + c] * wc;
      pb[idx] = first_fold ? v : pb[idx] + v;
    }
    __syncthreads();
    if (seg_end) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          wmma::store_matrix_sync(pa + (warp_k * 32 + i * 16) * TILE + warp_n * 32 + jj * 16,
                                  A[i][jj], TILE, wmma::mem_row_major);
          wmma::fill_fragment(A[i][jj], 0.0f);
        }
    }
    first_fold = seg_end;
  }
}

}  // namespace tf32

// ------------------------------------------------------------ sum pass ----
// One thread per element of (K, N): A and B summed over the tile's slots in
// block order, then the prior's U and V over the samples (pairs) in order.
template <int H, typename TW, int PRIOR>
__global__ void __launch_bounds__(256)
reduce_sum_kernel(const float* __restrict__ part, const TW* __restrict__ w,
                  const float* __restrict__ mu, const float* __restrict__ g_p,
                  float* __restrict__ a_out, float* __restrict__ b_out,
                  float* __restrict__ u_out, float* __restrict__ v_out, int S, int K, int N,
                  int tile_dim, int tiles_n, long long steps_per_tile, long long total,
                  int G, bft::Mixture mix) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(K) * N) return;
  const int k = static_cast<int>(idx / N), n = static_cast<int>(idx % N);
  const int tile = (k / tile_dim) * tiles_n + n / tile_dim;
  const int o = (k % tile_dim) * tile_dim + n % tile_dim;
  const long long T = steps_per_tile;
  const long long b0 = block_of(tile * T, total, G), b1 = block_of(tile * T + T - 1, total, G);
  float a = 0.0f, b = 0.0f;
  for (long long bb = b0; bb <= b1; ++bb) {
    const long long slot = tile + bb;
    const float* p = part + slot * 2 * tile_dim * tile_dim;
    a += p[o];
    b += p[tile_dim * tile_dim + o];
  }
  a_out[idx] = a;
  b_out[idx] = b;
  const size_t KN = static_cast<size_t>(K) * N;
  const float m = mu[idx];
  float u = 0.0f, v = 0.0f;
  for (int t = 0; t < S / H; ++t) {
    const float wv = to_f32(w[static_cast<size_t>(H) * t * KN + idx]);
    const float wc = wv - m;
    const float gp0 = g_p[H * t], gp1 = (H == 2) ? g_p[H * t + 1] : 0.0f;
    if (PRIOR == bft::ON_MU) {
      v += (H == 2 ? gp0 + gp1 : gp0) * wc * wc;
    } else if (PRIOR == bft::GAUSSIAN) {
      u += (H == 2 ? gp0 - gp1 : gp0) * wc;
      v += (H == 2 ? gp0 + gp1 : gp0) * wc * wc;
    } else if (H == 2) {
      const float s0 = gp0 * bft::mixture_score(m + wc, mix);
      const float s1 = gp1 * bft::mixture_score(m - wc, mix);
      u += s0 + s1;
      v += (s0 - s1) * wc;
    } else {
      const float s0 = gp0 * bft::mixture_score(wv, mix);
      u += s0;
      v += s0 * wc;
    }
  }
  if (PRIOR != bft::ON_MU) u_out[idx] = u;
  v_out[idx] = v;
}

template <int H, typename TW, int PRIOR>
int launch_sum(const void* part, const void* w, const void* mu, const void* g_p, void* a,
               void* b, void* u, void* v, int S, int K, int N, int tile_dim, int tiles_n,
               long long T, long long total, int G, bft::Mixture mix,
               cudaStream_t st) {
  const long long n = static_cast<long long>(K) * N;
  reduce_sum_kernel<H, TW, PRIOR><<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const TW*>(w),
      static_cast<const float*>(mu), static_cast<const float*>(g_p), static_cast<float*>(a),
      static_cast<float*>(b), static_cast<float*>(u), static_cast<float*>(v), S, K, N,
      tile_dim, tiles_n, T, total, G, mix);
  return static_cast<int>(cudaGetLastError());
}

// The main pass of the instance (H, x's type, W's type), then the sum pass
// under the prior.
template <int H, typename TW>
int launch(int x_f32, int prior, const void* x, const void* g, const void* w,
           const void* mu, const void* g_p, void* a, void* b, void* u, void* v, void* part,
           int S, int M, int K, int N, int ldx, int ldg, int G, int x_vec,
           int g_vec, bft::Mixture mix, cudaStream_t st) {
  int tile_dim, n_mc;
  if (x_f32) {
    tile_dim = tf32::TILE;
    n_mc = (M + tf32::Smem<H>::TM - 1) / tf32::Smem<H>::TM;
  } else {
    tile_dim = wg::TILE;
    n_mc = (M + wg::TOK - 1) / wg::TOK;
  }
  const int tiles_k = (K + tile_dim - 1) / tile_dim, tiles_n = (N + tile_dim - 1) / tile_dim;
  // f32: a step holds both members of a pair; bf16: one sample
  const long long T = static_cast<long long>(x_f32 ? S / H : S) * n_mc;
  const long long total = T * tiles_k * tiles_n;
  if (G < 1 || G > total) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (x_f32) {
    constexpr int BYTES = tf32::Smem<H>::BYTES;
    err = allow_smem<tf32::reduce_f32_kernel<H, TW>>(BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    tf32::reduce_f32_kernel<H, TW><<<G, tf32::THREADS, BYTES, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const TW*>(w), static_cast<const float*>(mu), static_cast<float*>(part),
        M, K, N, x_vec, g_vec, n_mc, tiles_n, T, total);
  } else {
    CUtensorMap map_x, map_g;
    int e = bft::make_map_bf16(&map_x, x, S, M, ldx, ldx, wg::TOK);
    if (e) return e;
    e = bft::make_map_bf16(&map_g, g, S, M, ldg, ldg, wg::TOK);
    if (e) return e;
    constexpr int BYTES = wg::SMEM;
    err = allow_smem<wg::reduce_bf16_kernel<H, TW>>(BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (total > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    wg::reduce_bf16_kernel<H, TW><<<G, wg::THREADS, BYTES, st>>>(
        map_x, map_g, static_cast<const TW*>(w), static_cast<const float*>(mu),
        static_cast<float*>(part), S, K, N, n_mc, tiles_n, static_cast<int>(T),
        static_cast<int>(total));
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (prior) {
#define BFT_SUM(P)                                                                        \
  return launch_sum<H, TW, P>(part, w, mu, g_p, a, b, u, v, S, K, N, tile_dim, tiles_n, T, \
                              total, G, mix, st)
    case bft::ON_MU: BFT_SUM(bft::ON_MU);
    case bft::GAUSSIAN: BFT_SUM(bft::GAUSSIAN);
    case bft::MIXTURE: BFT_SUM(bft::MIXTURE);
#undef BFT_SUM
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int H>
int launch_by_type(int x_f32, int w_f32, int prior, const void* x, const void* g,
                   const void* w, const void* mu, const void* g_p, void* a, void* b, void* u,
                   void* v, void* part, int S, int M, int K, int N, int ldx, int ldg, int G,
                   int x_vec, int g_vec, bft::Mixture mix, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < H || S % H || M < 1 || K < 1 || N < 1 || (prior != bft::ON_MU && u == nullptr) ||
      (x_f32 && !w_f32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (w_f32)
    return launch<H, float>(x_f32, prior, x, g, w, mu, g_p, a, b, u, v, part, S, M, K, N, ldx,
                            ldg, G, x_vec, g_vec, mix, st);
  return launch<H, bf16>(x_f32, prior, x, g, w, mu, g_p, a, b, u, v, part, S, M, K, N, ldx,
                         ldg, G, x_vec, g_vec, mix, st);
}

}  // namespace

// x (S, M, K) and g (S, M, N) bf16 (x_f32 = 0) or f32 (x_f32 = 1), w (S, K,
// N) bf16 (w_f32 = 0) or f32 (w_f32 = 1; the antithetic reduce reads the
// even members only), mu (K, N) f32, g_p (S,) f32 -> A, B, V (K, N) f32 and,
// for prior GAUSSIAN (1) or MIXTURE (2), U (K, N) f32 (u may be null under
// ON_MU, 0); mix_*: the mixture's terms (prior.cuh::Mixture). bf16: the rows
// of x and g are ldx / ldg elements apart (multiples of 8, bases 16-byte
// aligned; the columns past K / N are zero). f32: x and g contiguous; x_vec
// / g_vec: their rows may be copied 16 bytes at a time. part: the split's
// partials, (tiles + G - 1, 2, tile, tile) f32 with tile 128 (bf16) or 64
// (f32), G blocks (ops/fused_backward.py::plan_slices): block b writes its
// part of tile t into slot t + b. Each returns
// cudaGetLastError().
extern "C" int bft_reduce_abuv(const void* x, const void* g, const void* w, const void* mu,
                               const void* g_p, void* a, void* b, void* u, void* v, void* part,
                               int S, int M, int K, int N, int ldx, int ldg, int G,
                               int x_vec, int g_vec, int x_f32, int w_f32,
                               int prior, float mix_c1, float mix_c2, float mix_inv_s1,
                               float mix_inv_s2, void* stream) {
  return launch_by_type<1>(x_f32, w_f32, prior, x, g, w, mu, g_p, a, b, u, v, part, S, M, K,
                           N, ldx, ldg, G, x_vec, g_vec,
                           bft::Mixture{mix_c1, mix_c2, mix_inv_s1, mix_inv_s2}, stream);
}

extern "C" int bft_reduce_abuv_anti(const void* x, const void* g, const void* w,
                                    const void* mu, const void* g_p, void* a, void* b,
                                    void* u, void* v, void* part, int S, int M, int K, int N,
                                    int ldx, int ldg, int G, int x_vec,
                                    int g_vec, int x_f32, int w_f32, int prior, float mix_c1,
                                    float mix_c2, float mix_inv_s1, float mix_inv_s2,
                                    void* stream) {
  return launch_by_type<2>(x_f32, w_f32, prior, x, g, w, mu, g_p, a, b, u, v, part, S, M, K,
                           N, ldx, ldg, G, x_vec, g_vec,
                           bft::Mixture{mix_c1, mix_c2, mix_inv_s1, mix_inv_s2}, stream);
}

// bayes_linear / bayes_linear_anti: the Bayesian linear forward on Hopper.
//
// Replaces bayeformers_tpu/ops/fused_linear.py::_kernel (independent draws,
// Kp < 2048) and ::_ktall_kernel (Kp >= 2048, the FFN down-projection) with
// bft_bayes_linear, and ::_anti_kernel / ::_ktall_anti_kernel (antithetic
// pairs) with bft_bayes_linear_anti. On the TPU the K-tall split exists
// because a full-K weight strip outgrew VMEM; here a block walks K in a
// loop, so one kernel takes any K. Both entries are instances of one
// template: H members per block, 2 for a pair, 1 for an independent sample.
// A third entry, bft_sampled_dense, is the one-sample instance with no prior
// (prior.cuh's NONE): y only, no log-probs and no W. It replaces
// bayeformers_tpu/ops/sampled_linear.py::_fused_kernel (pallas_sampled_dense),
// the split op's sampled matmul that flipout runs its perturbation through
// (mu = 0). The TPU kernel draws eps per (BK, BN) VMEM tile (tile_eps); the
// port's split ops draw from the one absolute-unit stream instead, so its W
// is the one regen.cu rebuilds for the same seeds. Its bound is the
// forward's: the products at the tensor rate.
//
// Independent sample s, eps drawn from seeds[s]:
//   w = mu + softplus(rho) * eps,  y[s] = x[s] @ w                (f32 acc)
//   log_q[s] = sum(-eps^2/2) - sum(log sigma) - KN log sqrt(2pi)
//   log_p[s] = sum(-(sigma eps / sigma_p)^2 / 2) - KN (log sqrt(2pi) + log sigma_p)
//              (ON_MU: the MOPED prior centred on mu)
//            = sum(-((w - prior_mu) / sigma_p)^2 / 2) - KN (...)    (GAUSSIAN)
//            = sum(mixture_log_pdf(w))                              (MIXTURE)
// Antithetic pair t (samples 2t, 2t+1), eps drawn from seeds_half[t]:
//   w0 = mu + softplus(rho) * eps,  w1 = 2 mu - w0
//   y[2t] = x[2t] @ w0,  y[2t+1] = x[2t+1] @ w1
//   log_q as above, shared by the pair; log_p shared under ON_MU (the prior
//   centred on mu is even in eps), else one per member, at w0 and at w1.
// Draw t of either kind reads the same unit-stream eps for the same seed.
// The prior is a template parameter (prior.cuh); the log-probs are taken at
// the f32 w, also in the bf16 instances, which store W in bf16. They are
// computed only by the blocks of row tile 0, so GAUSSIAN reads prior_mu
// there and nowhere else, and neither prior adds to the registers that
// the product loop holds.
//
// Two operand types, one template: bf16 x (bf16 products, bf16 y and W) and
// f32 x (true f32 products as 3xTF32, mma.cuh; f32 y and W). The eps draw,
// W's rounding (bft::sample_w), the log-prob partials and their fixed-order
// sum are the same in both, so the f32 W equals the regeneration kernel's
// (regen.cu) bit for bit. Two things differ in f32:
//  * The tensor cores add into their f32 accumulator without rounding to
//    nearest: a sum carried across all of K = 3072 in the accumulator drifted
//    by 5e-5 of max |y| on the H100 (chip_smoke.py), 25x the error of the
//    products. The f32 instance therefore sums each K step's products in a
//    fresh fragment and adds it to the running sum in registers (FADD),
//    so no accumulator chain is longer than one step (12 products).
//  * Each warp owns 16 rows instead of 32 (BM = 128), which keeps the
//    running sums, the step's fragments and the split operands within the
//    128 registers of a 512-thread block, and the tiles within 106 KB of
//    shared memory for a pair (98 KB in bf16). The draw is then regenerated
//    once per 128 rows.
//
// Bound on the H100: the matmul's 2*S*M*K*N flops over the tensor rate
// (989 TFLOP/s in bf16; 165 TFLOP/s for f32 as 3xTF32) bound it at the
// serving shapes (x, mu, rho and y move a few times
// fewer bytes); the eps regeneration adds ALU work (Philox, Box-Muller,
// softplus) for every row tile. Design: each block of 16 warps owns a
// (BM=256 in bf16, BN=64) output tile of its H members, so one eps draw
// feeds H products and a draw is regenerated once per 256 rows (an independent
// sample's draw feeds one product, so its Philox work per output is twice
// a pair's). It walks K in steps of 32 rows (16 cos-branch rows + the 16
// sin-branch rows that share their Box-Muller pairs) through a two-stage
// shared-memory pipeline: while the tensor cores (WMMA / mma.sync, f32
// accumulation) work on one stage, the next x chunk streams into the other
// by cp.async and each thread's mu/rho loads are in flight; it then
// regenerates its four elements of the next W (pair). The phases (all
// warps MMA, then all warps generate, then a barrier) do not overlap.
// Blocks of row tile 0 also emit per-(draw, column tile) log-prob partials,
// which a second one-block kernel sums in a fixed order: no float atomics,
// so log_q / log_p are bit-reproducible for a seed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "eps.cuh"
#include "mma.cuh"
#include "prior.cuh"

using namespace nvcuda;
using bft::from_f32;

namespace {

constexpr int BN = 64;
constexpr int BKH = 16;            // rows per Box-Muller branch in one K step
constexpr int BK = 2 * BKH;        // K rows per step
constexpr int THREADS = 512;       // 16 warps: 8 (rows) x 2 (cols), 32x32 each
constexpr int CLD = BN + 4;        // f32 leading dim of the epilogue tile

// Rows per block for operand type T: each of the 8 warp rows owns IM
// fragments of 16 rows (bf16: 2, BM = 256; f32: 1, BM = 128, see above).
// PROMOTE: the f32 instance's per-step sums (above).
template <typename T>
struct Rows {
  static constexpr int IM = sizeof(T) == 4 ? 1 : 2;
  static constexpr int BM = 8 * 16 * IM;
  static constexpr bool PROMOTE = sizeof(T) == 4;
};

// Shared memory of H members per block in operand type T: two stages of
// (x, W) for each member; the epilogue tile reuses the space. Leading dims
// are padded by 16 bytes.
template <int H, typename T>
struct Smem {
  static constexpr int BM = Rows<T>::BM;
  static constexpr int CS_BYTES = BM * CLD * 4;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int XLD = BK + PAD;
  static constexpr int WLD = BN + PAD;
  static constexpr int VEC = bft::Mma<T>::VEC;  // elements in a 16-byte copy
  static constexpr int X_VEC_PER_THREAD = H * BM * BK / VEC / THREADS;
  static constexpr int XS_STAGE = H * BM * XLD;  // elements
  static constexpr int WS_STAGE = H * BK * WLD;
  static constexpr int PIPE_BYTES = 2 * (XS_STAGE + WS_STAGE) * static_cast<int>(sizeof(T));
  static constexpr int BYTES = PIPE_BYTES > CS_BYTES ? PIPE_BYTES : CS_BYTES;
};

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

// K step s covers the 16 cos-branch rows kc = 256 (s / 8) + 16 (s % 8) and
// the 16 sin-branch rows kc + 128 that share their Box-Muller pairs.
__device__ __forceinline__ int step_kc(int s) {
  return (s >> 3) * bft::UNIT_K + (s & 7) * BKH;
}

template <typename T>
struct Block {
  const T* x;
  const float* mu;
  const float* rho;
  int M, K, N, m0, n0, s0;
};

// Start the asynchronous copy of this thread's 16-byte chunks of the
// (H members, BM, BK) x tile of step s into a stage (zero-filled outside the
// matrix); cp_async_wait() completes them. No registers hold the data.
template <int H, typename T>
__device__ __forceinline__ void load_x_async(const Block<T>& b, int s, T* xs) {
  constexpr int VEC = Smem<H, T>::VEC, XLD = Smem<H, T>::XLD, BM = Smem<H, T>::BM;
  constexpr int CPS = BKH / VEC;  // 16-byte chunks per branch segment
  const int kc = step_kc(s), ks = kc + bft::UNIT_K / 2;
#pragma unroll
  for (int i = 0; i < Smem<H, T>::X_VEC_PER_THREAD; ++i) {
    const int q = threadIdx.x + i * THREADS;
    const int chunk = q % CPS, seg = (q / CPS) & 1, row = (q / (2 * CPS)) & (BM - 1);
    const int h = q / (2 * CPS * BM);
    const int k = (seg ? ks : kc) + chunk * VEC;
    const int m = b.m0 + row;
    const bool ok = m < b.M && k < b.K;
    const T* src =
        b.x + (ok ? (static_cast<size_t>(b.s0 + h) * b.M + m) * b.K + k : 0);
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(
        xs + (h * BM + row) * XLD + seg * BKH + chunk * VEC));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Element-wise x tile for rows that are not whole 16-byte chunks (no
// 16-byte loads).
template <int H, typename T>
__device__ __forceinline__ void load_x_scalar(const Block<T>& b, int s, T* xs) {
  constexpr int XLD = Smem<H, T>::XLD, BM = Smem<H, T>::BM;
  const int kc = step_kc(s), ks = kc + bft::UNIT_K / 2;
  for (int q = threadIdx.x; q < H * BM * BK; q += THREADS) {
    const int col = q % BK, row = (q / BK) % BM, h = q / (BK * BM);
    const int k = (col < BKH ? kc + col : ks + col - BKH);
    const int m = b.m0 + row;
    T v = from_f32<T>(0.0f);
    if (m < b.M && k < b.K) v = b.x[(static_cast<size_t>(b.s0 + h) * b.M + m) * b.K + k];
    xs[(h * BM + row) * XLD + col] = v;
  }
}

// mu / rho of this thread's four weight elements in step s: rows
// (cos, sin) x columns (c, c + 1); out-of-range elements read as 0.
template <typename T>
__device__ __forceinline__ void load_weights(const Block<T>& b, int s, float (&m)[4], float (&r)[4]) {
  const int kc = step_kc(s), ks = kc + bft::UNIT_K / 2;
  const int rr = threadIdx.x >> 5, c = 2 * (threadIdx.x & 31);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int krow = ((e < 2) ? kc : ks) + rr;
    const int n = b.n0 + c + (e & 1);
    m[e] = 0.0f;
    r[e] = 0.0f;
    if (krow < b.K && n < b.N) {
      const size_t idx = static_cast<size_t>(krow) * b.N + n;
      m[e] = b.mu[idx];
      r[e] = b.rho[idx];
    }
  }
}

// Log-prob partials per (draw, column tile): log_q, then one log_p per
// member that has its own (a pair under a prior not centred on mu).
template <int H, int PRIOR>
struct LogP {
  static constexpr int N_LP = (H == 2 && PRIOR != bft::ON_MU) ? 2 : 1;
  static constexpr int N_PART = 1 + N_LP;
};

// H members per block: draw t = blockIdx.z (seed seeds[t]) feeds samples
// H t .. H t + H - 1, member h's weights being w0 (h = 0) or 2 mu - w0.
// T: the type of x, y, W and the products' operands; PRIOR: prior.cuh.
template <int H, typename T, int PRIOR>
__global__ void __launch_bounds__(THREADS, 1)
bayes_linear_kernel(const T* __restrict__ x,
                    const float* __restrict__ mu,
                    const float* __restrict__ rho,
                    const int32_t* __restrict__ seeds,
                    const float* __restrict__ prior_mu,
                    T* __restrict__ y,
                    T* __restrict__ w_out,
                    float* __restrict__ partials,
                    float* __restrict__ ls_part, int M, int K, int N,
                    int x_vec, float inv_sigma_p, bft::Mixture mix) {
  static_assert(H == 1 || H == 2, "one sample or one antithetic pair per block");
  constexpr int N_PART = LogP<H, PRIOR>::N_PART;
  using S_ = Smem<H, T>;
  constexpr int XS_STAGE = S_::XS_STAGE, WS_STAGE = S_::WS_STAGE;
  constexpr int XLD = S_::XLD, WLD = S_::WLD;
  constexpr int BM = S_::BM, IM = Rows<T>::IM;
  constexpr bool PROMOTE = Rows<T>::PROMOTE;
  constexpr int KD = bft::Mma<T>::KDEPTH;
  using AFrag = bft::Operand<T, wmma::matrix_a, wmma::row_major>;
  using BFrag = bft::Operand<T, wmma::matrix_b, wmma::row_major>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[THREADS / 32];
  T* xs_base = reinterpret_cast<T*>(smem);
  T* ws_base = xs_base + 2 * XS_STAGE;
  float* cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_m = warp & 7, warp_n = warp >> 3;
  const int tile_n = blockIdx.x, tile_m = blockIdx.y, t = blockIdx.z;
  const Block<T> b{x, mu, rho, M, K, N, tile_m * BM, tile_n * BN, H * t};
  const uint32_t seed = static_cast<uint32_t>(seeds[t]);
  // compile-time false in the NONE instance, which emits no log-probs
  const bool do_lp = PRIOR != bft::NONE && tile_m == 0;
  const uint32_t col_strip = static_cast<uint32_t>(b.n0 / bft::UNIT_N);
  const int c_unit0 = b.n0 % bft::UNIT_N;
  const int rr = tid >> 5, c = 2 * (tid & 31);  // this thread's W elements
  // number of K steps: whole units, then the steps of the last one below K
  const int full = K / bft::UNIT_K, rem = K - full * bft::UNIT_K;
  const int n_steps = full * 8 + min(8, (rem + BKH - 1) / BKH);

  bft::Acc<T> acc[H][IM][2];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < IM; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[h][i][j], 0.0f);

  float q_acc = 0.0f, p_acc = 0.0f, p1_acc = 0.0f, ls_acc = 0.0f;
  const size_t KN = static_cast<size_t>(K) * N;

  // Regenerate this thread's four elements of the W (pair) of step s from
  // the prefetched mu / rho and write them (type T) into the stage's W tiles.
  auto gen = [&](int s, const float (&m)[4], const float (&r)[4], T* ws) {
    const int kc = step_kc(s), ks = kc + bft::UNIT_K / 2;
    float z[4];
    bft::unit_normals4(seed, static_cast<uint32_t>(s >> 3), col_strip,
                       (s & 7) * BKH + rr, c_unit0 + c, z);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int krow = ((e < 2) ? kc : ks) + rr;
      const int trow = (e < 2) ? rr : BKH + rr;
      const int col = c + (e & 1);
      const int n = b.n0 + col;
      float w0 = 0.0f, w1 = 0.0f;
      if (krow < K && n < N) {
        const float sig = bft::softplus(r[e]);
        const float se = __fmul_rn(sig, z[e]);
        w0 = __fadd_rn(m[e], se);  // bft::sample_w, keeping se for log_p
        if (H == 2) w1 = __fsub_rn(__fmul_rn(2.0f, m[e]), w0);  // 2 mu - w0, as the plain version
        if (do_lp) {
          const size_t idx = static_cast<size_t>(krow) * N + n;
          q_acc += -0.5f * z[e] * z[e];
          if (PRIOR == bft::ON_MU) {
            const float zs = se * inv_sigma_p;
            p_acc += -0.5f * zs * zs;
          } else if (PRIOR == bft::GAUSSIAN) {
            const float pm = prior_mu[idx];
            const float d0 = (w0 - pm) * inv_sigma_p;
            p_acc += -0.5f * d0 * d0;
            if (H == 2) {
              const float d1 = (w1 - pm) * inv_sigma_p;
              p1_acc += -0.5f * d1 * d1;
            }
          } else {
            p_acc += bft::mixture_log_pdf(w0, mix);
            if (H == 2) p1_acc += bft::mixture_log_pdf(w1, mix);
          }
          ls_acc += logf(sig);
          if (w_out != nullptr) {
            w_out[static_cast<size_t>(b.s0) * KN + idx] = from_f32<T>(w0);
            if (H == 2)
              w_out[static_cast<size_t>(b.s0 + 1) * KN + idx] = from_f32<T>(w1);
          }
        }
      }
      ws[trow * WLD + col] = from_f32<T>(w0);
      if (H == 2) ws[(BK + trow) * WLD + col] = from_f32<T>(w1);
    }
  };

  // ---- prologue: stage 0 holds step 0 ----
  float mr[4], rr_[4];
  if (x_vec) {
    load_x_async<H, T>(b, 0, xs_base);
  } else {
    load_x_scalar<H, T>(b, 0, xs_base);
  }
  load_weights(b, 0, mr, rr_);
  gen(0, mr, rr_, ws_base);
  cp_async_wait();
  __syncthreads();

  // ---- main loop: MMAs on stage s & 1 while step s + 1 fills the other ----
  for (int s = 0; s < n_steps; ++s) {
    const int cur = s & 1, nxt = cur ^ 1;
    const bool more = s + 1 < n_steps;
    if (more) {
      // the next x tile streams into the other stage over the MMAs
      if (x_vec) load_x_async<H, T>(b, s + 1, xs_base + nxt * XS_STAGE);
      load_weights(b, s + 1, mr, rr_);
    }
    const T* xs = xs_base + cur * XS_STAGE;
    const T* ws = ws_base + cur * WS_STAGE;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      // the step's sums: straight into acc, or (PROMOTE) into a fresh
      // fragment that is then added to acc in registers
      bft::Acc<T> part[IM][2];
      if (PROMOTE) {
#pragma unroll
        for (int i = 0; i < IM; ++i)
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) wmma::fill_fragment(part[i][jn], 0.0f);
      }
#pragma unroll
      for (int kk = 0; kk < BK; kk += KD) {
        AFrag a[IM];
        BFrag bf[2];
#pragma unroll
        for (int i = 0; i < IM; ++i)
          a[i].load(xs + (h * BM + warp_m * 16 * IM + i * 16) * XLD + kk, XLD);
#pragma unroll
        for (int jn = 0; jn < 2; ++jn)
          bf[jn].load(ws + (h * BK + kk) * WLD + warp_n * 32 + jn * 16, WLD);
#pragma unroll
        for (int i = 0; i < IM; ++i)
#pragma unroll
          for (int jn = 0; jn < 2; ++jn)
            bft::mma(PROMOTE ? part[i][jn] : acc[h][i][jn], a[i], bf[jn]);
      }
      if (PROMOTE) {
#pragma unroll
        for (int i = 0; i < IM; ++i)
#pragma unroll
          for (int jn = 0; jn < 2; ++jn)
#pragma unroll
            for (int e = 0; e < part[i][jn].num_elements; ++e)
              acc[h][i][jn].x[e] = __fadd_rn(acc[h][i][jn].x[e], part[i][jn].x[e]);
      }
    }
    if (more) {
      gen(s + 1, mr, rr_, ws_base + nxt * WS_STAGE);
      if (x_vec) {
        cp_async_wait();
      } else {
        load_x_scalar<H, T>(b, s + 1, xs_base + nxt * XS_STAGE);
      }
    }
    __syncthreads();
  }

  // ---- epilogue: f32 tile through shared memory, T out ----
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if (h) __syncthreads();
#pragma unroll
    for (int i = 0; i < IM; ++i)
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
        wmma::store_matrix_sync(
            cs + (warp_m * 16 * IM + i * 16) * CLD + warp_n * 32 + jn * 16,
            acc[h][i][jn], CLD, wmma::mem_row_major);
    __syncthreads();
    for (int q = tid; q < BM * BN; q += THREADS) {
      const int row = q / BN, col = q % BN;
      const int m = b.m0 + row, n = b.n0 + col;
      if (m < M && n < N)
        y[(static_cast<size_t>(b.s0 + h) * M + m) * N + n] =
            from_f32<T>(cs[row * CLD + col]);
    }
  }

  if (do_lp) {
    float* part = partials + (static_cast<size_t>(t) * gridDim.x + tile_n) * N_PART;
    const float q_sum = block_sum_fixed(q_acc, red);
    if (tid == 0) part[0] = q_sum;
    const float p_sum = block_sum_fixed(p_acc, red);
    if (tid == 0) part[1] = p_sum;
    if (N_PART == 3) {
      const float p1_sum = block_sum_fixed(p1_acc, red);
      if (tid == 0) part[2] = p1_sum;
    }
    if (t == 0) {
      const float l_sum = block_sum_fixed(ls_acc, red);
      if (tid == 0) ls_part[tile_n] = l_sum;
    }
  }
}

// One thread per draw; every sum runs over the column tiles in order. A
// pair's members share log_q, and log_p too when the draw has one (N_LP 1).
template <int H, int N_LP>
__global__ void logprob_finalize(const float* __restrict__ partials,
                                 const float* __restrict__ ls_part,
                                 int n_tiles, int n_draws, float c_q, float c_p,
                                 float* __restrict__ logq,
                                 float* __restrict__ logp) {
  constexpr int N_PART = 1 + N_LP;
  const int t = threadIdx.x;
  if (t >= n_draws) return;
  float ls = 0.0f, q = 0.0f, p[N_LP];
#pragma unroll
  for (int j = 0; j < N_LP; ++j) p[j] = 0.0f;
  for (int i = 0; i < n_tiles; ++i) {
    ls += ls_part[i];
    q += partials[(static_cast<size_t>(t) * n_tiles + i) * N_PART];
#pragma unroll
    for (int j = 0; j < N_LP; ++j)
      p[j] += partials[(static_cast<size_t>(t) * n_tiles + i) * N_PART + 1 + j];
  }
  const float lq = q - ls - c_q;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    logq[H * t + h] = lq;
    logp[H * t + h] = p[N_LP == 1 ? 0 : h] - c_p;
  }
}

template <int H, typename T, int PRIOR>
int launch(const void* x, const void* mu, const void* rho, const void* seeds,
           const void* prior_mu, void* y, void* w_out, void* partials,
           void* ls_part, void* logq, void* logp, int S, int M, int K, int N,
           int x_vec, float inv_sigma_p, float c_q, float c_p, bft::Mixture mix,
           void* stream) {
  constexpr int BM = Smem<H, T>::BM;
  const int n_tiles = (N + BN - 1) / BN;
  const int n_draws = S / H;
  const dim3 grid(n_tiles, (M + BM - 1) / BM, n_draws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (PRIOR == bft::GAUSSIAN && prior_mu == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      bayes_linear_kernel<H, T, PRIOR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<H, T>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  bayes_linear_kernel<H, T, PRIOR><<<grid, THREADS, Smem<H, T>::BYTES, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(mu),
      static_cast<const float*>(rho), static_cast<const int32_t*>(seeds),
      static_cast<const float*>(prior_mu), static_cast<T*>(y),
      static_cast<T*>(w_out), static_cast<float*>(partials),
      static_cast<float*>(ls_part), M, K, N, x_vec, inv_sigma_p, mix);
  err = cudaGetLastError();
  if (err != cudaSuccess || PRIOR == bft::NONE) return static_cast<int>(err);
  logprob_finalize<H, LogP<H, PRIOR>::N_LP><<<1, ((n_draws + 31) / 32) * 32, 0, st>>>(
      static_cast<const float*>(partials), static_cast<const float*>(ls_part),
      n_tiles, n_draws, c_q, c_p, static_cast<float*>(logq),
      static_cast<float*>(logp));
  return static_cast<int>(cudaGetLastError());
}

// The instance of (x's type, prior).
template <int H>
int launch_by_type(int x_f32, int prior, const void* x, const void* mu,
                   const void* rho, const void* seeds, const void* prior_mu,
                   void* y, void* w_out, void* partials, void* ls_part,
                   void* logq, void* logp, int S, int M, int K, int N, int x_vec,
                   float inv_sigma_p, float c_q, float c_p, bft::Mixture mix,
                   void* stream) {
  using bf16 = __nv_bfloat16;
#define BFT_LAUNCH(T, P)                                                          \
  return launch<H, T, P>(x, mu, rho, seeds, prior_mu, y, w_out, partials, ls_part, \
                         logq, logp, S, M, K, N, x_vec, inv_sigma_p, c_q, c_p, mix, \
                         stream)
  switch (prior) {
    case bft::ON_MU:
      if (x_f32) BFT_LAUNCH(float, bft::ON_MU);
      BFT_LAUNCH(bf16, bft::ON_MU);
    case bft::GAUSSIAN:
      if (x_f32) BFT_LAUNCH(float, bft::GAUSSIAN);
      BFT_LAUNCH(bf16, bft::GAUSSIAN);
    case bft::MIXTURE:
      if (x_f32) BFT_LAUNCH(float, bft::MIXTURE);
      BFT_LAUNCH(bf16, bft::MIXTURE);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BFT_LAUNCH
}

}  // namespace

// x (S, M, K) bf16 (x_f32 = 0) or f32 (x_f32 = 1), mu / rho (K, N) f32,
// seeds (S,) i32 (independent) or seeds_half (S/2,) i32 (antithetic), and
// prior_mu (K, N) f32 for prior = GAUSSIAN (else unread, may be null) -> y
// (S, M, N) in x's type, logq / logp (S,) f32 and, when w_out is not null,
// the sampled W (S, K, N) in x's type. prior: ON_MU 0, GAUSSIAN 1,
// MIXTURE 2 (prior.cuh). partials: (n_draws, ceil(N/64), n_part) f32
// scratch, n_part = 3 for a pair under GAUSSIAN or MIXTURE, else 2;
// ls_part: (ceil(N/64),) f32 scratch. inv_sigma_p = 1 / softplus(1);
// c_q = K*N*log(sqrt(2 pi)); c_p = K*N*(log(sqrt(2 pi)) + log(sigma_p))
// under the Gaussian priors and 0 under the mixture, whose log-density
// carries its own; mix_*: the mixture's terms (prior.cuh::Mixture). x_vec:
// x's rows may be copied 16 bytes at a time. Each returns
// cudaGetLastError().
extern "C" int bft_bayes_linear(const void* x, const void* mu, const void* rho,
                                const void* seeds, const void* prior_mu, void* y,
                                void* w_out, void* partials, void* ls_part,
                                void* logq, void* logp, int S, int M, int K,
                                int N, int x_vec, int x_f32, int prior,
                                float inv_sigma_p, float c_q, float c_p,
                                float mix_c1, float mix_c2, float mix_inv_s1,
                                float mix_inv_s2, void* stream) {
  return launch_by_type<1>(x_f32, prior, x, mu, rho, seeds, prior_mu, y, w_out,
                           partials, ls_part, logq, logp, S, M, K, N, x_vec,
                           inv_sigma_p, c_q, c_p,
                           bft::Mixture{mix_c1, mix_c2, mix_inv_s1, mix_inv_s2},
                           stream);
}

extern "C" int bft_bayes_linear_anti(const void* x, const void* mu,
                                     const void* rho, const void* seeds_half,
                                     const void* prior_mu, void* y, void* w_out,
                                     void* partials, void* ls_part, void* logq,
                                     void* logp, int S, int M, int K, int N,
                                     int x_vec, int x_f32, int prior,
                                     float inv_sigma_p, float c_q, float c_p,
                                     float mix_c1, float mix_c2,
                                     float mix_inv_s1, float mix_inv_s2,
                                     void* stream) {
  return launch_by_type<2>(x_f32, prior, x, mu, rho, seeds_half, prior_mu, y,
                           w_out, partials, ls_part, logq, logp, S, M, K, N,
                           x_vec, inv_sigma_p, c_q, c_p,
                           bft::Mixture{mix_c1, mix_c2, mix_inv_s1, mix_inv_s2},
                           stream);
}

// The split op's sampled matmul: x (S, M, K) bf16 (x_f32 = 0) or f32, mu /
// rho (K, N) f32, seeds (S,) i32 -> y[s] = x[s] @ (mu + softplus(rho) eps_s)
// (S, M, N) in x's type, eps_s the unit stream of seeds[s]. Returns
// cudaGetLastError().
extern "C" int bft_sampled_dense(const void* x, const void* mu, const void* rho,
                                 const void* seeds, void* y, int S, int M, int K,
                                 int N, int x_vec, int x_f32, void* stream) {
  const bft::Mixture none{0.0f, 0.0f, 0.0f, 0.0f};
  if (x_f32)
    return launch<1, float, bft::NONE>(x, mu, rho, seeds, nullptr, y, nullptr,
                                       nullptr, nullptr, nullptr, nullptr, S, M, K,
                                       N, x_vec, 0.0f, 0.0f, 0.0f, none, stream);
  return launch<1, __nv_bfloat16, bft::NONE>(
      x, mu, rho, seeds, nullptr, y, nullptr, nullptr, nullptr, nullptr, nullptr, S,
      M, K, N, x_vec, 0.0f, 0.0f, 0.0f, none, stream);
}

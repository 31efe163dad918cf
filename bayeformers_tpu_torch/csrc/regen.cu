// The draw pass: the sampled weights W of a set of draws from their seeds,
// and the forward's log-prob partial sums.
//
// Replaces bayeformers_tpu/ops/fused_linear.py::_fullk_regen_kernel
// (_pallas_fullk_regen), which the reference's non-saved VJPs (_bwd,
// _bwd_anti via _regen / _regen_anti) and sampled_weights call, and
// bayeformers_tpu/ops/sampled_linear.py::_regen_kernel
// (pallas_regenerate_weights), which the split ops' VJPs (sampled_dense's,
// sampled_logprobs') call: on the TPU the two differ by their eps streams
// (unit_eps against the VMEM-tiled tile_eps); the port's split ops draw from
// the one unit stream, so one kernel serves both (bft_regen), S independent
// draws of any mu (flipout's perturbation passes mu = 0), or S antithetic
// pairs (the reference's _regen_anti, interleave included). It is also the
// first stage of the Bayesian linear forward (bft_draw; bayes_linear.cu has
// the second, the product y[s] = x[s] @ W[s]), which on the TPU draws
// inside its matmul kernels (fused_linear.py::_kernel, ::_anti_kernel,
// ::_ktall_kernel, ::_ktall_anti_kernel; sampled_linear.py::_fused_kernel).
// For draw t with seed seeds[t]:
//   w0[k, n] = mu[k, n] + softplus(rho[k, n]) * eps_t[k, n]         (f32)
// on the absolute-unit stream of eps.cuh, with the product and the sum each
// rounded on its own (bft::sample_w): for the same seeds the result equals,
// bit for bit, the plain stream's W (ops/fused_linear.py::sample_weights).
// Independent draws (H = 1) write W[t] = w0; antithetic pairs (H = 2) write
// W[2t] = w0 and W[2t + 1] = 2 mu - w0, rounded as the plain version
// (interleave_antithetic) rounds it. W is written in the forward's operand
// type T (bf16 or f32), rows ``ldw`` elements apart (the product's loads
// want 16-byte rows). bft_regen writes the f32 W and, on request, a bf16
// copy of every member in the same pass (the backward's dx takes g W^T on
// it, the reduce, fused_backward.cu, the f32 W).
//
// Unit offsets (the reference's off_ref, bayes_linear(unit_offsets=)): a
// (K, N) weight that is the shard of a larger layer at element offsets
// (k0, n0), multiples of (256, 128), draws with the units (k_unit0, n_unit0)
// = (k0 / 256, n0 / 128) added to its own: exactly that slice of the whole
// layer's noise. Bounds, log-prob partials and W stay the shard's own.
//
// Log-probs (PRIOR, prior.cuh; NONE writes none): per (draw, column tile of
// 64, row group of 8 unit rows) the sums of -eps^2 / 2 and of the log-prior
// terms of each member that has its own (both of a pair under a prior not
// centred on mu), taken at the f32 w, and per (column tile, row group) the
// sum of log sigma; each a fixed-order block sum. draw_finalize sums them in
// a fixed order (row groups in order within a column tile, then the tiles
// in order) and writes the per-tile sums and log_q / log_p: no float
// atomics, so the log-probs are bit-reproducible for a seed.
//
// Bound on the H100: the writes, and the issue of the exact stream's
// instructions. At K = 3072, N = 768, five f32 pairs (the regenerating
// backward of the f32 recipe's FFN down-projection) it writes 94.4 MB and
// reads mu and rho once (18.9 MB): 0.0338 ms at 3.35 TB/s. The draw is ALU
// work done once per weight element (Philox4x32-10, and per two normals a
// precise log, sqrt and sincos, which must round as the plain stream's
// do): about 265 instructions a Philox call on the code's fast path, so
// one draw of a 3072 x 768 layer takes 0.0047 ms of the 132 SMs' four
// issue slots a clock, and five draws more than the five f32 W's bytes
// (PERF.md, the kernel table). Design: one thread per (unit row r < 128, four
// neighbouring columns): it owns rows r and r + 128 of its unit, which
// share their Box-Muller pairs (eps.cuh), and columns c .. c + 3, two
// Philox calls with one key, so every normal is drawn once. It reads its
// eight mu and rho once, forms the sigmas once and walks its draws, writing
// per draw, row and member four weights in one 16-byte store (8 bytes in
// bf16) where the rows allow: a warp writes a whole 512-byte row of a unit
// strip. A block of 256 threads covers 8 unit rows (16 weight rows) of one
// 128-column unit strip; its log-prob partials are summed per half warp,
// one 64-column tile each. A small layer's draws are split into chunks
// (gridDim.z) until the launch fills the card twice over. The pair
// instance writes both members (and their bf16 copies) from the one draw,
// so the regenerating backward reads the interleaved pairs that one launch
// wrote.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "eps.cuh"
#include "mma.cuh"
#include "prior.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int COLS = 4;                    // columns of a thread: two Philox calls
constexpr int BLOCK_N = 32 * COLS;         // columns of a block: one unit strip
constexpr int TILE_N = 64;                 // columns of a log-prob partial: half a warp
constexpr int GROUP_ROWS = THREADS / 32;   // unit rows of a block
constexpr int GROUPS_PER_UNIT = bft::UNIT_K / 2 / GROUP_ROWS;
constexpr int ELEMS = 2 * COLS;            // a thread's weights: two rows of four
static_assert(BLOCK_N == bft::UNIT_N, "a block's columns are one unit strip");
static_assert(2 * TILE_N == BLOCK_N, "a half warp's columns are one partial's tile");

// Log-prob partials per (draw, column tile, row group): log_q, then one
// log_p per member that has its own (a pair under a prior not centred on mu).
template <int H, int PRIOR>
struct LogP {
  static constexpr int N_LP = (H == 2 && PRIOR != bft::ON_MU) ? 2 : 1;
  static constexpr int N_PART = 1 + N_LP;
};

// Fixed-order sums of v over each half warp (the 16 threads of one 64-column
// tile), then over the block's warps in order: thread h < 2 returns the sum
// of tile 2 blockIdx.x + h.
__device__ __forceinline__ float tile_sums_fixed(float v, float* red) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o, 16);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if ((lane & 15) == 0) red[2 * warp + (lane >> 4)] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x < 2) {
    for (int i = 0; i < THREADS / 32; ++i) s += red[2 * i + threadIdx.x];
  }
  return s;
}

// Four neighbouring weights of one row (``n`` of them in the matrix), in
// one store where the row's alignment allows (``vec``).
template <typename T>
__device__ __forceinline__ void store4(T* dst, const float* v, int n, bool vec) {
  if (vec && n == COLS) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&a);
      u.y = *reinterpret_cast<const uint32_t*>(&b);
      *reinterpret_cast<uint2*>(dst) = u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < COLS; ++i)
      if (i < n) dst[i] = bft::from_f32<T>(v[i]);
  }
}

// H members per draw: draw t (seed seeds[t]) writes W[H t .. H t + H - 1];
// LO: also a bf16 copy of each member, w_lo, rows ldw apart (bft_regen's
// second output). (k_unit0, n_unit0): the shard's unit offsets. vec: W's
// (and w_lo's) rows take 4-element stores.
template <int H, typename T, int PRIOR, bool LO = false>
__global__ void __launch_bounds__(THREADS)
draw_kernel(const float* __restrict__ mu, const float* __restrict__ rho,
            const int32_t* __restrict__ seeds, const float* __restrict__ prior_mu,
            T* __restrict__ w, float* __restrict__ partials,
            float* __restrict__ ls_part, int n_draws, int K, int N, int ldw,
            int k_unit0, int n_unit0, bool vec, float inv_sigma_p, bft::Mixture mix,
            __nv_bfloat16* __restrict__ w_lo) {
  constexpr int N_PART = LogP<H, PRIOR>::N_PART;
  constexpr bool LP = PRIOR != bft::NONE;
  __shared__ float red[2 * (THREADS / 32)];
  const int half = bft::UNIT_K / 2;
  const int group = blockIdx.y;
  const int u = group / GROUPS_PER_UNIT;
  const int rr = (group % GROUPS_PER_UNIT) * GROUP_ROWS + (threadIdx.x >> 5);
  const int cc = COLS * (threadIdx.x & 31);  // column in the unit strip
  const int c = blockIdx.x * BLOCK_N + cc;
  const int krow[2] = {u * bft::UNIT_K + rr, u * bft::UNIT_K + rr + half};
  const uint32_t k_chunk = static_cast<uint32_t>(u + k_unit0);
  const uint32_t strip = static_cast<uint32_t>(blockIdx.x + n_unit0);
  const int n_groups = gridDim.y, n_tiles = (N + TILE_N - 1) / TILE_N;
  const int tile = 2 * blockIdx.x + static_cast<int>(threadIdx.x);  // threads 0, 1
  const int n_in = N - c < COLS ? N - c : COLS;  // this thread's columns in W
  // this block's draws: chunk blockIdx.z of gridDim.z (draw_chunks)
  const int t0 = static_cast<int>(blockIdx.z * n_draws / gridDim.z);
  const int t1 = static_cast<int>((blockIdx.z + 1) * n_draws / gridDim.z);

  // element e: row krow[e / COLS], column c + e % COLS
  float m[ELEMS], sig[ELEMS], pm[ELEMS];
  bool ok[ELEMS];
  float ls = 0.0f;
#pragma unroll
  for (int e = 0; e < ELEMS; ++e) {
    const int k = krow[e / COLS], j = e % COLS;
    ok[e] = k < K && j < n_in;
    m[e] = sig[e] = pm[e] = 0.0f;
    if (ok[e]) {
      const size_t idx = static_cast<size_t>(k) * N + c + j;
      m[e] = mu[idx];
      sig[e] = bft::softplus(rho[idx]);
      if (PRIOR == bft::GAUSSIAN) pm[e] = prior_mu[idx];
      if (LP) ls += logf(sig[e]);
    }
  }
  if (LP && ls_part != nullptr && blockIdx.z == 0) {
    const float s = tile_sums_fixed(ls, red);
    if (threadIdx.x < 2 && tile < n_tiles)
      ls_part[static_cast<size_t>(tile) * n_groups + group] = s;
  }
  const size_t KN = static_cast<size_t>(K) * ldw;
  for (int t = t0; t < t1; ++t) {
    // unit_normals4's order at column x: {cos x, cos x + 1, sin x, sin x + 1}
    const uint32_t seed = static_cast<uint32_t>(seeds[t]);
    float a[4], b[4];
    bft::unit_normals4(seed, k_chunk, strip, rr, cc, a);
    bft::unit_normals4(seed, k_chunk, strip, rr, cc + 2, b);
    const float z[ELEMS] = {a[0], a[1], b[0], b[1], a[2], a[3], b[2], b[3]};
    float w0[ELEMS], w1[ELEMS];
    float q = 0.0f, p0 = 0.0f, p1 = 0.0f;
#pragma unroll
    for (int e = 0; e < ELEMS; ++e) {
      const float se = __fmul_rn(sig[e], z[e]);
      w0[e] = __fadd_rn(m[e], se);  // bft::sample_w, keeping se for log_p
      w1[e] = __fsub_rn(__fmul_rn(2.0f, m[e]), w0[e]);  // 2 mu - w0, as the plain version
      if (LP && ok[e]) {
        q += -0.5f * z[e] * z[e];
        if (PRIOR == bft::ON_MU) {
          const float zs = se * inv_sigma_p;
          p0 += -0.5f * zs * zs;
        } else if (PRIOR == bft::GAUSSIAN) {
          const float d0 = (w0[e] - pm[e]) * inv_sigma_p;
          p0 += -0.5f * d0 * d0;
          if (H == 2) {
            const float d1 = (w1[e] - pm[e]) * inv_sigma_p;
            p1 += -0.5f * d1 * d1;
          }
        } else {
          p0 += bft::mixture_log_pdf(w0[e], mix);
          if (H == 2) p1 += bft::mixture_log_pdf(w1[e], mix);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = krow[r];
      if (k >= K || n_in <= 0) continue;
      const size_t off = static_cast<size_t>(H) * t * KN + static_cast<size_t>(k) * ldw + c;
      store4(w + off, w0 + COLS * r, n_in, vec);
      if (H == 2) store4(w + off + KN, w1 + COLS * r, n_in, vec);
      if constexpr (LO) {
        store4(w_lo + off, w0 + COLS * r, n_in, vec);
        if (H == 2) store4(w_lo + off + KN, w1 + COLS * r, n_in, vec);
      }
    }
    if (LP && partials != nullptr) {
      float* part =
          partials + ((static_cast<size_t>(t) * n_tiles + tile) * n_groups + group) * N_PART;
      const bool own = threadIdx.x < 2 && tile < n_tiles;
      const float qs = tile_sums_fixed(q, red);
      if (own) part[0] = qs;
      const float ps = tile_sums_fixed(p0, red);
      if (own) part[1] = ps;
      if (N_PART == 3) {
        const float p1s = tile_sums_fixed(p1, red);
        if (own) part[2] = p1s;
      }
    }
  }
}

// One block per draw. Each thread sums a column tile's row groups in order
// into the per-tile partials (tile_part, n_part each) and the tile's log
// sigma; thread 0 then sums the tiles in order and writes log_q / log_p of
// the draw's members (a pair shares log_q, and log_p too when the draw has
// one, N_LP = 1). Dynamic shared memory: n_tiles * (N_PART + 1) floats.
template <int H, int N_LP>
__global__ void draw_finalize_kernel(const float* __restrict__ partials,
                                     const float* __restrict__ ls_part,
                                     float* __restrict__ tile_part, int n_tiles,
                                     int n_groups, float c_q, float c_p,
                                     float* __restrict__ logq, float* __restrict__ logp) {
  constexpr int N_PART = 1 + N_LP;
  extern __shared__ float tile_sums[];
  const int t = blockIdx.x;
  float* tp = tile_part + static_cast<size_t>(t) * n_tiles * N_PART;
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
    const float* src = partials + (static_cast<size_t>(t) * n_tiles + i) * n_groups * N_PART;
    const float* ls = ls_part + static_cast<size_t>(i) * n_groups;
    float s[N_PART];
#pragma unroll
    for (int j = 0; j < N_PART; ++j) s[j] = 0.0f;
    float lt = 0.0f;
    for (int gidx = 0; gidx < n_groups; ++gidx) {
#pragma unroll
      for (int j = 0; j < N_PART; ++j) s[j] += src[gidx * N_PART + j];
      lt += ls[gidx];
    }
#pragma unroll
    for (int j = 0; j < N_PART; ++j) {
      tp[i * N_PART + j] = s[j];
      tile_sums[i * (N_PART + 1) + j] = s[j];
    }
    tile_sums[i * (N_PART + 1) + N_PART] = lt;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float ls = 0.0f, q = 0.0f, p[N_LP];
#pragma unroll
  for (int j = 0; j < N_LP; ++j) p[j] = 0.0f;
  for (int i = 0; i < n_tiles; ++i) {
    const float* ts = tile_sums + i * (N_PART + 1);
    ls += ts[N_PART];
    q += ts[0];
#pragma unroll
    for (int j = 0; j < N_LP; ++j) p[j] += ts[1 + j];
  }
  const float lq = q - ls - c_q;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    logq[H * t + h] = lq;
    logp[H * t + h] = p[N_LP == 1 ? 0 : h] - c_p;
  }
}

dim3 draw_grid(int K, int N) {
  const int ku = (K + bft::UNIT_K - 1) / bft::UNIT_K;
  return dim3((N + BLOCK_N - 1) / BLOCK_N, ku * GROUPS_PER_UNIT);
}

// The draw chunks of a launch (gridDim.z): as few as fill the card twice
// over with this instance's resident blocks, at most one a draw. A small
// layer's (S, 768, 768) draws otherwise fill half of the card's thread slots
// for the whole launch; each chunk's threads form their sigmas again.
template <int H, typename T, int PRIOR, bool LO>
unsigned draw_chunks(dim3 g, int n_draws) {
  static int resident = 0;  // blocks of this instance that the card holds at once
  if (resident == 0) {
    int per_sm = 0, dev = 0, n_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, draw_kernel<H, T, PRIOR, LO>,
                                                  THREADS, 0);
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    resident = per_sm * n_sm > 0 ? per_sm * n_sm : 1;
  }
  const long long base = static_cast<long long>(g.x) * g.y;
  const long long want = (2LL * resident + base - 1) / base;
  return static_cast<unsigned>(want < n_draws ? want : n_draws);
}

// Whether rows ldw elements apart from w (and w_lo) take 4-element stores.
bool vec_rows(const void* w, const void* w_lo, int ldw, size_t elem) {
  const size_t a = COLS * elem;
  return ldw % COLS == 0 && reinterpret_cast<uintptr_t>(w) % a == 0 &&
         reinterpret_cast<uintptr_t>(w_lo) % (COLS * 2) == 0;
}

template <int H, typename T, int PRIOR, bool LO = false>
int launch_draw(const void* mu, const void* rho, const void* seeds, const void* prior_mu,
                void* w, void* partials, void* ls_part, int n_draws, int K, int N,
                int ldw, int k_unit0, int n_unit0, float inv_sigma_p, bft::Mixture mix,
                cudaStream_t st, void* w_lo = nullptr) {
  if (PRIOR == bft::GAUSSIAN && prior_mu == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 g = draw_grid(K, N);
  g.z = draw_chunks<H, T, PRIOR, LO>(g, n_draws);
  draw_kernel<H, T, PRIOR, LO><<<g, THREADS, 0, st>>>(
      static_cast<const float*>(mu), static_cast<const float*>(rho),
      static_cast<const int32_t*>(seeds), static_cast<const float*>(prior_mu),
      static_cast<T*>(w), static_cast<float*>(partials), static_cast<float*>(ls_part),
      n_draws, K, N, ldw, k_unit0, n_unit0, vec_rows(w, w_lo, ldw, sizeof(T)), inv_sigma_p,
      mix, static_cast<__nv_bfloat16*>(w_lo));
  return static_cast<int>(cudaGetLastError());
}

template <int H, typename T>
int launch_draw_prior(int prior, const void* mu, const void* rho, const void* seeds,
                      const void* prior_mu, void* w, void* partials, void* ls_part,
                      int n_draws, int K, int N, int ldw, int k_unit0, int n_unit0,
                      float inv_sigma_p, bft::Mixture mix, cudaStream_t st) {
#define BFT_DRAW(P)                                                                   \
  return launch_draw<H, T, P>(mu, rho, seeds, prior_mu, w, partials, ls_part, n_draws, \
                              K, N, ldw, k_unit0, n_unit0, inv_sigma_p, mix, st)
  switch (prior) {
    case bft::ON_MU: BFT_DRAW(bft::ON_MU);
    case bft::GAUSSIAN: BFT_DRAW(bft::GAUSSIAN);
    case bft::MIXTURE: BFT_DRAW(bft::MIXTURE);
    case bft::NONE: BFT_DRAW(bft::NONE);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BFT_DRAW
}

bool bad_offsets(int k_unit0, int n_unit0) {
  return k_unit0 < 0 || n_unit0 < 0 || k_unit0 >= (1 << 16) || n_unit0 >= (1 << 16);
}

}  // namespace

// mu / rho (K, N) f32, seeds (S,) i32 -> w (H S, K, N) f32, the draws of
// seeds on the unit stream at the unit offsets (k_unit0, n_unit0): H = 2
// (pair != 0) the antithetic pairs W[2t] = w0, W[2t + 1] = 2 mu - w0, else
// H = 1; and, when w_lo is not null, the same W rounded to bf16 into w_lo
// (H S, K, N) in the same pass. Returns cudaGetLastError().
extern "C" int bft_regen(const void* mu, const void* rho, const void* seeds,
                         void* w, void* w_lo, int S, int K, int N, int pair,
                         int k_unit0, int n_unit0, void* stream) {
  if (S < 1 || K < 1 || N < 1 || bad_offsets(k_unit0, n_unit0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bft::Mixture none{0.0f, 0.0f, 0.0f, 0.0f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BFT_REGEN(H, LO)                                                                \
  return launch_draw<H, float, bft::NONE, LO>(mu, rho, seeds, nullptr, w, nullptr, nullptr, \
                                              S, K, N, N, k_unit0, n_unit0, 0.0f, none, st, \
                                              w_lo)
  if (pair) {
    if (w_lo == nullptr) BFT_REGEN(2, false);
    BFT_REGEN(2, true);
  }
  if (w_lo == nullptr) BFT_REGEN(1, false);
  BFT_REGEN(1, true);
#undef BFT_REGEN
}

// The forward's draw pass: mu / rho (K, N) f32, seeds (n_draws,) i32 and,
// for prior GAUSSIAN, prior_mu (K, N) f32 -> w (H n_draws, K, ldw) in bf16
// (w_f32 = 0) or f32, H = 2 for antithetic pairs (W[2t], W[2t+1] = 2 mu -
// W[2t]) or 1, drawn at the unit offsets (k_unit0, n_unit0), and for prior
// ON_MU (0), GAUSSIAN (1) or MIXTURE (2) the partial sums (n_draws,
// ceil(N/64), n_groups, n_part) f32 (n_part 3 for a pair under GAUSSIAN or
// MIXTURE, else 2; n_groups = ceil(K/256) * 16) and, when ls_part is not
// null, the log-sigma sums (ceil(N/64), n_groups); prior NONE (3) writes W
// only. inv_sigma_p = 1 / softplus(1); mix_*: the mixture's terms
// (prior.cuh::Mixture). Returns cudaGetLastError().
extern "C" int bft_draw(const void* mu, const void* rho, const void* seeds,
                        const void* prior_mu, void* w, void* partials, void* ls_part,
                        int n_draws, int K, int N, int ldw, int pair, int w_f32,
                        int prior, int k_unit0, int n_unit0, float inv_sigma_p,
                        float mix_c1, float mix_c2, float mix_inv_s1, float mix_inv_s2,
                        void* stream) {
  if (n_draws < 1 || K < 1 || N < 1 || ldw < N || bad_offsets(k_unit0, n_unit0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bft::Mixture mix{mix_c1, mix_c2, mix_inv_s1, mix_inv_s2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define BFT_ARGS                                                                    \
  prior, mu, rho, seeds, prior_mu, w, partials, ls_part, n_draws, K, N, ldw, k_unit0, \
      n_unit0, inv_sigma_p, mix, st
  if (pair) {
    if (w_f32) return launch_draw_prior<2, float>(BFT_ARGS);
    return launch_draw_prior<2, bf16>(BFT_ARGS);
  }
  if (w_f32) return launch_draw_prior<1, float>(BFT_ARGS);
  return launch_draw_prior<1, bf16>(BFT_ARGS);
#undef BFT_ARGS
}

// Sums bft_draw's partials in a fixed order: tile_part (n_draws,
// ceil(N/64), n_part) the per-tile sums, logq / logp (H n_draws,) f32 with
// the constants c_q = K N log sqrt(2 pi) and c_p (K N (log sqrt(2 pi) + log
// sigma_p) under the Gaussian priors, 0 under the mixture). n_lp: 2 for a
// pair under GAUSSIAN or MIXTURE, else 1. Returns cudaGetLastError().
extern "C" int bft_draw_finalize(const void* partials, const void* ls_part, void* tile_part,
                                 void* logq, void* logp, int n_draws, int K, int N,
                                 int pair, int n_lp, float c_q, float c_p, void* stream) {
  const int n_tiles = (N + TILE_N - 1) / TILE_N;
  const int n_groups = static_cast<int>(draw_grid(K, N).y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(partials);
  const float* ls = static_cast<const float*>(ls_part);
  float* tp = static_cast<float*>(tile_part);
  float* lq = static_cast<float*>(logq);
  float* lp = static_cast<float*>(logp);
  const int threads = n_tiles < 256 ? ((n_tiles + 31) / 32) * 32 : 256;
  const size_t shm = static_cast<size_t>(n_tiles) * (n_lp + 2) * sizeof(float);
  if (pair && n_lp == 2) {
    draw_finalize_kernel<2, 2><<<n_draws, threads, shm, st>>>(pa, ls, tp, n_tiles, n_groups,
                                                              c_q, c_p, lq, lp);
  } else if (pair) {
    draw_finalize_kernel<2, 1><<<n_draws, threads, shm, st>>>(pa, ls, tp, n_tiles, n_groups,
                                                              c_q, c_p, lq, lp);
  } else {
    draw_finalize_kernel<1, 1><<<n_draws, threads, shm, st>>>(pa, ls, tp, n_tiles, n_groups,
                                                              c_q, c_p, lq, lp);
  }
  return static_cast<int>(cudaGetLastError());
}

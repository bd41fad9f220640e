// The fused MCLMC trajectory as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel blackjax_tpu/ops/fused_mclmc.py:_mclmc_kernel
// (launched by fused_mclmc, pallas_call at fused_mclmc.py:301), for the
// hierarchical, Gaussian and logistic-regression targets (the fused
// leapfrog's, fused_leapfrog.py:237-400). The Python wrapper and the plain PyTorch
// version of the same trajectory live in blackjax_tpu_torch/ops/fused_mclmc.py.
//
// What it computes, per chain: num_steps unadjusted MCLMC steps. Each step is
// an O-U partial refresh of the unit momentum, the palindromic isokinetic stage
// loop (ESH momentum kicks at even stages, drifts x += (c eps)(m sqrt_imm) and
// a new gradient at odd ones), and a second refresh; then one history value per
// tracked dim. At the end: x, m and the log density. The refresh noise is the
// reference's counter-based threefry2x32 with Box-Muller (_counter_normals),
// keyed by (seed, 0x9E3779B9) on c0 = chain * d_pad + dim and c1 = 2 step
// (before) or 2 step + 1 (after), where d_pad = round_up(d, 128) is the
// reference's lane-padded row: the kernel pads nothing, but counts its lanes as
// the reference does, so both draw the same numbers. refresh = 0 (L = inf)
// skips both refreshes.
//
// Design. The TPU kernel holds a tile of chains in VMEM for the whole
// trajectory. Here one warp runs one chain: lane j holds dims j, j+32, ... in N
// registers per vector (N = 4 for d = 100; d <= 256), so x, m, g and sqrt(imm)
// stay in registers from the first load to the last store. Norms and dot
// products are xor-shuffle warp reductions (analytic_targets.cuh), whose
// butterfly leaves the same bits in every lane, so every branch is
// warp-uniform. The targets' device functions are those of the fused leapfrog
// (analytic_targets.cuh, matrix_targets.cuh); the kernel is a template on N
// and on the target family, as the leapfrog kernel is.
// History values come from the lane that holds the dim by shuffles and are
// stored by lane k for tracked dim k, so a step's K values are one contiguous
// store per chain. The analytic targets run in one of two forms with the
// same bits: the resident form (mclmc_resident, below), which the wrapper
// takes, and the registers form (mclmc_kernel<N, 0>), which it takes where
// asked.
//
// Bound. Device memory sees x and m once in and once out and the (C, S, K)
// history (131 MB at C = 4,096, S = 1,000, K = 8). Per step a lane does
// 2 * N threefry blocks (20 integer rounds each) and as many Box-Muller
// transforms, and a warp does about 13 dependent reductions (three per kick,
// one per refresh, one per hierarchical gradient): the kernel is bound by the
// integer ALU and the latency of those reductions, not by bytes. Logistic
// regression adds two contractions with X per gradient, two gradients per
// McLachlan step: 4 rows x cols FP32 operations a chain and gradient, 7.5 ms
// for 4,096 chains x 64 steps at 4,096 x 54, which bound it. Read by every
// warp on its own, X would cross L2 twice per chain and gradient (935 GB in
// that run): the L2 form spent 150 ms on it.
//
// The tiles form (logistic regression). MCLMC has no tree, no accept step and
// no early exit: every chain runs the same stages in the same order, so the
// kFusedChainsLR warps of a block meet at every gradient without waiting,
// and the block computes it for all of them at once (logreg_tiles in
// matrix_targets.cuh): X streams through a double-buffered ring of tiles in
// shared memory, and each tile serves both contractions of every chain of
// the block, so X crosses L2 once per block and gradient. The kicks, the
// refreshes, the drifts and the history stay one warp's, in registers, with
// the bits of the L2 form. A warp past the last chain of a partial last
// block stays in with x = 0 (its zero inverse mass keeps it there), reaches
// each gradient with the block, and stores nothing.
//
// Numerics. Build without --use_fast_math and with --fmad=false: expf, logf,
// cosf and sqrtf are the accurate library versions and no multiply-add is
// contracted. Every expression keeps the Pallas kernel's operation order
// (fused_mclmc.py:130-198), so the kernel rounds like the plain PyTorch version
// except for the order of its sums and the last ulp of logf and cosf. As in the
// reference, nu = sqrt((exp(2 (0.5 eps) / L) - 1) / d) is written with exp - 1.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "counter_rng.cuh"     // threefry2x32, box_muller
#include "matrix_targets.cuh"  // warp_sum, target_grad, target_logdensity
#include "resident_form.cuh"   // slots_fit_shared, carveout_for, occupancy_of

namespace {

constexpr int kMaxStages = 16;  // palindromic coefficients (Omelyan has 11)

struct Params {
  const float* x0;        // (C, d) initial positions
  const float* m0;        // (C, d) initial unit momenta
  const float* imm;       // (d,) diagonal inverse mass matrix
  const float* inv_var;   // (d,) Gaussian target only, else null
  const int* track;       // (n_track,) tracked dims, each in [0, d)
  float* out_x;           // (C, d) end positions
  float* out_m;           // (C, d) end momenta
  float* out_logdensity;  // (C,) log density at the end positions
  float* out_hist;        // (C, num_steps, n_track) tracked positions
  int C, d, d_pad, num_steps, n_track, target, refresh, n_coef;
  int pool;               // the resident form's steps of refresh noise a pool
  float eps, L;
  uint32_t seed;
  float coef[kMaxStages];  // kicks at even stages, drifts at odd ones
  float dt[kMaxStages];    // coef[i] * eps, rounded as the kernel rounds it
  MatrixData mat;          // logistic regression's tiles of X, y, else zeros
};

// NaN-propagating max, as jnp.maximum (fmaxf would drop a NaN)
__device__ __forceinline__ float nan_max(float v, float floor) {
  return (v >= floor || isnan(v)) ? v : floor;
}

template <int N>
__device__ __forceinline__ float row_norm(const float (&v)[N]) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) s += v[k] * v[k];
  return sqrtf(warp_sum(s));
}

// The overflow-free ESH momentum update (fused_mclmc.py:146-157), in two
// halves: what depends on the gradient and the step alone (the unit
// direction e and the decay zeta), and what the momentum adds to it.
template <int N>
__device__ __forceinline__ void kick_direction(const float (&g)[N], const float (&sqrt_imm)[N],
                                               float dt, float dims, float (&e)[N],
                                               float& zeta) {
  float gw[N];
#pragma unroll
  for (int k = 0; k < N; ++k) gw[k] = g[k] * sqrt_imm[k];
  const float grad_norm = row_norm<N>(gw);
  const float scale = nan_max(grad_norm, 1e-30f);
#pragma unroll
  for (int k = 0; k < N; ++k) e[k] = gw[k] / scale;
  const float delta = dt * grad_norm / (dims - 1.0f);
  zeta = expf(-delta);
}

template <int N>
__device__ __forceinline__ void kick_momentum(float (&m)[N], const float (&e)[N], float zeta) {
  float pr = 0.f, unnorm[N];
#pragma unroll
  for (int k = 0; k < N; ++k) pr += m[k] * e[k];
  const float proj = warp_sum(pr);
  const float a = (1.0f - zeta) * (1.0f + zeta + proj * (1.0f - zeta));
  const float b = 2.0f * zeta;
#pragma unroll
  for (int k = 0; k < N; ++k) unnorm[k] = e[k] * a + b * m[k];
  const float norm = nan_max(row_norm<N>(unnorm), 1e-30f);
#pragma unroll
  for (int k = 0; k < N; ++k) m[k] = unnorm[k] / norm;
}

template <int N>
__device__ __forceinline__ void kick(float (&m)[N], const float (&g)[N],
                                     const float (&sqrt_imm)[N], float dt, float dims) {
  float e[N], zeta;
  kick_direction<N>(g, sqrt_imm, dt, dims, e, zeta);
  kick_momentum<N>(m, e, zeta);
}

// The O-U refresh on the sphere (fused_mclmc.py:159-162): m + nu z, renormed.
template <int N>
__device__ __forceinline__ void ou_refresh(const Params& p, float (&m)[N],
                                           uint32_t row_base, uint32_t stream,
                                           float nu, int lane) {
  float noisy[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    float z = 0.f;
    if (j < p.d) {
      uint32_t b1, b2;
      threefry2x32(p.seed, kKey1, row_base + (uint32_t)j, stream, b1, b2);
      z = box_muller(b1, b2);
    }
    noisy[k] = m[k] + nu * z;
  }
  const float norm = nan_max(row_norm<N>(noisy), 1e-30f);
#pragma unroll
  for (int k = 0; k < N; ++k) m[k] = noisy[k] / norm;
}

template <int N, int F>
__global__ void __launch_bounds__(fused_block_warps<F>() * 32) mclmc_kernel(const Params p) {
  constexpr bool kTiles = F == kLogisticRegression;
  extern __shared__ __align__(16) float smem[];  // the tiles form's ring of tiles
  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x * fused_block_warps<F>() + (threadIdx.x >> 5);
  const bool present = chain < p.C;
  if (!kTiles && !present) return;  // the whole warp leaves together
  const size_t row = (size_t)chain * p.d;

  // pad dims (j >= d), and every dim of a warp past the last chain, hold
  // zeros and a zero inverse mass, so they stay zero
  float x[N], m[N], g[N], sqrt_imm[N], iv[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    const bool valid = present && j < p.d;
    x[k] = valid ? p.x0[row + j] : 0.f;
    m[k] = valid ? p.m0[row + j] : 0.f;
    sqrt_imm[k] = sqrtf(valid ? p.imm[j] : 0.f);
    iv[k] = (valid && p.inv_var != nullptr) ? p.inv_var[j] : 0.f;
  }
  const float dims = (float)p.d;
  // O-U magnitude for a half deterministic step (fused_mclmc.py:135)
  const float nu =
      p.refresh ? sqrtf((expf(2.0f * (0.5f * p.eps) / p.L) - 1.0f) / dims) : 0.f;
  // the chain's counter row: the reference's c0 = (chain_base + row) * d_pad
  const uint32_t row_base = (uint32_t)chain * (uint32_t)p.d_pad;

  target_grad<N, F, kTiles>(p, x, iv, g, lane, smem);
  for (int s = 0; s < p.num_steps; ++s) {
    if (p.refresh) ou_refresh<N>(p, m, row_base, 2u * (uint32_t)s, nu, lane);
    for (int i = 0; i < p.n_coef; ++i) {
      const float ce = p.coef[i] * p.eps;
      if (i % 2 == 0) {
        kick<N>(m, g, sqrt_imm, ce, dims);
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) x[k] = x[k] + ce * (m[k] * sqrt_imm[k]);
        target_grad<N, F, kTiles>(p, x, iv, g, lane, smem);
      }
    }
    if (p.refresh) ou_refresh<N>(p, m, row_base, 2u * (uint32_t)s + 1u, nu, lane);

    // lane t stores tracked dim t (in rounds of 32): fetch x[dim] from the
    // lane that holds it, one shuffle per register
    for (int t0 = 0; t0 < p.n_track; t0 += 32) {
      float* hist = p.out_hist + ((size_t)chain * p.num_steps + s) * p.n_track;
      const int t = t0 + lane;
      const int dim = t < p.n_track ? p.track[t] : 0;
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float held = __shfl_sync(kFull, x[k], dim & 31);
        if ((dim >> 5) == k) v = held;
      }
      if (present && t < p.n_track) hist[t] = v;
    }
  }

  const float ld = target_logdensity<N, F, kTiles>(p, x, iv, lane, smem);
  if (!present) return;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    if (j < p.d) {
      p.out_x[row + j] = x[k];
      p.out_m[row + j] = m[k];
    }
  }
  if (lane == 0) p.out_logdensity[chain] = ld;
}

// A block of the tiles form asks for more than the 48 KB default of shared
// memory through the attribute; a refusal comes back to the wrapper, which
// raises.
template <int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.target == kLogisticRegression) {
    const size_t smem = fused_lr_block_bytes<N>(p.mat.cols);
    const auto kernel = mclmc_kernel<N, kLogisticRegression>;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    constexpr int kBlock = fused_block_warps<kLogisticRegression>();
    kernel<<<(p.C + kBlock - 1) / kBlock, kBlock * 32, smem, stream>>>(p);
  } else {
    mclmc_kernel<N, 0>
        <<<(p.C + kFusedWarps - 1) / kFusedWarps, kFusedWarps * 32, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

// ---- the resident form (mclmc_resident): the analytic targets ----
//
// Built for the flagship's 4,096 chains in one wave on 132 SMs: 32 warps an
// SM at N = 4, so that no chain waits for another to end, with the
// registers that leaves (64 a thread). At N <= 4 a block is the SM's 32
// warps, and they meet once a pool (block_step): a warp that ran ahead of
// the others would end early and leave the SM's last steps to too few warps
// to hide their latency. It gives the registers form's bits: every sum in
// its order, every normal with its key.
//
// The refresh noise is drawn ahead, densely. The draws depend on nothing of
// the chain's state, so once every P steps the warp draws the 2 P d normals
// of the next P steps' refreshes in one pass over all 32 lanes (PoolWalk)
// into its pool in shared memory, each with its own key, and the refreshes
// read them by dim. Drawn per refresh, a lane draws its dims k 32 + lane, and
// at d = 100 the fourth register's block runs on 4 lanes of 32: 128 blocks
// issued for 100 draws. Pooled over P = 4 steps, 800 draws take 25 rounds.
// The pool also takes the draws' 20 dependent rounds off the chain's path.
//
// The stages are unrolled for the port's coefficient sets (S = 3, 5, 7 and
// 11 stages; S = 0 runs the stage loop at run time), and where the first and
// the last coefficient are the same float, the first kick of a step takes
// the last kick's direction and decay from the step before: the same
// gradient and the same step, so the same bits, and one reduction, N
// divisions and an expf fewer a step.

// the warps an SM the form is built for at N registers a lane and vector
// (its launch bound), and the warps a block
template <int N>
__host__ __device__ constexpr int mclmc_resident_warps() { return N <= 4 ? 32 : 20; }
template <int N>
__host__ __device__ constexpr int mclmc_block_warps() {
  return N <= 4 ? mclmc_resident_warps<N>() : 4;
}
// blocks an SM for the launch bound (one where a copy's blocks outsize it)
template <int N>
__host__ __device__ constexpr int mclmc_resident_blocks() {
  return mclmc_resident_warps<N>() > mclmc_block_warps<N>()
             ? mclmc_resident_warps<N>() / mclmc_block_warps<N>()
             : 1;
}

// the most steps of refresh noise a pool holds
constexpr int kMaxPoolSteps = 4;

// the steps a pool holds at width d: the most, up to kMaxPoolSteps, whose
// pools (2 P d floats a warp) fit the SM's resident warps in shared memory
template <int N>
__host__ __device__ constexpr int pool_steps(int d) {
  int steps = kMaxPoolSteps;
  while (steps > 1 &&
         !slots_fit_shared(mclmc_resident_warps<N>(), mclmc_block_warps<N>(), 2 * steps * d))
    steps /= 2;
  return steps;
}

// A warp's walk over a pool of count = 2 P d normals: element i = q d + j
// (q = 2 (step - the pool's first step) + refresh, j the dim) is drawn by
// lane i % 32 in round i / 32 and lands in slot i of the warp's pool. Every
// lane draws in every round but the last; a round moves i by 32 = dq d + dj.
struct PoolWalk {
  int dq, dj, q0, j0;
  __device__ PoolWalk(int d, int lane) : dq(32 / d), dj(32 % d), q0(lane / d), j0(lane % d) {}
  template <class F>
  __device__ __forceinline__ void operator()(int d, int count, int lane, F&& f) const {
    int q = q0, j = j0;
    for (int i = lane; i < count; i += 32) {
      f(i, q, j);
      q += dq;
      j += dj;
      if (j >= d) {
        j -= d;
        ++q;
      }
    }
  }
};

// The normals of steps first .. first + steps - 1 into the warp's pool, each
// keyed as ou_refresh keys it: c0 = the chain's row + dim, c1 = 2 step or
// 2 step + 1.
__device__ __forceinline__ void draw_pool(const Params& p, const PoolWalk& walk, float* pool,
                                          uint32_t row_base, int first, int steps, int lane) {
  __syncwarp();  // every lane has read the last pool
  walk(p.d, 2 * steps * p.d, lane, [&](int i, int q, int j) {
    uint32_t b1, b2;
    threefry2x32(p.seed, kKey1, row_base + (uint32_t)j, 2u * (uint32_t)first + (uint32_t)q, b1,
                 b2);
    pool[i] = box_muller(b1, b2);
  });
  __syncwarp();  // the pool is in place for every lane
}

// The warps of a block meet once a pool: none runs ahead of the others, so
// that an SM keeps all its warps, and their latency hidden, to the end of
// the launch (a warp that ran ahead would leave the last steps to fewer).
__device__ __forceinline__ void block_step(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// The O-U refresh of ou_refresh with its d normals z read from the pool.
template <int N>
__device__ __forceinline__ void pooled_refresh(float (&m)[N], const float* z, int d, float nu,
                                               int lane) {
  float v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    v[k] = m[k] + nu * (j < d ? z[j] : 0.f);
  }
  const float scale = nan_max(row_norm<N>(v), 1e-30f);
#pragma unroll
  for (int k = 0; k < N; ++k) m[k] = v[k] / scale;
}

template <int N, int T, int S>
__global__ void __launch_bounds__(mclmc_block_warps<N>() * 32, mclmc_resident_blocks<N>())
    mclmc_resident(const Params p) {
  constexpr int kBlock = mclmc_block_warps<N>();
  extern __shared__ __align__(16) float pools[];  // 2 P d normals a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chain = blockIdx.x * kBlock + warp;
  if (chain >= p.C) return;  // resident
  // the threads of the block's warps that hold a chain
  const int block_threads = 32 * min(kBlock, p.C - (int)blockIdx.x * kBlock);
  const Analytic<T> tp{p.d};
  const size_t row = (size_t)chain * p.d;

  // pad dims (j >= d) hold zeros and a zero inverse mass, so they stay zero
  float x[N], m[N], g[N], sqrt_imm[N], iv[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    const bool valid = j < p.d;
    x[k] = valid ? p.x0[row + j] : 0.f;
    m[k] = valid ? p.m0[row + j] : 0.f;
    sqrt_imm[k] = sqrtf(valid ? p.imm[j] : 0.f);
    iv[k] = (T == kGaussian && valid) ? p.inv_var[j] : 0.f;
  }
  const float dims = (float)p.d;
  const float nu =
      p.refresh ? sqrtf((expf(2.0f * (0.5f * p.eps) / p.L) - 1.0f) / dims) : 0.f;
  const uint32_t row_base = (uint32_t)chain * (uint32_t)p.d_pad;
  float* pool = pools + (size_t)warp * 2 * p.pool * p.d;
  const PoolWalk walk(p.d, lane);
  const int n_coef = S > 0 ? S : p.n_coef;
  // the first kick of a step is the last kick of the step before where
  // their coefficients are the same float
  const bool reuse = p.coef[0] == p.coef[n_coef - 1];
  float e[N], zeta = 0.f;  // the last kick's direction and decay

  grad<N>(tp, x, iv, g, lane);
  int at = p.pool;  // the step's place in its pool
  for (int s = 0; s < p.num_steps; ++s) {  // resident
    // ---- the pooled draws (resident) ----
    if (at == p.pool) {
      block_step(block_threads);
      if (p.refresh) draw_pool(p, walk, pool, row_base, s, min(p.pool, p.num_steps - s), lane);
      at = 0;
    }
    // ---- the refresh before the stages (resident) ----
    if (p.refresh) pooled_refresh<N>(m, pool + 2 * at * p.d, p.d, nu, lane);
    // ---- the stages (resident) ----
    const auto stage = [&](int i) {
      const float ce = p.dt[i];  // from the parameters: no register holds it
      if (i % 2 == 0) {
        // ---- a kick (resident) ----
        if (i > 0 || s == 0 || !reuse) kick_direction<N>(g, sqrt_imm, ce, dims, e, zeta);
        kick_momentum<N>(m, e, zeta);
        // ---- the kick's end (resident) ----
      } else {
        // ---- a drift and its gradient (resident) ----
#pragma unroll
        for (int k = 0; k < N; ++k) x[k] = x[k] + ce * (m[k] * sqrt_imm[k]);
        grad<N>(tp, x, iv, g, lane);
        // ---- the gradient's end (resident) ----
      }
    };
    if constexpr (S > 0) {
#pragma unroll
      for (int i = 0; i < S; ++i) stage(i);
    } else {
      for (int i = 0; i < n_coef; ++i) stage(i);
    }
    // ---- the refresh after the stages (resident) ----
    if (p.refresh) pooled_refresh<N>(m, pool + (2 * at + 1) * p.d, p.d, nu, lane);
    ++at;
    // ---- the history (resident) ----
    for (int t0 = 0; t0 < p.n_track; t0 += 32) {
      float* hist = p.out_hist + ((size_t)chain * p.num_steps + s) * p.n_track;
      const int t = t0 + lane;
      const int dim = t < p.n_track ? p.track[t] : 0;
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float held = __shfl_sync(kFull, x[k], dim & 31);
        if ((dim >> 5) == k) v = held;
      }
      if (t < p.n_track) hist[t] = v;
    }
    // ---- the step's end (resident) ----
  }

  // ---- final state (resident) ----
  const float ld = logdensity<N>(tp, x, iv, lane);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    if (j < p.d) {
      p.out_x[row + j] = x[k];
      p.out_m[row + j] = m[k];
    }
  }
  if (lane == 0) p.out_logdensity[chain] = ld;
  // ---- the chain's end (resident) ----
}

// the resident form's shared memory a block: its warps' pools
template <int N>
size_t resident_block_bytes(const Params& p) {
  return p.refresh ? (size_t)mclmc_block_warps<N>() * 2 * p.pool * p.d * sizeof(float) : 0;
}

// A refusal of the carveout or of the shared memory comes back to the
// wrapper, which raises.
template <int N, int T, int S>
cudaError_t launch_resident(const Params& p, cudaStream_t stream) {
  constexpr int kBlock = mclmc_block_warps<N>();
  const auto kernel = mclmc_resident<N, T, S>;
  const size_t smem = resident_block_bytes<N>(p);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       carveout_for(smem > 0));
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<(p.C + kBlock - 1) / kBlock, kBlock * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// the stage counts unrolled: the port's coefficient sets (velocity Verlet,
// McLachlan, Yoshida, Omelyan); any other count runs the loop at run time
template <int N, int T>
cudaError_t launch_resident_stages(const Params& p, cudaStream_t stream) {
  switch (p.n_coef) {
    case 3: return launch_resident<N, T, 3>(p, stream);
    case 5: return launch_resident<N, T, 5>(p, stream);
    case 7: return launch_resident<N, T, 7>(p, stream);
    case 11: return launch_resident<N, T, 11>(p, stream);
    default: return launch_resident<N, T, 0>(p, stream);
  }
}

template <int N>
cudaError_t launch_resident_n(Params p, cudaStream_t stream) {
  p.pool = pool_steps<N>(p.d);
  return p.target == kHierarchical ? launch_resident_stages<N, kHierarchical>(p, stream)
                                   : launch_resident_stages<N, kGaussian>(p, stream);
}

// warps an SM, registers and local bytes a thread of the instantiation for
// d in the resident form (McLachlan's, out[3]: its steps a pool) or the
// registers form (out[3] = 0)
template <int N>
int occupancy_n(int d, int target, int form, int* out) {
  if (!form) {
    out[3] = 0;
    return (int)occupancy_of(mclmc_kernel<N, 0>, kFusedWarps, 0, out);
  }
  constexpr int kBlock = mclmc_block_warps<N>();
  out[3] = pool_steps<N>(d);
  const size_t smem = (size_t)kBlock * 2 * out[3] * d * sizeof(float);
  const int carveout = carveout_for(true);
  return (int)(target == kHierarchical
                   ? occupancy_of(mclmc_resident<N, kHierarchical, 5>, kBlock, smem, out, carveout)
                   : occupancy_of(mclmc_resident<N, kGaussian, 5>, kBlock, smem, out, carveout));
}

// The pool's layout through the kernel's own walk, for checks: out[2 i],
// out[2 i + 1] = (q, j) of slot i, -1 where a lane of the last round idles.
__global__ void pool_layout_kernel(int d, int count, int* out) {
  const int lane = threadIdx.x;
  for (int i = lane; i < (count + 31) / 32 * 32; i += 32) out[2 * i] = out[2 * i + 1] = -1;
  PoolWalk(d, lane)(d, count, lane, [&](int i, int q, int j) {
    out[2 * i] = q;
    out[2 * i + 1] = j;
  });
}

// The refresh noise through the kernel's own device functions, for checks:
// element (r, j) of a (rows, d) block, keyed as the kernel keys chain
// chain_base + r.
__global__ void counter_normals_kernel(uint32_t seed, uint32_t chain_base,
                                       uint32_t stream, int rows, int d,
                                       int d_pad, uint32_t* w0, uint32_t* w1,
                                       float* z) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * d) return;
  const uint32_t r = (uint32_t)(i / d), j = (uint32_t)(i % d);
  uint32_t b1, b2;
  threefry2x32(seed, kKey1, (chain_base + r) * (uint32_t)d_pad + j, stream, b1, b2);
  w0[i] = b1;
  w1[i] = b2;
  z[i] = box_muller(b1, b2);
}

int round_up_lanes(int d) { return (d + 127) / 128 * 128; }

}  // namespace

extern "C" {

// Runs the trajectory; returns cudaGetLastError() of the launch (0 = success).
// coefs is a host array of n_coef palindromic coefficients (odd, <= 16). X
// is logistic regression's data matrix as tiles (bjt_fused_tiles_layout in
// the leapfrog's library: rows at the stride shared_x_stride(d), zero padded
// to whole tiles), y its rows labels (rows,), and k0, k1 its 1 /
// prior_scale^2 and -0.5 / prior_scale^2 (null and 0 otherwise). form 1
// launches the resident form (the hierarchical and Gaussian targets only),
// form 0 the registers form, or logistic regression's tiles form.
int bjt_fused_mclmc(const float* x0, const float* m0, const float* imm,
                    const float* inv_var, const float* X,
                    const float* y, const int* track, float* out_x,
                    float* out_m, float* out_logdensity, float* out_hist,
                    const float* coefs, int n_coef, int C, int d, int num_steps,
                    int n_track, int target, int rows, int refresh, int form, float eps,
                    float L, float k0, float k1, uint32_t seed, void* stream) {
  if (target != kHierarchical && target != kGaussian && target != kLogisticRegression)
    return cudaErrorInvalidValue;
  if (target == kGaussian && inv_var == nullptr) return cudaErrorInvalidValue;
  if (target == kLogisticRegression && (X == nullptr || y == nullptr || form != 0))
    return cudaErrorInvalidValue;
  if (n_coef < 1 || n_coef > kMaxStages || n_coef % 2 == 0) return cudaErrorInvalidValue;
  if (n_track > 0 && track == nullptr) return cudaErrorInvalidValue;
  Params p{x0, m0, imm, inv_var, track, out_x, out_m, out_logdensity, out_hist,
           C, d, round_up_lanes(d), num_steps, n_track, target, refresh, n_coef, 0,
           eps, L, seed, {}, {}, {X, nullptr, y, nullptr, rows, d, {k0, k1}}};
  for (int i = 0; i < n_coef; ++i) {
    p.coef[i] = coefs[i];
    p.dt[i] = p.coef[i] * eps;  // one IEEE product, the bits of the kernel's
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0) return cudaSuccess;
  const int n = (d + 31) / 32;
  if (form) {
    if (n <= 1) return launch_resident_n<1>(p, s);
    if (n <= 2) return launch_resident_n<2>(p, s);
    if (n <= 4) return launch_resident_n<4>(p, s);
    if (n <= 8) return launch_resident_n<8>(p, s);
    return cudaErrorInvalidValue;
  }
  if (n <= 1) return launch<1>(p, s);
  if (n <= 2) return launch<2>(p, s);
  if (n <= 4) return launch<4>(p, s);
  if (n <= 8) return launch<8>(p, s);
  return cudaErrorInvalidValue;
}

// Warps an SM, registers, local bytes a thread and steps a pool (0 in the
// registers form) of the analytic target's instantiation for d in form 1
// (resident, McLachlan's) or 0 (registers).
int bjt_fused_mclmc_occupancy(int d, int target, int form, int* out) {
  const int n = (d + 31) / 32;
  if (d < 1 || n > 8 || (target != kHierarchical && target != kGaussian))
    return cudaErrorInvalidValue;
  if (n <= 1) return occupancy_n<1>(d, target, form, out);
  if (n <= 2) return occupancy_n<2>(d, target, form, out);
  if (n <= 4) return occupancy_n<4>(d, target, form, out);
  return occupancy_n<8>(d, target, form, out);
}

// The resident form's pool layout at width d for a pool of steps steps:
// out holds 2 ints a slot, for round_up(2 steps d, 32) slots.
int bjt_mclmc_pool_layout(int d, int steps, int* out, void* stream) {
  if (d < 1 || steps < 1) return cudaErrorInvalidValue;
  pool_layout_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(d, 2 * steps * d, out);
  return cudaGetLastError();
}

// The kernel's counter normals of a (rows, d) block: both threefry words and
// the Box-Muller normal per element.
int bjt_counter_normals(uint32_t seed, uint32_t chain_base, uint32_t stream,
                        int rows, int d, uint32_t* w0, uint32_t* w1, float* z,
                        void* stream_handle) {
  const int n = rows * d;
  if (n <= 0) return cudaSuccess;
  counter_normals_kernel<<<(n + 255) / 256, 256, 0,
                           static_cast<cudaStream_t>(stream_handle)>>>(
      seed, chain_base, stream, rows, d, round_up_lanes(d), w0, w1, z);
  return cudaGetLastError();
}

const char* bjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

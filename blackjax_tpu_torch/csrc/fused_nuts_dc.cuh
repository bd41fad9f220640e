// The continuous NUTS machine as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel blackjax_tpu/ops/fused_nuts_dc.py:_nuts_kernel_dc
// (launched by fused_nuts_run_dc, pallas_call at fused_nuts_dc.py:964), for the
// diagonal, dense and low-rank metrics (fused_nuts_dc.py:253-284, operands at
// :837-893) and five targets: the hierarchical and Gaussian targets, and the
// matrix targets of blackjax_tpu/ops/targets_dc.py (logistic regression, the
// Finnish horseshoe, eight schools), whose device functions are in
// matrix_targets.cuh. The Python wrapper and the plain PyTorch version of the
// same machine live in blackjax_tpu_torch/ops/fused_nuts_dc.py.
//
// This header holds the machine, a template on the metric; each metric's
// instantiations are built from a source of their own, which defines
// BJT_DC_METRIC and includes this header: fused_nuts_dc.cu (kDiag, with the
// threefry export), fused_nuts_dc_dense.cu (kDense), fused_nuts_dc_low_rank.cu
// (kLowRank). The three builds run side by side.
//
// What it computes, per chain: num_steps NUTS transitions, one velocity-Verlet
// leaf per loop iteration, with progressive uniform merging inside a subtree,
// the biased merge across subtrees, checkpointed U-turn slots, the divergence
// threshold, and the inline restart (a chain that closes a transition draws its
// next momentum at the top of the following iteration), all within a budget of
// leaf iterations. Randomness is the reference's counter-based threefry2x32,
// keyed exactly as the Pallas kernel keys it, so both draw the same numbers.
// The reference's pack and restart_every only move the budget's accounting:
// each chain gets a budget of its own (the wrapper derives the lane schedule)
// and restarts only on iterations of its clock that restart_every divides.
//
// Design. The TPU kernel runs 128 chains in lockstep on (d_pad, 128) tiles. Here
// chains are independent: one warp runs one chain. Lane j holds dims j, j+32,
// j+64, ... in N registers per vector (N = 4 for d = 100, 13 for the horseshoe's
// d = 404; d <= 512). Per-chain scalars are replicated in all 32 lanes, so every
// branch is warp-uniform and the machine's selects become plain branches. Dot
// products are xor-shuffle reductions, whose butterfly leaves the same bits in
// every lane. The kernel is a template on N, on the target family and on the
// metric, so the analytic targets' instantiations carry no code of the matrix
// targets, and the diagonal metric's none of the others.
//
// Two forms run the analytic targets (the hierarchical and Gaussian ones).
// The resident form (nuts_dc_resident, a template on the target too), which
// the wrapper launches up to N = 8 for the diagonal and low-rank metrics (at
// N = 8 for the dense one), is built for as many warps an SM as
// resident_warps says (20 at N = 4: the flagship's 4,096 chains on 2,640 warp
// slots), and for a
// short dependent chain per leaf, since the launch ends with its slowest chain
// (2.3 times the mean's leaves on the flagship) running nearly alone. It keeps
// in registers only the leaf's x, m, g and w (updated in place), the
// subtree's momentum sum and M^{-1}; the accepted state, the proposal, the
// trajectory's two ends and its momentum sum, which a transition touches only
// at restarts and subtree boundaries, live in a per-chain scratch in device
// memory (ColdVec, 6.5 KB a chain at N = 4, which stays in L2); the checkpoint
// slots and the subtree's sample live in shared memory where the SM's blocks
// fit them (resident_slots_shared), else beside the rest. A leaf draws one
// threefry block before its gradient, so that its rounds overlap it (the
// merge's uniform, or on a subtree's first leaf the next subtree's block, so
// that no subtree waits for its draw); the energy's sum and every U-turn
// check's sums run their butterflies side by side (the reference ORs every
// slot's check); a subtree that continues in the last one's direction starts
// from the registers. The registers form (nuts_dc_kernel, F = 0: the only one
// from N = 13, and the dense metric's below N = 8) keeps the 20 length-d
// vectors of the chain state (22 with the dense and low-rank metrics' w) in
// registers up to N = 8; from N = 13 the ten that a transition touches only
// at its restarts and subtree boundaries (StateVec) live in device memory,
// which leaves the leaf's hot vectors and the target's gradient the registers
// (255 a thread). Its 2 * max_depth checkpoint slots, indexed by a
// data-dependent slot id, live in shared memory (each lane touches only its
// own dims, so no barrier), and so does a matrix target's per-warp scratch.
// Eight schools (d = 10) under the diagonal metric has a second form, the
// thread form (nuts_dc_thread): one chain a thread, its sums short trees of
// adds in the registers form's association order, so the same bits (see
// the head of its section below). It measured slower than the registers
// form, which the wrapper keeps unless its _EIGHT_SCHOOLS_THREAD is set.
//
// Metrics. The diagonal metric keeps M^{-1} (and, at a restart, the momentum
// scale) per lane in registers and recomputes w = M^{-1} m where a U-turn check
// needs it. The dense and low-rank metrics carry w, as the reference does: the
// endpoints' left_w and right_w in registers, one w per checkpoint slot in
// shared memory beside the slot's m and msum, so that the checks and the
// energy 0.5 w.m stay dot products. A leaf applies M^{-1} twice (to m_half and
// to the new momentum) and a restart applies M^{1/2} once. Dense: the warp
// stages the vector in shared memory and each lane forms its own rows of A v,
// reading A^T (the wrapper uploads M^{-1} and C = L^{-T} transposed) coalesced
// from global memory, where it stays in L2 (11.7 KB at d = 54): d^2 FMAs per
// product. Low-rank: M^{-1} = D (I + U (Lam - 1) U^T) D, with t = U^T y as k
// warp reductions and y + U (s t) lane-local over each lane's rows: about 2 d k
// FMAs per product; sigma stays in registers as the diagonal's M^{-1} does. d
// <= 256 (N <= 8) for both. In the tiles form below, the block copies M^{-1}
// and C^T, or U, lam - 1 and 1 / sqrt(lam) - 1, into shared memory once, where
// they fit (the wrapper's plan), and the products read them there.
//
// The tiles form (logistic regression, whose X of 4,096 x 54, 864 KB, fits no
// block). The kChainsLR warps of a block run their leaves in lockstep: every
// loop iteration is one leaf of every live chain, so the warps meet at one
// gradient per iteration (and one before the loop), which the whole block
// computes at once (logreg_tiles in matrix_targets.cuh): X streams through a
// double-buffered ring in shared memory (cp.async), one tile of rows at a
// time, and each tile serves the forward and the backward contraction of all
// the block's chains, so X crosses L2 once per block and leaf instead of twice
// per chain and leaf. The loop runs until no warp of the block is live
// (__syncthreads_or); a parked, finished or out-of-budget warp, and a warp
// past the last chain of a partial last block, joins each gradient with w = 0
// and ignores its result, so per chain it, budget, steps and iters keep their
// meaning. The checkpoint slots live in device memory (a per-chain scratch,
// cached in L1), which leaves shared memory to the tiles. Lockstep's cost: a
// block runs to its slowest chain; the wrapper's lockstep_idle_share gives the
// share of warp-iterations spent waiting.
//
// Bound. For the analytic targets a leaf is O(d) FP32 multiply-adds for the
// leapfrog, the energy and its slot checks, plus a few accurate
// transcendentals and a threefry block (about 70 integer operations). Device
// memory sees the initial positions, one history row per closed transition and
// the final state, so by bytes and operations the card could run the
// flagship's 4,096 x 256 (2.5e7 leaves) in about 1.3 ms (chip_smoke.py's
// bound). What sets its time is the slowest chain: its leaves run one after
// the other, at a dependent latency of about 1,700 cycles a leaf when it is
// alone on the card and about twice that while its SM is full, so the launch
// ends with the SMs half empty (PERF.md §6). A matrix target adds two
// contractions with its data per leaf (4 N M
// FLOP for the horseshoe), read from L2 or, for the horseshoe where it fits,
// from the block's copy of X in shared memory (see matrix_targets.cuh). Its
// checkpoint slots at N = 13 and max_depth = 10 take 33 KB of shared memory per
// warp; with the horseshoe's X (81.6 KB at 100 x 200) the block takes 231,360
// of the 232,448 bytes a block may have, so one 4-warp block runs an SM, one
// warp a scheduler: the latency of each warp's dependent loads and
// transcendentals, not arithmetic or bandwidth, bounds it. A dense metric adds
// 2 d^2 FMAs per leaf read from L2, a low-rank one about 4 d k.
//
// The tiles form's bound, per block and leaf at 4,096 x 54 and eight chains:
// 4,096 x 54 x 8 x 4 FLOP (7.1 MFLOP, two FMAs a product) and 32,768 sigmoids
// and softplus terms, against one read of X from L2 (983 KB at the tile
// stride of 60 floats). At one block an SM the arithmetic is about 14 us of
// the SM's FP32 peak; the copy of tile t + 1 overlaps the arithmetic on tile
// t. Each forward step reads one float4 of X and eight broadcast floats of
// the positions for 32 FMAs, each backward row two floats of X and eight of
// the sigmoids for 16: shared memory, at 128 bytes a clock, and the FP32
// pipes are near balance. Measured (PERF.md §6), the forward products, the
// exact sigmoid and softplus terms and the backward products take about a
// third of a gradient each, 5.6-5.8 times the bound.
// Tensor cores are not used: TF32 keeps 10 mantissa bits and would lose the
// 1e-3 per-chain agreement with the plain version. A 3xTF32 product (split
// each operand into a TF32 high and low part, three mma a product, ~fp32
// accuracy) or wgmma on the (R x cols) tile against (cols x kChainsLR) would
// need N = kChainsLR >= 8 columns (mma.m16n8k8) and a layout of W and the
// sigmoids in the fragments' order; that is later work.
//
// Numerics. Build without --use_fast_math and with --fmad=false: expf, logf,
// cosf, sqrtf and log1pf are the accurate library versions and no multiply-add
// is contracted, so the kernel rounds like the plain PyTorch version except for
// the order of its sums and the last ulp of the transcendentals. The tiles
// form's two contractions use explicit fused multiply-adds (__fmaf_rn), as
// the plain version's matrix products on the card do.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "counter_rng.cuh"     // threefry2x32, to_unit, box_muller
#include "matrix_targets.cuh"  // warp_sum, logaddexp, the matrix targets
#include "resident_form.cuh"   // ColdVec, copy, warp_sums, slots_fit_shared, occupancy_of

namespace {

constexpr int kWarps = 4;  // chains per block (the tiles form: kChainsLR)
// chains per block of the tiles form (logistic regression), which run their
// leaves in lockstep; picked by measurement (logreg_dc_tiles.py times 4, 8
// and 16: PERF.md §6). ops/fused_nuts_dc.py:_CHAINS_LR mirrors it.
constexpr int kChainsLR = 8;

template <int F>
__host__ __device__ constexpr int block_warps() { return F == kLogRegDC ? kChainsLR : kWarps; }

// the metrics; each source instantiates one (BJT_DC_METRIC)
constexpr int kDiag = 0;
constexpr int kDense = 1;
constexpr int kLowRank = 2;

struct Params {
  const float* x0;       // (C, d) initial positions
  const float* imm;      // diag: (d,) inverse mass matrix; low-rank: sigma (d,)
  const float* sigma_m;  // diag: (d,) sqrt(1 / imm), 0 where imm <= 0; low-rank: 1 / sigma
  const float* imm_t;    // dense: (d, d) M^{-1}, transposed (row i holds column i)
  const float* chol_t;   // dense: (d, d) C^T, with C C^T = M
  const float* U;        // low-rank: (d, k), row-major
  const float* lam_m1;   // low-rank: (k,) lam - 1
  const float* isl_m1;   // low-rank: (k,) 1 / sqrt(lam) - 1
  const float* inv_var;  // (d,) Gaussian target only, else null
  const int* track_rows; // (n_track,) coordinates recorded per transition
  const int* budgets;    // (C,) leaf budget per chain, or null: budget for all
  float* out_x;          // (C, d) final positions
  int* out_steps;        // (C,) transitions completed
  float* out_grads;      // (C,) gradient evaluations of completed transitions
  float* out_hist;       // (C, S, n_track), zeroed by the caller
  int* out_iters;        // (C,) iterations used up to the last closed transition
  float* cold;           // N >= 13: (C, kColdVectors, N, 32) scratch for the cold vectors
  float* slots;          // tiles form: (C, slot_floats) checkpoint slots in device memory
  int C, d, S, n_track, max_depth, budget, restart_every, target, rank;
  int metric_shared;     // tiles form: copy the metric's matrices into shared memory
  float eps, threshold;
  uint32_t seed;
  MatrixData mat;        // a matrix target's data, else zeros
};

template <int N>
__device__ __forceinline__ float dot(const float (&a)[N], const float (&b)[N]) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) s += a[k] * b[k];
  return warp_sum(s);
}

// The N >= 13 instantiations keep the ten state vectors that a transition
// touches only at its restart and subtree boundaries (the accepted state,
// the trajectory's two ends, the proposal) in a per-chain scratch in device
// memory, so that the leaf's hot vectors and the target's gradient have the
// registers; below N = 13 they are register arrays, as the others are.
// ColdVec<N> (resident_form.cuh) reads and writes element k of the lane at
// p[k * 32] (coalesced). ops/fused_nuts_dc.py:_cold_floats mirrors the
// scratch's size.
template <int N>
constexpr bool kColdState = N >= 13;
constexpr int kColdVectors = 10;

template <int N, bool kCold>
using StateVec = std::conditional_t<kCold, ColdVec<N>, float[N]>;

template <int N>
__device__ __forceinline__ void bind(ColdVec<N>& v, float* base) { v.p = base; }
template <int N>
__device__ __forceinline__ void bind(float (&)[N], float*) {}

// logdensity (returned, replicated) and gradient (per lane) of the target,
// written in the reference's operation order (make_hierarchical_target_dc,
// make_gaussian_target_dc; the matrix targets in matrix_targets.cuh). Pad dims
// (j >= d) get a zero gradient. F is the target family: 0 for the analytic
// targets, else the matrix target's id. T is the analytic target where it is
// known at compile time (the resident form), -1 where p.target picks it.
template <int N, int T = -1>
__device__ __forceinline__ float analytic_value_and_grad(const Params& p,
                                                         const float (&x)[N],
                                                         float (&g)[N], int lane) {
  if (T == kHierarchical || (T < 0 && p.target == kHierarchical)) {
    const float log_tau = __shfl_sync(kFull, x[0], 0);
    float ts = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int j = k * 32 + lane;
      const float t = (j >= 1 && j < p.d) ? x[k] : 0.f;
      ts += t * t;
    }
    const float theta_sq = warp_sum(ts);
    const float exp_neg = expf(-log_tau);
    const float half_n_theta = 0.5f * (float)(p.d - 1);
    const float g_tau = -log_tau + 0.5f * theta_sq * exp_neg - half_n_theta;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int j = k * 32 + lane;
      g[k] = (j == 0) ? g_tau : (j < p.d ? -(x[k] * exp_neg) : 0.f);
    }
    return -0.5f * (log_tau * log_tau) - 0.5f * theta_sq * exp_neg -
           half_n_theta * log_tau;
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    const float iv = j < p.d ? __ldg(p.inv_var + j) : 0.f;
    s += x[k] * x[k] * iv;
    g[k] = -x[k] * iv;
  }
  return -0.5f * warp_sum(s);
}

template <int N, int F, bool kSharedX>
__device__ __forceinline__ float value_and_grad(const Params& p,
                                                const float (&x)[N],
                                                float (&g)[N], int lane,
                                                float* scratch, float* x_sh) {
  if constexpr (F == kLogRegDC) {
    return logreg_tiles<N, kChainsLR>(p.mat, x, g, lane, x_sh);  // x_sh: the block's tiles
  } else if constexpr (F == kHorseshoeDC) {
    return horseshoe_dc<N, kSharedX>(p.mat, p.d, x, g, lane, scratch, x_sh);
  } else if constexpr (F == kEightSchoolsDC) {
    return eight_schools_dc(p.mat, x, g, lane);
  } else {
    return analytic_value_and_grad<N>(p, x, g, lane);
  }
}

// Where the dense and low-rank metrics' matrices are read from: device
// memory through the read-only cache (kLdg), or, in the tiles form, the
// block's copy in shared memory or device memory, through generic loads.
struct MetricView {
  const float* imm_t;   // dense: (d, d) M^{-1}, transposed
  const float* chol_t;  // dense: (d, d) C^T
  const float* U;       // low-rank: (d, k), row-major
  const float* lam_m1;  // low-rank: (k,)
  const float* isl_m1;  // low-rank: (k,)
};

template <bool kLdg>
__device__ __forceinline__ float load_metric(const float* a) {
  if constexpr (kLdg) {
    return __ldg(a);
  } else {
    return *a;
  }
}

// out = A v for the warp's vector v, given A^T row-major (d, d): the warp
// stages v in shared memory and each lane sums its own rows over i in order,
// reading row i of A^T coalesced across lanes
template <int N, bool kLdg>
__device__ __forceinline__ void dense_mv(const float* at, int d, const float (&v)[N],
                                         float (&out)[N], int lane, float* vbuf) {
  stage<N>(vbuf, v, lane);
  float acc[N] = {};
  for (int i = 0; i < d; ++i) {
    const float vi = vbuf[i];
    const float* row = at + (size_t)i * d;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int r = k * 32 + lane;
      if (r < d) acc[k] += load_metric<kLdg>(row + r) * vi;
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = acc[k];
}

// out = y + U (s_m1 * (U^T y)): t_j = U[:, j] . y by a warp reduction, then
// each lane adds U[r, j] (s_m1[j] t_j) to its own rows r, over j in order
template <int N, bool kLdg>
__device__ __forceinline__ void low_rank_mv(const Params& p, const float* U, const float (&y)[N],
                                            const float* s_m1, float (&out)[N], int lane) {
  float acc[N] = {};
  for (int j = 0; j < p.rank; ++j) {
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int r = k * 32 + lane;
      if (r < p.d) part += y[k] * load_metric<kLdg>(U + (size_t)r * p.rank + j);
    }
    const float st = load_metric<kLdg>(s_m1 + j) * warp_sum(part);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int r = k * 32 + lane;
      if (r < p.d) acc[k] += st * load_metric<kLdg>(U + (size_t)r * p.rank + j);
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = y[k] + acc[k];
}

// out = M^{-1} v (dense or low-rank; sig holds sigma for the low-rank metric)
template <int N, int M, bool kLdg>
__device__ __forceinline__ void imm_mv(const Params& p, const MetricView& mv, const float (&v)[N],
                                       float (&out)[N], const float (&sig)[N], int lane,
                                       float* vbuf) {
  if constexpr (M == kDense) {
    dense_mv<N, kLdg>(mv.imm_t, p.d, v, out, lane, vbuf);
  } else {
    float y[N], r[N];
#pragma unroll
    for (int k = 0; k < N; ++k) y[k] = sig[k] * v[k];
    low_rank_mv<N, kLdg>(p, mv.U, y, mv.lam_m1, r, lane);
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = sig[k] * r[k];
  }
}

// out = M^{1/2} z, the momentum from standard normals z: C z (dense), or
// D^{-1} (I + U (Lam^{-1/2} - 1) U^T) z (low-rank)
template <int N, int M, bool kLdg>
__device__ __forceinline__ void sample_m(const Params& p, const MetricView& mv,
                                         const float (&z)[N], float (&out)[N], int lane,
                                         float* vbuf) {
  if constexpr (M == kDense) {
    dense_mv<N, kLdg>(mv.chol_t, p.d, z, out, lane, vbuf);
  } else {
    float r[N];
    low_rank_mv<N, kLdg>(p, mv.U, z, mv.isl_m1, r, lane);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int j = k * 32 + lane;
      out[k] = j < p.d ? p.sigma_m[j] * r[k] : 0.f;
    }
  }
}

// floats of a chain's checkpoint slots: m and msum (and w for the dense and
// low-rank metrics) at each of max_depth levels
template <int N, int M>
__host__ __device__ constexpr int slot_floats(int max_depth) {
  return (M == kDiag ? 2 : 3) * max_depth * N * 32;
}

// shared memory floats per warp besides the slots: a staging vector for the
// dense and low-rank metrics and, for the horseshoe and eight schools, the
// target's scratch (logistic regression's gradient uses the block's tiles)
template <int N, int F, int M>
__host__ __device__ constexpr int own_floats() {
  return (M == kDiag ? 0 : N * 32) + (F == kHorseshoeDC     ? horseshoe_scratch_floats<N>()
                                      : F == kEightSchoolsDC ? scratch_floats<N>()
                                                             : 0);
}

// floats of a dense or low-rank metric's matrices in the tiles form's copy:
// M^{-1} and C^T (d x d each), or U (d x k), lam - 1 and 1 / sqrt(lam) - 1
template <int M>
__host__ __device__ constexpr int metric_floats(int d, int rank) {
  return M == kDense ? 2 * d * d : M == kLowRank ? d * rank + 2 * rank : 0;
}

// a block's dynamic shared memory. The L2 and shared-memory forms: X's copy
// in the shared-memory form, then each of the kWarps warps' slots and own
// floats. The tiles form (logistic regression): the gradient's tiles
// (lr_tiles_floats), each of the kChainsLR warps' own floats, and the
// metric's matrices where metric_shared; its slots live in device memory.
// ops/fused_nuts_dc.py:shared_memory_plan mirrors it.
template <int N, int F, int M, bool kSharedX>
__host__ __device__ size_t block_bytes(int max_depth, int rows, int cols, int rank,
                                       bool metric_shared) {
  if constexpr (F == kLogRegDC) {
    return ((size_t)lr_tiles_floats<N, kChainsLR>(cols) + kChainsLR * own_floats<N, F, M>() +
            (metric_shared ? metric_floats<M>(cols, rank) : 0)) *
           sizeof(float);
  }
  const size_t warp = slot_floats<N, M>(max_depth) + own_floats<N, F, M>();
  return ((kSharedX ? (size_t)shared_x_floats(rows, cols) : 0) + kWarps * warp) * sizeof(float);
}

template <int N, int F, int M, bool kSharedX>
__global__ void __launch_bounds__(block_warps<F>() * 32) nuts_dc_kernel(const Params p) {
  // the tiles form: the block's chains run their leaves in lockstep and
  // share one gradient a leaf (logreg_tiles)
  constexpr bool kTiles = F == kLogRegDC;
  constexpr int kBlock = block_warps<F>();
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chain = blockIdx.x * kBlock + warp;
  // the shared-memory form: the block copies X once, zero padded to the row
  // stride, and only reads it afterwards; the barrier comes before any warp
  // of a partial last block leaves
  float* x_sh = smem;
  if constexpr (kSharedX) {
    const int rows = p.mat.rows, cols = p.mat.cols, stride = shared_x_stride(cols);
    for (int i = threadIdx.x; i < rows * stride; i += kBlock * 32) {
      const int r = i / stride, c = i - r * stride;
      x_sh[i] = c < cols ? p.mat.X[(size_t)r * cols + c] : 0.f;
    }
    __syncthreads();
  }
  const int slot = N * 32;
  // the tiles form: the metric's matrices copied into shared memory where
  // the plan made room (metric_shared), after the warps' own floats
  MetricView mv{p.imm_t, p.chol_t, p.U, p.lam_m1, p.isl_m1};
  float* ck_m;  // the warp's slots: [m] [msum] [w]
  float* vbuf;  // dense and low-rank: the staging vector
  if constexpr (kTiles) {
    float* own = smem + lr_tiles_floats<N, kChainsLR>(p.mat.cols);
    if (M != kDiag && p.metric_shared) {
      float* copy_to = own + kBlock * own_floats<N, F, M>();
      const int d = p.d, n_a = M == kDense ? d * d : d * p.rank;
      const float* a = M == kDense ? p.imm_t : p.U;
      const float* b = M == kDense ? p.chol_t : p.lam_m1;
      const int n_b = M == kDense ? d * d : p.rank;
      for (int i = threadIdx.x; i < n_a; i += kBlock * 32) copy_to[i] = a[i];
      for (int i = threadIdx.x; i < n_b; i += kBlock * 32) copy_to[n_a + i] = b[i];
      if (M == kLowRank)
        for (int i = threadIdx.x; i < p.rank; i += kBlock * 32)
          copy_to[n_a + n_b + i] = p.isl_m1[i];
      if constexpr (M == kDense) {
        mv.imm_t = copy_to;
        mv.chol_t = copy_to + n_a;
      } else {
        mv.U = copy_to;
        mv.lam_m1 = copy_to + n_a;
        mv.isl_m1 = copy_to + n_a + n_b;
      }
      __syncthreads();
    }
    ck_m = p.slots + (size_t)chain * slot_floats<N, M>(p.max_depth);
    vbuf = own + warp * own_floats<N, F, M>();
  } else {
    if (chain >= p.C) return;  // the whole warp leaves together
    // the warp's shared memory: [slots] [staging vector] [target scratch]
    ck_m = smem + (kSharedX ? shared_x_floats(p.mat.rows, p.mat.cols) : 0) +
           (size_t)warp * (slot_floats<N, M>(p.max_depth) + own_floats<N, F, M>());
    vbuf = ck_m + slot_floats<N, M>(p.max_depth);
  }
  // a warp past the last chain of a partial last block (tiles form) runs
  // the loop with no budget: it joins each gradient and writes nothing
  const bool present = kTiles ? chain < p.C : true;
  float* ck_s = ck_m + p.max_depth * slot;
  float* ck_w = ck_s + p.max_depth * slot;   // dense and low-rank only
  float* scratch = M == kDiag ? vbuf : vbuf + slot;

  // imm: the diagonal's M^{-1}, or the low-rank metric's sigma
  float imm[N], cur_x[N], cur_m[N], cur_g[N];
  float msum[N], sub_msum[N], sub_x[N], sub_g[N];
  float new_x[N], new_m[N], new_g[N], w_new[N];
  float left_w[N], right_w[N];  // dense and low-rank: M^{-1} of left_m, right_m
  constexpr bool kCold = kColdState<N>;
  StateVec<N, kCold> acc_x, acc_g, left_x, left_m, left_g, right_x, right_m, right_g;
  StateVec<N, kCold> prop_x, prop_g;
  if constexpr (kCold) {
    float* cold = p.cold + (size_t)chain * kColdVectors * slot + lane;
    bind<N>(acc_x, cold);            bind<N>(acc_g, cold + slot);
    bind<N>(left_x, cold + 2 * slot); bind<N>(left_m, cold + 3 * slot);
    bind<N>(left_g, cold + 4 * slot); bind<N>(right_x, cold + 5 * slot);
    bind<N>(right_m, cold + 6 * slot); bind<N>(right_g, cold + 7 * slot);
    bind<N>(prop_x, cold + 8 * slot); bind<N>(prop_g, cold + 9 * slot);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    const bool valid = j < p.d;
    cur_x[k] = valid && present ? p.x0[(size_t)chain * p.d + j] : 0.f;
    if constexpr (M == kDense) {
      imm[k] = 0.f;
    } else {
      imm[k] = valid ? p.imm[j] : 0.f;
    }
  }
  float acc_ld = value_and_grad<N, F, kSharedX>(p, cur_x, cur_g, lane, scratch, x_sh);
  copy<N>(acc_x, cur_x); copy<N>(acc_g, cur_g);

  float prop_ld = 0.f, sub_ld = 0.f;
  float prop_w = 0.f, prop_slpa = 0.f, sub_w = 0.f, sub_slpa = 0.f, h0 = 0.f;
  float direction = 1.f, grads = 0.f;
  int depth = 0, leaf = 0, nstates = 0, steps = 0;
  // iteration 0 starts with done = 1, so it opens the first transition
  bool done = true, div = false, turn = false;
  const int S = p.S;

  // One leaf per iteration until num_steps transitions closed or the budget
  // is spent. A chain below num_steps is active after its restart, so the
  // reference's chunk-skip cond (which only skips tiles whose chains all
  // finished) changes nothing for it: these outputs are the reference's.
  //
  // The tiles form runs the loop until no warp of the block is live; a warp
  // that is not live, or parked, reaches the block's gradient all the same,
  // with w = 0, and skips the rest of the iteration. Per chain, it, budget,
  // steps and iters keep their meaning.
  const int budget = !present ? 0 : p.budgets != nullptr ? p.budgets[chain] : p.budget;
  int iters = 0;
  for (int it = 0;; ++it) {
    const bool live = it < budget && steps < S;
    if constexpr (kTiles) {
      if (!__syncthreads_or(live)) break;
    } else if (!live) {
      break;
    }
    // a closed chain restarts on the gated iterations only; until then it is
    // parked, and a parked leaf changes nothing the restart keeps
    const bool parked = done && it % p.restart_every != 0;
    if constexpr (!kTiles) {
      if (parked) continue;
    }
    const bool active = kTiles ? live && !parked : true;
    // counter key of this (chain, step): int32 chain * S + steps in the
    // reference (fused_nuts_dc.py:395), so wrap modulo 2^32 here too
    const uint32_t base_row = (uint32_t)chain * (uint32_t)S + (uint32_t)steps;

    if (done && active) {
      // ---- inline restart: fresh momentum, trajectory reset ----
      // Momentum key c0 = dim index, c1 = (1 << 24) | base_row, u1 with the
      // +1 offset (fused_nuts_dc.py:413-425). Kept for parity, as the JAX
      // package is frozen this round: the OR collides with the tag bit once
      // base_row >= 2^24, i.e. at chains * num_steps >= 2^24, and chains
      // 2^24 / S apart then draw the same momenta.
      const uint32_t c1 = (1u << 24) | base_row;
      if constexpr (M == kDiag) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int j = k * 32 + lane;
          float m = 0.f;
          if (j < p.d) {
            uint32_t b1, b2;
            threefry2x32(p.seed, kKey1, (uint32_t)j, c1, b1, b2);
            m = p.sigma_m[j] * box_muller(b1, b2);
          }
          cur_m[k] = m;
          w_new[k] = imm[k] * m;  // scratch: w = M^{-1} m of the fresh momentum
        }
      } else {
        float z[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int j = k * 32 + lane;
          z[k] = 0.f;
          if (j < p.d) {
            uint32_t b1, b2;
            threefry2x32(p.seed, kKey1, (uint32_t)j, c1, b1, b2);
            z[k] = box_muller(b1, b2);
          }
        }
        sample_m<N, M, !kTiles>(p, mv, z, cur_m, lane, vbuf);
        imm_mv<N, M, !kTiles>(p, mv, cur_m, w_new, imm, lane, vbuf);
        copy<N>(left_w, w_new); copy<N>(right_w, w_new);
      }
      h0 = -acc_ld + 0.5f * dot<N>(w_new, cur_m);
      copy<N>(cur_x, acc_x);  copy<N>(cur_g, acc_g);
      copy<N>(left_x, acc_x); copy<N>(left_m, cur_m); copy<N>(left_g, acc_g);
      copy<N>(right_x, acc_x); copy<N>(right_m, cur_m); copy<N>(right_g, acc_g);
      copy<N>(prop_x, acc_x); copy<N>(prop_g, acc_g);
      copy<N>(sub_x, acc_x);  copy<N>(sub_g, acc_g);
      copy<N>(msum, cur_m);
#pragma unroll
      for (int k = 0; k < N; ++k) sub_msum[k] = 0.f;
      prop_ld = sub_ld = acc_ld;
      prop_w = 0.f; prop_slpa = -INFINITY; sub_w = 0.f; sub_slpa = -INFINITY;
      depth = leaf = nstates = 0;
      div = turn = done = false;
    }

    // ---- subtree start: direction draw, continue from that end ----
    // u_dir and u_prop are one _counter_uniforms2(seed, base_row, 2, depth)
    // block (fused_nuts_dc.py:463); each is drawn where it is used.
    const bool at_start = leaf == 0;
    if (at_start && active) {
      uint32_t b1, b2;
      threefry2x32(p.seed, kKey1, base_row, (2u << 24) | (uint32_t)depth, b1, b2);
      direction = to_unit(b1) < 0.5f ? -1.f : 1.f;
      if (direction > 0.f) {
        copy<N>(cur_x, right_x); copy<N>(cur_m, right_m); copy<N>(cur_g, right_g);
      } else {
        copy<N>(cur_x, left_x); copy<N>(cur_m, left_m); copy<N>(cur_g, left_g);
      }
    }
    const bool fwd = direction > 0.f;

    // ---- one velocity-Verlet leaf ----
    const float d_eps = direction * p.eps;
    const float half = 0.5f * d_eps;
    if (!active) {
#pragma unroll
      for (int k = 0; k < N; ++k) new_x[k] = 0.f;
    } else if constexpr (M == kDiag) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        new_m[k] = cur_m[k] + half * cur_g[k];
        new_x[k] = cur_x[k] + d_eps * (imm[k] * new_m[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) new_m[k] = cur_m[k] + half * cur_g[k];
      imm_mv<N, M, !kTiles>(p, mv, new_m, w_new, imm, lane, vbuf);  // scratch: M^{-1} m_half
#pragma unroll
      for (int k = 0; k < N; ++k) new_x[k] = cur_x[k] + d_eps * w_new[k];
    }
    const float new_ld = value_and_grad<N, F, kSharedX>(p, new_x, new_g, lane, scratch, x_sh);
    if (!active) continue;
    if constexpr (M == kDiag) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        new_m[k] = new_m[k] + half * new_g[k];
        w_new[k] = imm[k] * new_m[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) new_m[k] = new_m[k] + half * new_g[k];
      imm_mv<N, M, !kTiles>(p, mv, new_m, w_new, imm, lane, vbuf);
    }
    const float energy = -new_ld + 0.5f * dot<N>(w_new, new_m);
    float delta = h0 - energy;
    if (isnan(delta)) delta = -INFINITY;  // fused_nuts_dc.py:484
    const float leaf_w = delta;
    const float leaf_slpa = delta < 0.f ? delta : 0.f;
    const bool leaf_div = -delta > p.threshold;

    // ---- progressive uniform merge within the subtree ----
    if (at_start) {
      copy<N>(sub_x, new_x); copy<N>(sub_g, new_g); sub_ld = new_ld;
      sub_w = leaf_w;
      sub_slpa = leaf_slpa;
      copy<N>(sub_msum, new_m);
    } else {
      // leaf uniform: _counter_uniforms(seed, base_row, 3, nstates) (:490)
      uint32_t b1, b2;
      threefry2x32(p.seed, kKey1, base_row, (3u << 24) | (uint32_t)nstates, b1, b2);
      // sigmoid(NaN) is NaN and the comparison is false: no take
      const float p_acc = 1.f / (1.f + expf(-(leaf_w - sub_w)));
      if (to_unit(b1) < p_acc) {
        copy<N>(sub_x, new_x); copy<N>(sub_g, new_g); sub_ld = new_ld;
      }
      sub_w = logaddexp(sub_w, leaf_w);
      sub_slpa = logaddexp(sub_slpa, leaf_slpa);
#pragma unroll
      for (int k = 0; k < N; ++k) sub_msum[k] = sub_msum[k] + new_m[k];
    }

    // ---- checkpointed subtree U-turn (termination.py:37-43) ----
    // even leaves store (m, sub_msum) at slot idx_max; odd leaves check the
    // slots idx_min..idx_max of the subtrees that end at this leaf
    const int idx_max = __popc(leaf >> 1);
    bool subtree_turning = false;
    if ((leaf & 1) == 0) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        ck_m[idx_max * slot + k * 32 + lane] = new_m[k];
        ck_s[idx_max * slot + k * 32 + lane] = sub_msum[k];
        if constexpr (M != kDiag) ck_w[idx_max * slot + k * 32 + lane] = w_new[k];
      }
    } else {
      const int idx_min = idx_max - __popc(((~leaf) & (leaf + 1)) - 1) + 1;
      for (int i = idx_min; i <= idx_max && !subtree_turning; ++i) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float ckm = ck_m[i * slot + k * 32 + lane];
          const float cks = ck_s[i * slot + k * 32 + lane];
          const float rho = sub_msum[k] - 0.5f * new_m[k] - cks + 0.5f * ckm;
          if constexpr (M == kDiag) {
            a += imm[k] * ckm * rho;
          } else {
            a += ck_w[i * slot + k * 32 + lane] * rho;
          }
          b += w_new[k] * rho;
        }
        subtree_turning = warp_sum(a) <= 0.f || warp_sum(b) <= 0.f;
      }
    }

    // ---- subtree boundary: merge into the trajectory ----
    const bool aborted = leaf_div || subtree_turning;
    const bool closing = leaf + 1 >= (1 << depth) || aborted;
    bool full_turn = false;
    if (closing) {
#pragma unroll
      for (int k = 0; k < N; ++k) msum[k] = msum[k] + sub_msum[k];
      if (fwd) {
        copy<N>(right_x, new_x); copy<N>(right_m, new_m); copy<N>(right_g, new_g);
        if constexpr (M != kDiag) copy<N>(right_w, w_new);
      } else {
        copy<N>(left_x, new_x); copy<N>(left_m, new_m); copy<N>(left_g, new_g);
        if constexpr (M != kDiag) copy<N>(left_w, w_new);
      }
      // biased merge toward the new subtree; an aborted subtree adds its
      // acceptance statistics only. min(NaN, 1) stays NaN, as jnp.minimum.
      uint32_t b1, b2;
      threefry2x32(p.seed, kKey1, base_row, (2u << 24) | (uint32_t)depth, b1, b2);
      const float ratio = expf(sub_w - prop_w);
      const float p_biased = ratio > 1.f ? 1.f : ratio;
      if (to_unit(b2) < p_biased && !aborted) {
        copy<N>(prop_x, sub_x); copy<N>(prop_g, sub_g); prop_ld = sub_ld;
      }
      if (!aborted) prop_w = logaddexp(prop_w, sub_w);
      prop_slpa = logaddexp(prop_slpa, sub_slpa);

      float a = 0.f, b = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float rho = msum[k] - 0.5f * (left_m[k] + right_m[k]);
        if constexpr (M == kDiag) {
          a += imm[k] * left_m[k] * rho;
          b += imm[k] * right_m[k] * rho;
        } else {
          a += left_w[k] * rho;
          b += right_w[k] * rho;
        }
      }
      full_turn = warp_sum(a) <= 0.f || warp_sum(b) <= 0.f;
      depth += 1;
      leaf = 0;
    } else {
      leaf += 1;
    }

    // ---- transition close ----
    div = div || leaf_div;  // the divergence test is -delta > threshold
    turn = turn || (closing && (subtree_turning || full_turn));
    done = div || turn || (closing && depth >= p.max_depth);
    nstates += 1;
    if (done) {
      // grads counts nstates only when a transition closes (:581)
      grads = grads + (float)nstates;
      copy<N>(acc_x, prop_x); copy<N>(acc_g, prop_g); acc_ld = prop_ld;
      iters = it + 1;
      // history row steps - 1 of the closed transition; rows never
      // reached keep the caller's zeros
      float* row = p.out_hist + ((size_t)chain * S + steps) * p.n_track;
      for (int t = 0; t < p.n_track; ++t) {
        const int r = p.track_rows[t];
#pragma unroll
        for (int k = 0; k < N; ++k)
          if (r == k * 32 + lane) row[t] = acc_x[k];
      }
      steps += 1;
    }
    copy<N>(cur_x, new_x); copy<N>(cur_m, new_m); copy<N>(cur_g, new_g);
  }

  if (!present) return;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    if (j < p.d) p.out_x[(size_t)chain * p.d + j] = acc_x[k];
  }
  if (lane == 0) {
    p.out_steps[chain] = steps;
    p.out_grads[chain] = grads;
    p.out_iters[chain] = iters;
  }
}

// ---------------------------------------------------------------------------
// The resident form: the analytic targets at N <= 8 (see the head of this file)
// ---------------------------------------------------------------------------

// warps a block of the resident form; a block holds its SM's resources
// until its last warp ends, so that with one warp a finished chain's slot
// takes the next chain at once. Picked by measurement (dc_kernel_ms.py
// --block-warps: PERF.md §6); ops/fused_nuts_dc.py mirrors it.
constexpr int kResidentBlockWarps = 1;

// warps an SM that the resident form's instantiations are built to hold:
// their __launch_bounds__ ask for resident_warps / kResidentBlockWarps blocks an SM,
// which caps a thread at 65,536 / (32 resident_warps) registers (64 at 32
// warps, which would hold 4,096 chains on 132 SMs at once, but spill at N =
// 4). Picked by measurement (dc_kernel_ms.py --warps: PERF.md §6);
// ops/fused_nuts_dc.py mirrors it.
template <int N>
__host__ __device__ constexpr int resident_warps() { return N <= 2 ? 24 : N == 4 ? 20 : 16; }

// the chain's state vectors that the resident form keeps in device memory
// (ColdVec), by index: the accepted state, the proposal, the trajectory's
// two ends, the subtree's sample, the trajectory's momentum sum, and the
// ends' w for the dense and low-rank metrics
enum ResidentVec {
  kAccX, kAccG, kPropX, kPropG, kLeftX, kLeftM, kLeftG, kRightX, kRightM, kRightG,
  kSubX, kSubG, kMsum, kLeftW, kRightW
};
template <int M>
__host__ __device__ constexpr int resident_vectors() {
  return M == kDiag ? kMsum + 1 : kRightW + 1;
}

// floats of a chain's scratch in device memory for the resident form's
// vectors; ops/fused_nuts_dc.py:_cold_floats mirrors it
template <int N, int M>
__host__ __device__ constexpr int resident_cold_floats() { return resident_vectors<M>() * N * 32; }

// floats of a resident warp's shared memory when its checkpoint slots live
// there: the dense and low-rank metrics' staging vector, the subtree's
// sample (x and g) and the slots, level by level
template <int N, int M>
__host__ __device__ constexpr int resident_shared_floats(int max_depth) {
  return own_floats<N, 0, M>() + 2 * N * 32 + slot_floats<N, M>(max_depth);
}

// whether the resident form keeps the warps' slots (and the subtrees'
// samples) in shared memory: where the resident_warps of an SM fit them;
// else they live in device memory, beside the other cold vectors
template <int N, int M>
__host__ __device__ constexpr bool resident_slots_shared(int max_depth) {
  return slots_fit_shared(resident_warps<N>(), kResidentBlockWarps,
                          resident_shared_floats<N, M>(max_depth));
}

// a resident block's dynamic shared memory: for each of its warps
// the staging vector of the dense and low-rank metrics, and the slots and
// the subtree's sample where they live there
template <int N, int M>
__host__ __device__ constexpr size_t resident_block_bytes(int max_depth) {
  return (size_t)kResidentBlockWarps * sizeof(float) *
         (resident_slots_shared<N, M>(max_depth) ? resident_shared_floats<N, M>(max_depth)
                                                 : own_floats<N, 0, M>());
}

// the resident form's checkpoint slot i: its m, msum and (dense and
// low-rank) w, one vector after the other
template <int N, int M>
__device__ __forceinline__ float* slot_at(float* slots, int i) {
  return slot_level<N, M == kDiag ? 2 : 3>(slots, i);
}

// the lane's parts of the U-turn check against checkpoint slot i
// (termination.py:37-43), before their butterflies: a against the slot's
// w (the diagonal metric: M^{-1} ckm), b against the leaf's w
template <int N, int M>
__device__ __forceinline__ void slot_parts(float* slots, int i, const float (&imm)[N],
                                           const float (&sub_msum)[N], const float (&m)[N],
                                           const float (&w)[N], float& a, float& b) {
  const float* ck = slot_at<N, M>(slots, i);
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float ckm = ck[k * 32];
    const float cks = ck[(N + k) * 32];
    const float rho = sub_msum[k] - 0.5f * m[k] - cks + 0.5f * ckm;
    if constexpr (M == kDiag) {
      a += imm[k] * ckm * rho;
    } else {
      a += ck[(2 * N + k) * 32] * rho;
    }
    b += w[k] * rho;
  }
}

// The machine of nuts_dc_kernel for the analytic target T, in the resident
// form: the same transitions, draws and sums, in the order that shortens a
// leaf's dependent chains (see the head of this file).
template <int N, int T, int M>
__global__ void __launch_bounds__(kResidentBlockWarps * 32,
                                  resident_warps<N>() / kResidentBlockWarps)
    nuts_dc_resident(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chain = blockIdx.x * kResidentBlockWarps + warp;
  if (chain >= p.C) return;  // resident
  constexpr int V = N * 32;  // floats of a vector
  // the warp's shared memory: [staging vector] and, where they fit,
  // [subtree's x] [subtree's g] [slots]
  const bool shared = resident_slots_shared<N, M>(p.max_depth);
  float* vbuf = smem + warp * (shared ? resident_shared_floats<N, M>(p.max_depth)
                                      : own_floats<N, 0, M>());
  const MetricView mv{p.imm_t, p.chol_t, p.U, p.lam_m1, p.isl_m1};
  float* const cold = p.cold + (size_t)chain * resident_cold_floats<N, M>() + lane;
  const auto vec = [&](int i) { return ColdVec<N>{cold + i * V}; };
  ColdVec<N> acc_x = vec(kAccX), acc_g = vec(kAccG), prop_x = vec(kPropX), prop_g = vec(kPropG);
  ColdVec<N> left_x = vec(kLeftX), left_m = vec(kLeftM), left_g = vec(kLeftG);
  ColdVec<N> right_x = vec(kRightX), right_m = vec(kRightM), right_g = vec(kRightG);
  ColdVec<N> msum = vec(kMsum);
  ColdVec<N> left_w = vec(kLeftW), right_w = vec(kRightW);  // dense and low-rank only
  float* const own = vbuf + own_floats<N, 0, M>() + lane;
  ColdVec<N> sub_x{shared ? own : cold + kSubX * V};
  ColdVec<N> sub_g{shared ? own + V : cold + kSubG * V};
  // the checkpoint slots, level by level (slot_at)
  float* const slots =
      shared ? own + 2 * V : p.slots + (size_t)chain * slot_floats<N, M>(p.max_depth) + lane;

  // one set of the leaf's vectors, updated in place: the leaf starts from
  // x, m, g and leaves its new state there. imm: the diagonal's M^{-1}, or
  // the low-rank metric's sigma; w: M^{-1} m
  float imm[N], x[N], m[N], g[N], w[N], sub_msum[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    const bool valid = j < p.d;
    x[k] = valid ? p.x0[(size_t)chain * p.d + j] : 0.f;
    imm[k] = M != kDense && valid ? p.imm[j] : 0.f;
  }
  float acc_ld = analytic_value_and_grad<N, T>(p, x, g, lane);
  copy<N>(acc_x, x); copy<N>(acc_g, g);

  float prop_ld = 0.f, sub_ld = 0.f, prop_w = 0.f, sub_w = 0.f, h0 = 0.f;
  float direction = 1.f, grads = 0.f;
  // the subtree's second uniform word, for its biased merge, and the next
  // subtree's two words (its direction's and its merge's)
  uint32_t u_prop = 0u, u_next_dir = 0u, u_next_prop = 0u;
  int depth = 0, leaf = 0, nstates = 0, steps = 0;
  // iteration 0 starts with done = 1, so it opens the first transition;
  // prop_new: the proposal has moved off the accepted state this transition
  bool done = true, div = false, turn = false, prop_new = false;
  const int S = p.S;
  const int budget = p.budgets != nullptr ? p.budgets[chain] : p.budget;
  int iters = 0;  // resident
  for (int it = 0;; ++it) {
    if (it >= budget || steps >= S) break;
    // a closed chain restarts on the gated iterations only; until then it is
    // parked, and a parked leaf changes nothing the restart keeps
    if (done && it % p.restart_every != 0) continue;
    // counter key of this (chain, step), wrapping modulo 2^32 as the int32
    // of the reference (fused_nuts_dc.py:395)
    const uint32_t base_row = (uint32_t)chain * (uint32_t)S + (uint32_t)steps;

    if (done) {
      // ---- inline restart: fresh momentum, trajectory reset ----
      // Momentum key c0 = dim index, c1 = (1 << 24) | base_row, u1 with the
      // +1 offset (fused_nuts_dc.py:413-425), kept for parity with its key
      // collision at chains * num_steps >= 2^24 (see nuts_dc_kernel). The
      // subtree's sample is set at its first leaf, and the proposal stays
      // the accepted state until a subtree is taken, so neither is copied.
      const uint32_t c1 = (1u << 24) | base_row;
      if constexpr (M == kDiag) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int j = k * 32 + lane;
          float mk = 0.f;
          if (j < p.d) {
            uint32_t b1, b2;
            threefry2x32(p.seed, kKey1, (uint32_t)j, c1, b1, b2);
            mk = p.sigma_m[j] * box_muller(b1, b2);
          }
          m[k] = mk;
          w[k] = imm[k] * mk;
        }
      } else {
        float z[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int j = k * 32 + lane;
          z[k] = 0.f;
          if (j < p.d) {
            uint32_t b1, b2;
            threefry2x32(p.seed, kKey1, (uint32_t)j, c1, b1, b2);
            z[k] = box_muller(b1, b2);
          }
        }
        sample_m<N, M, true>(p, mv, z, m, lane, vbuf);
        imm_mv<N, M, true>(p, mv, m, w, imm, lane, vbuf);
        copy<N>(left_w, w); copy<N>(right_w, w);
      }
      h0 = -acc_ld + 0.5f * dot<N>(w, m);
      copy<N>(x, acc_x); copy<N>(g, acc_g);
      copy<N>(left_x, x); copy<N>(left_m, m); copy<N>(left_g, g);
      copy<N>(right_x, x); copy<N>(right_m, m); copy<N>(right_g, g);
      copy<N>(msum, m);
      prop_ld = acc_ld;
      prop_w = 0.f;
      prop_new = false;
      depth = leaf = nstates = 0;
      div = turn = done = false;
      threefry2x32(p.seed, kKey1, base_row, 2u << 24, u_next_dir, u_next_prop);  // depth 0's
    }

    // ---- subtree start: direction draw, continue from that end ----
    // u_dir and u_prop are one _counter_uniforms2(seed, base_row, 2, depth)
    // block (fused_nuts_dc.py:463), drawn ahead: by the restart for depth 0,
    // by the previous subtree's first leaf for the others; u_prop waits for
    // the subtree's close. x, m, g hold the end that the last subtree closed
    // on (at depth 0 both ends hold what the restart left there), so only a
    // turn of direction reads the other end.
    const bool at_start = leaf == 0;
    if (at_start) {
      u_prop = u_next_prop;
      const float last = direction;
      direction = to_unit(u_next_dir) < 0.5f ? -1.f : 1.f;
      if (depth > 0 && direction != last) {
        if (direction > 0.f) {
          copy<N>(x, right_x); copy<N>(m, right_m); copy<N>(g, right_g);
        } else {
          copy<N>(x, left_x); copy<N>(m, left_m); copy<N>(g, left_g);
        }
      }
    }
    const bool fwd = direction > 0.f;

    // ---- one velocity-Verlet leaf (resident) ----
    // one threefry block, drawn before the gradient so that its rounds
    // overlap it: the merge's uniform, _counter_uniforms(seed, base_row, 3,
    // nstates) (:490), or, on a subtree's first leaf, which merges nothing,
    // the next subtree's block
    uint32_t u_leaf, u_second;
    threefry2x32(p.seed, kKey1, base_row,
                 at_start ? (2u << 24) | (uint32_t)(depth + 1) : (3u << 24) | (uint32_t)nstates,
                 u_leaf, u_second);
    if (at_start) {
      u_next_dir = u_leaf;
      u_next_prop = u_second;
    }
    const float d_eps = direction * p.eps;
    const float half = 0.5f * d_eps;
    if constexpr (M == kDiag) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        m[k] = m[k] + half * g[k];
        x[k] = x[k] + d_eps * (imm[k] * m[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) m[k] = m[k] + half * g[k];
      imm_mv<N, M, true>(p, mv, m, w, imm, lane, vbuf);  // M^{-1} m_half
#pragma unroll
      for (int k = 0; k < N; ++k) x[k] = x[k] + d_eps * w[k];
    }
    const float new_ld = analytic_value_and_grad<N, T>(p, x, g, lane);
    if constexpr (M == kDiag) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        m[k] = m[k] + half * g[k];
        w[k] = imm[k] * m[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k) m[k] = m[k] + half * g[k];
      imm_mv<N, M, true>(p, mv, m, w, imm, lane, vbuf);
    }
#pragma unroll
    for (int k = 0; k < N; ++k) sub_msum[k] = at_start ? m[k] : sub_msum[k] + m[k];

    // ---- the energy and the U-turn checks' sums (resident) ----
    // Even leaves store (m, sub_msum, w) at slot idx_max; odd leaves check
    // the slots idx_min..idx_max of the subtrees that end at this leaf, all
    // of them (the reference ORs every slot's check, fused_nuts_dc.py:
    // 506-534). The energy's sum and the two newest slots' four sums run
    // their butterflies together; older slots follow two at a time.
    const int idx_max = __popc(leaf >> 1);
    float e = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) e += w[k] * m[k];
    bool subtree_turning = false;
    float energy;
    if ((leaf & 1) == 0) {
      float* ck = slot_at<N, M>(slots, idx_max);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        ck[k * 32] = m[k];
        ck[(N + k) * 32] = sub_msum[k];
        if constexpr (M != kDiag) ck[(2 * N + k) * 32] = w[k];
      }
      energy = -new_ld + 0.5f * warp_sum(e);
    } else {
      const int idx_min = idx_max - __popc(((~leaf) & (leaf + 1)) - 1) + 1;
      const bool two = idx_max > idx_min;
      float s[5] = {e, 0.f, 0.f, 0.f, 0.f};
      slot_parts<N, M>(slots, idx_max, imm, sub_msum, m, w, s[1], s[2]);
      if (two) slot_parts<N, M>(slots, idx_max - 1, imm, sub_msum, m, w, s[3], s[4]);
      warp_sums<5>(s);
      energy = -new_ld + 0.5f * s[0];
      subtree_turning = s[1] <= 0.f || s[2] <= 0.f || (two && (s[3] <= 0.f || s[4] <= 0.f));
      for (int i = idx_max - 2; i >= idx_min; i -= 2) {
        const bool pair = i > idx_min;
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        slot_parts<N, M>(slots, i, imm, sub_msum, m, w, t[0], t[1]);
        if (pair) slot_parts<N, M>(slots, i - 1, imm, sub_msum, m, w, t[2], t[3]);
        warp_sums<4>(t);
        subtree_turning = subtree_turning || t[0] <= 0.f || t[1] <= 0.f ||
                          (pair && (t[2] <= 0.f || t[3] <= 0.f));
      }
    }
    float delta = h0 - energy;
    if (isnan(delta)) delta = -INFINITY;  // fused_nuts_dc.py:484
    const float leaf_w = delta;
    const bool leaf_div = -delta > p.threshold;

    // ---- progressive uniform merge within the subtree (resident) ----
    // the subtree's first leaf is its sample; sigmoid(NaN) is NaN and the
    // comparison is false: no take
    {
      const float p_acc = 1.f / (1.f + expf(-(leaf_w - sub_w)));
      const float merged_w = logaddexp(sub_w, leaf_w);
      if (at_start || to_unit(u_leaf) < p_acc) {
        copy<N>(sub_x, x); copy<N>(sub_g, g);
        sub_ld = new_ld;
      }
      sub_w = at_start ? leaf_w : merged_w;
    }

    // ---- subtree boundary: merge into the trajectory (resident) ----
    const bool aborted = leaf_div || subtree_turning;
    const bool closing = leaf + 1 >= (1 << depth) || aborted;
    bool full_turn = false;
    if (closing) {
      // the leaf becomes the end on its side; the full tree's check reads
      // the other end from device memory
      float ab[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float ms = msum[k] + sub_msum[k];
        msum[k] = ms;
        float lm, rm, lw, rw;
        if (fwd) {
          right_x[k] = x[k]; right_m[k] = m[k]; right_g[k] = g[k];
          lm = left_m[k];
          rm = m[k];
        } else {
          left_x[k] = x[k]; left_m[k] = m[k]; left_g[k] = g[k];
          lm = m[k];
          rm = right_m[k];
        }
        if constexpr (M == kDiag) {
          lw = imm[k] * lm;
          rw = imm[k] * rm;
        } else if (fwd) {
          right_w[k] = w[k];
          lw = left_w[k];
          rw = w[k];
        } else {
          left_w[k] = w[k];
          lw = w[k];
          rw = right_w[k];
        }
        const float rho = ms - 0.5f * (lm + rm);
        ab[0] += lw * rho;
        ab[1] += rw * rho;
      }
      // biased merge toward the new subtree; an aborted subtree adds nothing.
      // min(NaN, 1) stays NaN, as jnp.minimum.
      const float ratio = expf(sub_w - prop_w);
      const float p_biased = ratio > 1.f ? 1.f : ratio;
      if (to_unit(u_prop) < p_biased && !aborted) {
        copy<N>(prop_x, sub_x); copy<N>(prop_g, sub_g);
        prop_ld = sub_ld;
        prop_new = true;
      }
      if (!aborted) prop_w = logaddexp(prop_w, sub_w);
      warp_sums<2>(ab);
      full_turn = ab[0] <= 0.f || ab[1] <= 0.f;
      depth += 1;
      leaf = 0;
    } else {
      leaf += 1;
    }

    // ---- transition close (resident) ----
    div = div || leaf_div;  // the divergence test is -delta > threshold
    turn = turn || (closing && (subtree_turning || full_turn));
    done = div || turn || (closing && depth >= p.max_depth);
    nstates += 1;
    if (done) {
      // grads counts nstates only when a transition closes (:581)
      grads = grads + (float)nstates;
      if (prop_new) {
        copy<N>(acc_x, prop_x); copy<N>(acc_g, prop_g);
      }
      acc_ld = prop_ld;
      iters = it + 1;
      // history row steps - 1 of the closed transition, from the lane that
      // holds each tracked coordinate; rows never reached keep the zeros
      float* row = p.out_hist + ((size_t)chain * S + steps) * p.n_track;
      for (int t = 0; t < p.n_track; ++t) {
        const int r = p.track_rows[t];
        if ((r & 31) == lane) row[t] = acc_x[r >> 5];
      }
      steps += 1;
    }
  }

  // ---- final state (resident) ----
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    if (j < p.d) p.out_x[(size_t)chain * p.d + j] = acc_x[k];
  }
  if (lane == 0) {
    p.out_steps[chain] = steps;
    p.out_grads[chain] = grads;
    p.out_iters[chain] = iters;
  }
}

// ---------------------------------------------------------------------------
// The thread form: eight schools under the diagonal metric, one chain a thread
// ---------------------------------------------------------------------------
//
// At d = 10 a chain fits one thread's registers, so a warp runs 32 chains,
// as the Pallas kernel runs one chain a lane of the TPU's vector unit. Every
// sum that the registers form takes with a butterfly is a short tree of adds
// in one thread (thread_sum10, thread_sum8), in the butterfly's association
// order, so both forms give the same bits; nothing crosses lanes, so a
// leaf's dependent chain loses the registers form's shuffles. The leaf's x,
// m and g (updated in place), the accepted state, the subtree's sample and
// both momentum sums stay in registers; the checkpoint slots, indexed by a
// data-dependent level, live in shared memory as [level][m | msum][dim]
// [lane], so that a warp's 32 chains hit 32 banks; the proposal and the
// trajectory's two ends, touched at subtree boundaries only, live beside
// them as [vector][dim][lane]. A block is one warp: device memory for the
// ends, and blocks of more warps, measured slower (dc_kernel_ms.py: PERF.md
// §6). The draws are the registers form's: the same counter keys, one
// threefry block a leaf drawn before the gradient (as the resident form
// draws it). A warp runs its loop until its last chain is done; a finished or parked thread does nothing meanwhile, so per chain
// it, budget, steps and iters keep their meaning. The launch ends with its
// slowest warp, whose time is its slowest chain's iterations times the
// warp's iteration.
//
// Measured (PERF.md §6), it loses to the registers form at the
// tracked shape (512 chains x 800 transitions): 19.61 against 9.08 ms. A
// thread issues a chain's ten dims one after the other, so even alone its
// iteration (1,481 cycles) is slower than a warp's with its butterflies
// (1,290), and the warp runs every branch that one of its 32 chains takes,
// which nearly doubles that on the full launch; 512 chains fill 16 warps, one
// scheduler each, where the registers form gives each chain its own.

constexpr int kThreadDim = 10;  // eight schools

// the thread form's vectors beside the registers, by index
enum ThreadVec { kTPropX, kTPropG, kTLeftX, kTLeftM, kTLeftG, kTRightX, kTRightM, kTRightG,
                 kThreadVectors };

// floats of a block's (one warp's) checkpoint slots
__host__ __device__ constexpr int thread_slot_floats(int max_depth) {
  return 2 * max_depth * kThreadDim * 32;
}
// a block's dynamic shared memory, the slots and then the proposal and the
// ends; ops/fused_nuts_dc.py:shared_memory_plan mirrors it
__host__ __device__ constexpr size_t thread_block_bytes(int max_depth) {
  return (size_t)(thread_slot_floats(max_depth) + kThreadVectors * kThreadDim * 32) *
         sizeof(float);
}

// a chain's value of tracked coordinate r, by selects (no local memory)
__device__ __forceinline__ float tracked(const float (&x)[kThreadDim], int r) {
  float v = x[0];
#pragma unroll
  for (int k = 1; k < kThreadDim; ++k) v = r == k ? x[k] : v;
  return v;
}

// The machine of nuts_dc_kernel<1, F, M> with one chain a thread.
template <int F, int M>
__global__ void __launch_bounds__(32) nuts_dc_thread(const Params p) {
  static_assert(F == kEightSchoolsDC && M == kDiag, "the thread form runs eight schools, diag");
  constexpr int D = kThreadDim;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const int chain = blockIdx.x * 32 + lane;
  if (chain >= p.C) return;  // thread
  // slot i's m at ck[(2 i D + k) 32], its msum at ck[((2 i + 1) D + k) 32]
  float* const ck = smem + lane;
  // the proposal and the ends, [vector][dim][lane]
  float* const cold = ck + thread_slot_floats(p.max_depth);
  const auto vec = [&](int i) { return ColdVec<D>{cold + i * D * 32}; };
  ColdVec<D> prop_x = vec(kTPropX), prop_g = vec(kTPropG);
  ColdVec<D> left_x = vec(kTLeftX), left_m = vec(kTLeftM), left_g = vec(kTLeftG);
  ColdVec<D> right_x = vec(kTRightX), right_m = vec(kTRightM), right_g = vec(kTRightG);

  float imm[D], u[8], s[8];
  float x[D], m[D], g[D], w[D], acc_x[D], acc_g[D], sub_x[D], sub_g[D], msum[D], sub_msum[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    imm[k] = __ldg(p.imm + k);
    x[k] = p.x0[(size_t)chain * D + k];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    u[i] = __ldg(p.mat.u + i);
    s[i] = __ldg(p.mat.s + i);
  }
  float acc_ld = eight_schools_thread(u, s, x, g);
  copy<D>(acc_x, x); copy<D>(acc_g, g);

  float prop_ld = 0.f, sub_ld = 0.f, prop_w = 0.f, sub_w = 0.f, h0 = 0.f;
  float direction = 1.f, grads = 0.f;
  // the subtree's second uniform word (its biased merge) and the next
  // subtree's two words (its direction's and its merge's)
  uint32_t u_prop = 0u, u_next_dir = 0u, u_next_prop = 0u;
  int depth = 0, leaf = 0, nstates = 0, steps = 0;
  // iteration 0 starts with done = 1, so it opens the first transition;
  // prop_new: the proposal has moved off the accepted state this transition
  bool done = true, div = false, turn = false, prop_new = false;
  const int S = p.S;
  const int budget = p.budgets != nullptr ? p.budgets[chain] : p.budget;
  int iters = 0;  // thread
  for (int it = 0;; ++it) {
    if (it >= budget || steps >= S) break;
    // a closed chain restarts on the gated iterations only; until then it is
    // parked, and a parked leaf changes nothing the restart keeps
    if (done && it % p.restart_every != 0) continue;
    // counter key of this (chain, step), wrapping modulo 2^32 as the int32
    // of the reference (fused_nuts_dc.py:395)
    const uint32_t base_row = (uint32_t)chain * (uint32_t)S + (uint32_t)steps;

    if (done) {
      // ---- inline restart (thread) ----
      // the registers form's momentum keys (with their collision at chains *
      // num_steps >= 2^24, kept for parity: see nuts_dc_kernel); the
      // subtree's sample is set at its first leaf, and the proposal stays
      // the accepted state until a subtree is taken
      const uint32_t c1 = (1u << 24) | base_row;
      float e[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        uint32_t b1, b2;
        threefry2x32(p.seed, kKey1, (uint32_t)k, c1, b1, b2);
        m[k] = __ldg(p.sigma_m + k) * box_muller(b1, b2);
        e[k] = imm[k] * m[k] * m[k];
      }
      h0 = -acc_ld + 0.5f * thread_sum10(e);
      copy<D>(x, acc_x); copy<D>(g, acc_g);
      copy<D>(left_x, x); copy<D>(left_m, m); copy<D>(left_g, g);
      copy<D>(right_x, x); copy<D>(right_m, m); copy<D>(right_g, g);
      copy<D>(msum, m);
      prop_ld = acc_ld;
      prop_w = 0.f;
      prop_new = false;
      depth = leaf = nstates = 0;
      div = turn = done = false;
      threefry2x32(p.seed, kKey1, base_row, 2u << 24, u_next_dir, u_next_prop);  // depth 0's
    }

    // ---- subtree start (thread): the direction drawn ahead, the other end
    // read only on a turn of direction (see nuts_dc_resident) ----
    const bool at_start = leaf == 0;
    if (at_start) {
      u_prop = u_next_prop;
      const float last = direction;
      direction = to_unit(u_next_dir) < 0.5f ? -1.f : 1.f;
      if (depth > 0 && direction != last) {
        if (direction > 0.f) {
          copy<D>(x, right_x); copy<D>(m, right_m); copy<D>(g, right_g);
        } else {
          copy<D>(x, left_x); copy<D>(m, left_m); copy<D>(g, left_g);
        }
      }
    }
    const bool fwd = direction > 0.f;

    // ---- one velocity-Verlet leaf (thread) ----
    // the merge's uniform, or on a subtree's first leaf the next subtree's block
    uint32_t u_leaf, u_second;
    threefry2x32(p.seed, kKey1, base_row,
                 at_start ? (2u << 24) | (uint32_t)(depth + 1) : (3u << 24) | (uint32_t)nstates,
                 u_leaf, u_second);
    if (at_start) {
      u_next_dir = u_leaf;
      u_next_prop = u_second;
    }
    const float d_eps = direction * p.eps;
    const float half = 0.5f * d_eps;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      m[k] = m[k] + half * g[k];
      x[k] = x[k] + d_eps * (imm[k] * m[k]);
    }
    const float new_ld = eight_schools_thread(u, s, x, g);
    float e[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      m[k] = m[k] + half * g[k];
      w[k] = imm[k] * m[k];
      e[k] = w[k] * m[k];
      sub_msum[k] = at_start ? m[k] : sub_msum[k] + m[k];
    }
    const float energy = -new_ld + 0.5f * thread_sum10(e);
    float delta = h0 - energy;
    if (isnan(delta)) delta = -INFINITY;  // fused_nuts_dc.py:484
    const float leaf_w = delta;
    const bool leaf_div = -delta > p.threshold;

    // ---- progressive uniform merge within the subtree (thread) ----
    {
      const float p_acc = 1.f / (1.f + expf(-(leaf_w - sub_w)));
      const float merged_w = logaddexp(sub_w, leaf_w);
      if (at_start || to_unit(u_leaf) < p_acc) {
        copy<D>(sub_x, x); copy<D>(sub_g, g);
        sub_ld = new_ld;
      }
      sub_w = at_start ? leaf_w : merged_w;
    }

    // ---- checkpointed subtree U-turn (thread) ----
    const int idx_max = __popc(leaf >> 1);
    bool subtree_turning = false;
    if ((leaf & 1) == 0) {
      float* slot = ck + 2 * idx_max * D * 32;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        slot[k * 32] = m[k];
        slot[(D + k) * 32] = sub_msum[k];
      }
    } else {
      const int idx_min = idx_max - __popc(((~leaf) & (leaf + 1)) - 1) + 1;
      for (int i = idx_min; i <= idx_max && !subtree_turning; ++i) {
        const float* slot = ck + 2 * i * D * 32;
        float a[D], b[D];
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float ckm = slot[k * 32], cks = slot[(D + k) * 32];
          const float rho = sub_msum[k] - 0.5f * m[k] - cks + 0.5f * ckm;
          a[k] = imm[k] * ckm * rho;
          b[k] = w[k] * rho;
        }
        subtree_turning = thread_sum10(a) <= 0.f || thread_sum10(b) <= 0.f;
      }
    }

    // ---- subtree boundary: merge into the trajectory (thread) ----
    const bool aborted = leaf_div || subtree_turning;
    const bool closing = leaf + 1 >= (1 << depth) || aborted;
    bool full_turn = false;
    if (closing) {
      // the leaf becomes the end on its side; the full tree's check reads
      // the other end
      float a[D], b[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        msum[k] = msum[k] + sub_msum[k];
        float lm, rm;
        if (fwd) {
          right_x[k] = x[k]; right_m[k] = m[k]; right_g[k] = g[k];
          lm = left_m[k];
          rm = m[k];
        } else {
          left_x[k] = x[k]; left_m[k] = m[k]; left_g[k] = g[k];
          lm = m[k];
          rm = right_m[k];
        }
        const float rho = msum[k] - 0.5f * (lm + rm);
        a[k] = imm[k] * lm * rho;
        b[k] = imm[k] * rm * rho;
      }
      // biased merge toward the new subtree; an aborted subtree adds nothing.
      // min(NaN, 1) stays NaN, as jnp.minimum.
      const float ratio = expf(sub_w - prop_w);
      const float p_biased = ratio > 1.f ? 1.f : ratio;
      if (to_unit(u_prop) < p_biased && !aborted) {
        copy<D>(prop_x, sub_x); copy<D>(prop_g, sub_g);
        prop_ld = sub_ld;
        prop_new = true;
      }
      if (!aborted) prop_w = logaddexp(prop_w, sub_w);
      full_turn = thread_sum10(a) <= 0.f || thread_sum10(b) <= 0.f;
      depth += 1;
      leaf = 0;
    } else {
      leaf += 1;
    }

    // ---- transition close (thread) ----
    div = div || leaf_div;  // the divergence test is -delta > threshold
    turn = turn || (closing && (subtree_turning || full_turn));
    done = div || turn || (closing && depth >= p.max_depth);
    nstates += 1;
    if (done) {
      // grads counts nstates only when a transition closes (:581)
      grads = grads + (float)nstates;
      if (prop_new) {
        copy<D>(acc_x, prop_x); copy<D>(acc_g, prop_g);
      }
      acc_ld = prop_ld;
      iters = it + 1;
      // history row steps - 1 of the closed transition; rows never reached
      // keep the caller's zeros
      float* row = p.out_hist + ((size_t)chain * S + steps) * p.n_track;
      for (int t = 0; t < p.n_track; ++t) row[t] = tracked(acc_x, __ldg(p.track_rows + t));
      steps += 1;
    }
  }

  // ---- final state (thread) ----
#pragma unroll
  for (int k = 0; k < D; ++k) p.out_x[(size_t)chain * D + k] = acc_x[k];
  p.out_steps[chain] = steps;
  p.out_grads[chain] = grads;
  p.out_iters[chain] = iters;
}

template <int M>
cudaError_t launch_thread(const Params& p, cudaStream_t stream) {
  if constexpr (M != kDiag) {
    return cudaErrorInvalidValue;
  } else {
    const size_t smem = thread_block_bytes(p.max_depth);
    const auto kernel = nuts_dc_thread<kEightSchoolsDC, M>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         carveout_for(true));
    if (e == cudaSuccess && smem > 48 * 1024)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<(p.C + 31) / 32, 32, smem, stream>>>(p);
    return cudaGetLastError();
  }
}

// the carveout of the SM's shared memory that the resident form asks for
// (carveout_for)
template <int N, int M>
int resident_carveout(int max_depth) {
  return carveout_for(resident_slots_shared<N, M>(max_depth));
}

template <int N, int T, int M>
cudaError_t launch_resident(const Params& p, cudaStream_t stream) {
  const bool shared = resident_slots_shared<N, M>(p.max_depth);
  if (p.cold == nullptr || (!shared && p.slots == nullptr)) return cudaErrorInvalidValue;
  const size_t smem = resident_block_bytes<N, M>(p.max_depth);
  const auto kernel = nuts_dc_resident<N, T, M>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       resident_carveout<N, M>(p.max_depth));
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int blocks = (p.C + kResidentBlockWarps - 1) / kResidentBlockWarps;
  kernel<<<blocks, kResidentBlockWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// A block asks for more than the 48 KB default of shared memory through the
// attribute; past the card's 227 KB the attribute or the launch is refused,
// and the error comes back to the wrapper, which raises.
template <int N, int F, int M, bool kSharedX = false>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = block_bytes<N, F, M, kSharedX>(p.max_depth, p.mat.rows, p.mat.cols,
                                                      p.rank, p.metric_shared != 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nuts_dc_kernel<N, F, M, kSharedX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  constexpr int kBlock = block_warps<F>();
  const int blocks = (p.C + kBlock - 1) / kBlock;
  nuts_dc_kernel<N, F, M, kSharedX><<<blocks, kBlock * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// the family's instantiation for the target and the form the wrapper chose
// (form = 1: for the horseshoe X in shared memory, else X from L2; for the
// analytic targets the resident form, N <= 8, else one warp's state in
// registers; form = 2: eight schools' thread form, else its registers form);
// eight schools has d = 10
template <int N, int M>
cudaError_t launch_target(const Params& p, int form, cudaStream_t stream) {
  switch (p.target) {
    case kHierarchical:
    case kGaussian:
      if (!form) return launch<N, 0, M>(p, stream);
      if constexpr (N <= 8) {
        return p.target == kHierarchical ? launch_resident<N, kHierarchical, M>(p, stream)
                                         : launch_resident<N, kGaussian, M>(p, stream);
      } else {
        return cudaErrorInvalidValue;
      }
    case kLogRegDC:
      return launch<N, kLogRegDC, M>(p, stream);
    case kHorseshoeDC:
      return form ? launch<N, kHorseshoeDC, M, true>(p, stream)
                  : launch<N, kHorseshoeDC, M>(p, stream);
    case kEightSchoolsDC:
      if constexpr (N == 1) {
        return form == 2 ? launch_thread<M>(p, stream) : launch<1, kEightSchoolsDC, M>(p, stream);
      } else {
        return cudaErrorInvalidValue;
      }
  }
  return cudaErrorInvalidValue;
}

// checks the metric's operands and launches the instantiation for d: N = 1,
// 2, 4, 8 for every metric, and 13, 16 for the diagonal one
template <int M>
cudaError_t run_machine(const Params& p, int form, cudaStream_t s) {
  if constexpr (M == kDiag) {
    if (p.imm == nullptr || p.sigma_m == nullptr) return cudaErrorInvalidValue;
  } else if constexpr (M == kDense) {
    if (p.imm_t == nullptr || p.chol_t == nullptr) return cudaErrorInvalidValue;
  } else {
    if (p.imm == nullptr || p.sigma_m == nullptr || p.rank < 0 ||
        (p.rank > 0 && (p.U == nullptr || p.lam_m1 == nullptr || p.isl_m1 == nullptr)))
      return cudaErrorInvalidValue;
  }
  const int n = (p.d + 31) / 32;
  if (p.C <= 0) return cudaSuccess;
  if (n <= 1) return launch_target<1, M>(p, form, s);
  if (n <= 2) return launch_target<2, M>(p, form, s);
  if (n <= 4) return launch_target<4, M>(p, form, s);
  if (n <= 8) return launch_target<8, M>(p, form, s);
  if constexpr (M == kDiag) {
    if (p.cold == nullptr) return cudaErrorInvalidValue;  // N >= 13 from here
    if (n <= 13) return launch_target<13, M>(p, form, s);
    if (n <= 16) return launch_target<16, M>(p, form, s);
  }
  return cudaErrorInvalidValue;
}

// block_bytes of the instantiation for d with N registers per vector
template <int M, int N>
size_t block_bytes_for(int target, int form, int max_depth, int rows, int cols, int rank,
                       bool metric_shared) {
  switch (target) {
    case kLogRegDC:
      return block_bytes<N, kLogRegDC, M, false>(max_depth, rows, cols, rank, metric_shared);
    case kHorseshoeDC:
      return form ? block_bytes<N, kHorseshoeDC, M, true>(max_depth, rows, cols, rank, false)
                  : block_bytes<N, kHorseshoeDC, M, false>(max_depth, rows, cols, rank, false);
    case kEightSchoolsDC:
      if (form == 2) return thread_block_bytes(max_depth);
      return block_bytes<N, kEightSchoolsDC, M, false>(max_depth, rows, cols, rank, false);
    default:
      if constexpr (N <= 8) {
        if (form) return resident_block_bytes<N, M>(max_depth);
      }
      return block_bytes<N, 0, M, false>(max_depth, rows, cols, rank, false);
  }
}

// a chain's floats of scratch in device memory, {cold vectors, checkpoint
// slots}, of the instantiation for d with N registers per vector
template <int M, int N>
void scratch_floats_for(int target, int form, int max_depth, long long* out) {
  if (target == kEightSchoolsDC && form == 2) {
    out[0] = out[1] = 0;
    return;
  }
  const bool resident = N <= 8 && form && (target == kHierarchical || target == kGaussian);
  if constexpr (N <= 8) {
    if (resident) {
      out[0] = resident_cold_floats<N, M>();
      out[1] = resident_slots_shared<N, M>(max_depth) ? 0 : slot_floats<N, M>(max_depth);
      return;
    }
  }
  out[0] = kColdState<N> ? kColdVectors * N * 32 : 0;
  out[1] = target == kLogRegDC ? slot_floats<N, M>(max_depth) : 0;
}

// the analytic target's instantiation for d, in the form
template <int M, int N>
cudaError_t analytic_occupancy(int target, int form, int max_depth, int* out) {
  if constexpr (N <= 8) {
    if (form) {
      const size_t smem = resident_block_bytes<N, M>(max_depth);
      const int carveout = resident_carveout<N, M>(max_depth);
      return target == kHierarchical
                 ? occupancy_of(nuts_dc_resident<N, kHierarchical, M>, kResidentBlockWarps,
                                smem, out, carveout)
                 : occupancy_of(nuts_dc_resident<N, kGaussian, M>, kResidentBlockWarps, smem,
                                out, carveout);
    }
  } else if (form) {
    return cudaErrorInvalidValue;
  }
  return occupancy_of(nuts_dc_kernel<N, 0, M, false>, kWarps,
                      block_bytes<N, 0, M, false>(max_depth, 0, 0, 0, false), out);
}

// calls fn with the instantiation's N for d as a std::integral_constant,
// or returns fail where no instantiation takes d
template <int M, class Fn, class R>
R for_width(int d, Fn fn, R fail) {
  const int n = (d + 31) / 32;
  if (n <= 1) return fn(std::integral_constant<int, 1>{});
  if (n <= 2) return fn(std::integral_constant<int, 2>{});
  if (n <= 4) return fn(std::integral_constant<int, 4>{});
  if (n <= 8) return fn(std::integral_constant<int, 8>{});
  if constexpr (M == kDiag) {
    if (n <= 13) return fn(std::integral_constant<int, 13>{});
    if (n <= 16) return fn(std::integral_constant<int, 16>{});
  }
  return fail;
}

}  // namespace

extern "C" {

// Runs the machine of this source's metric (BJT_DC_METRIC); returns
// cudaGetLastError() of the launch (0 = success). imm, sigma_m, imm_t, chol_t,
// U, lam_m1, isl_m1 and rank are the metric's operands (Params; null and 0
// where unused); X, Xt, u, s, rows, cols and the host array k[8] are a matrix
// target's data (matrix_targets.cuh), null and 0 for the analytic targets.
// form is the form the wrapper chose: for the horseshoe, 1 launches the form
// that copies X into shared memory (Xt may then be null); for the analytic
// targets, 1 launches the resident form (d <= 256). Logistic regression
// always takes the tiles form: X is its tiles (logreg_tiles), Xt is not
// read, and metric_shared copies a dense or low-rank metric's matrices into
// shared memory. cold and slots are each chain's scratch in device memory
// (bjt_dc_scratch_floats a chain; null where it is 0): cold the vectors that
// the resident form and the N >= 13 instantiations keep out of registers,
// slots the checkpoint slots of the resident and the tiles forms.
int bjt_fused_nuts_dc(const float* x0, const float* imm, const float* sigma_m,
                      const float* imm_t, const float* chol_t, const float* U,
                      const float* lam_m1, const float* isl_m1,
                      const float* inv_var, const int* track_rows,
                      const int* budgets, float* out_x, int* out_steps,
                      float* out_grads, float* out_hist, int* out_iters, float* cold,
                      float* slots, const float* X, const float* Xt, const float* u,
                      const float* s_vec, int C, int d, int S, int n_track,
                      int max_depth, int budget, int restart_every, int target,
                      int rows, int cols, int form, int rank, int metric_shared, float eps,
                      float threshold, int seed, const float* k, void* stream) {
  MatrixData mat{X, Xt, u, s_vec, rows, cols, {}};
  for (int i = 0; i < 8; ++i) mat.k[i] = k[i];
  Params p{x0, imm, sigma_m, imm_t, chol_t, U, lam_m1, isl_m1, inv_var, track_rows,
           budgets, out_x, out_steps, out_grads, out_hist, out_iters, cold, slots, C, d, S,
           n_track, max_depth, budget, restart_every, target, rank, metric_shared, eps,
           threshold, (uint32_t)seed, mat};
  const bool analytic = target == kHierarchical || target == kGaussian;
  if (restart_every < 1) return cudaErrorInvalidValue;
  if (target == kGaussian && inv_var == nullptr) return cudaErrorInvalidValue;
  if (target == kLogRegDC && (X == nullptr || u == nullptr || slots == nullptr || cols != d))
    return cudaErrorInvalidValue;
  if (metric_shared && target != kLogRegDC) return cudaErrorInvalidValue;
  if (target == kHorseshoeDC && (X == nullptr || (Xt == nullptr && !form) || u == nullptr ||
                                 s_vec == nullptr || d != 2 * cols + 4))
    return cudaErrorInvalidValue;
  if (form < 0 || form > 2 || (form == 1 && target != kHorseshoeDC && !analytic) ||
      (form == 2 && target != kEightSchoolsDC))
    return cudaErrorInvalidValue;
  if (target == kEightSchoolsDC && (u == nullptr || s_vec == nullptr || d != 10))
    return cudaErrorInvalidValue;
  return run_machine<BJT_DC_METRIC>(p, form, static_cast<cudaStream_t>(stream));
}

// the dynamic shared memory a launch of bjt_fused_nuts_dc with these
// arguments asks for (block_bytes), or -1 where no instantiation takes d
long long bjt_dc_block_bytes(int d, int target, int form, int max_depth, int rows,
                             int cols, int rank, int metric_shared) {
  return for_width<BJT_DC_METRIC>(d, [&](auto width) {
    return (long long)block_bytes_for<BJT_DC_METRIC, decltype(width)::value>(
        target, form, max_depth, rows, cols, rank, metric_shared != 0);
  }, -1LL);
}

// a chain's floats of scratch in device memory that a launch with these
// arguments reads and writes: out[0] the cold vectors, out[1] the checkpoint
// slots; returns -1 where no instantiation takes d
int bjt_dc_scratch_floats(int d, int target, int form, int max_depth, long long* out) {
  return for_width<BJT_DC_METRIC>(d, [&](auto width) {
    scratch_floats_for<BJT_DC_METRIC, decltype(width)::value>(target, form, max_depth, out);
    return 0;
  }, -1);
}

// the instantiation for d in the form at max_depth, for an analytic target
// (form 1: resident) or eight schools (form 2: thread): out[0] its resident
// warps an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor times its warps
// a block), out[1] its registers a thread, out[2] its local memory a thread
// in bytes (spills); returns the CUDA error code
int bjt_dc_occupancy(int d, int target, int form, int max_depth, int* out) {
  if (target == kEightSchoolsDC) {
    if (d != kThreadDim) return cudaErrorInvalidValue;
    if (form == 2) {
      if constexpr (BJT_DC_METRIC != kDiag) {
        return cudaErrorInvalidValue;
      } else {
        return (int)occupancy_of(nuts_dc_thread<kEightSchoolsDC, kDiag>, 1,
                                 thread_block_bytes(max_depth), out, carveout_for(true));
      }
    }
    if (form != 0) return cudaErrorInvalidValue;
    return (int)occupancy_of(nuts_dc_kernel<1, kEightSchoolsDC, BJT_DC_METRIC, false>, kWarps,
                             block_bytes<1, kEightSchoolsDC, BJT_DC_METRIC, false>(
                                 max_depth, 0, 0, 0, false), out);
  }
  if (target != kHierarchical && target != kGaussian) return cudaErrorInvalidValue;
  return for_width<BJT_DC_METRIC>(d, [&](auto width) {
    return (int)analytic_occupancy<BJT_DC_METRIC, decltype(width)::value>(target, form != 0,
                                                                          max_depth, out);
  }, (int)cudaErrorInvalidValue);
}

const char* bjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

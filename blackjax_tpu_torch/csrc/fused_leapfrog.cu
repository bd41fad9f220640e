// The fused velocity-Verlet trajectory as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel blackjax_tpu/ops/fused_leapfrog.py:_leapfrog_kernel
// (launched by fused_leapfrog, pallas_call at fused_leapfrog.py:206), for the
// hierarchical, Gaussian and logistic-regression targets
// (make_logistic_regression_target, fused_leapfrog.py:324-400). The Python wrapper and the plain PyTorch
// version of the same trajectory live in blackjax_tpu_torch/ops/fused_leapfrog.py.
//
// What it computes, per chain: num_steps velocity-Verlet steps with an analytic
// gradient and a diagonal inverse mass matrix,
//   m += (0.5 eps) g;  x += eps (m imm);  g = grad(x);  m += (0.5 eps) g,
// starting from g = grad(x0), then the endpoint energy -logp(x) + 0.5 m.(imm m).
//
// Design. The TPU kernel holds a tile of chains in VMEM for the whole
// trajectory. Here one warp runs one chain: lane j holds dims j, j+32, j+64, ...
// in N registers per vector (N = 4 for d = 100; d <= 256), so x, m and g stay in
// registers from the first load to the last store. The targets' device
// functions are shared with the MCLMC kernel (analytic_targets.cuh,
// matrix_targets.cuh). The hierarchical target's sum of theta squares, its log
// density and the kinetic energy are xor-shuffle warp reductions, whose
// butterfly leaves the same bits in every lane. The kernel is a template on N
// and on the target family (F = 0 analytic, F = 2 logistic regression), so the
// analytic instantiations carry no code of the matrix target.
//
// The tiles form (logistic regression). Every chain runs the same steps in
// the same order, so the kFusedChainsLR warps of a block meet at every
// gradient without waiting, and the block computes it for all of them at
// once (logreg_tiles in matrix_targets.cuh, as in the MCLMC kernel): X
// streams through a double-buffered ring of tiles in shared memory, and each
// tile serves both contractions of every chain of the block. A warp past the
// last chain of a partial last block stays in with x = 0 (its zero inverse
// mass keeps it there), reaches each gradient with the block, and stores
// nothing.
//
// Bound. Device memory sees x and m once in and once out (16 bytes per dim and
// chain); per step a chain does O(d) FP32 multiply-adds, one exp and one warp
// reduction. The kernel is bound by the latency of that dependent chain of
// steps and reductions, not by bytes or FLOP: at d = 100 and 4,096 chains the
// whole grid is resident at once. Logistic regression adds two contractions
// with X per step (4 N d FLOP a chain), which bound it; read by every warp on
// its own (the L2 form), X would cross L2 8 N d bytes per chain and step.
//
// The transition form (hmc_transition, below) runs a whole fused_hmc
// transition (blackjax_tpu/ops/fused_hmc.py:76-115) for the analytic targets
// in one launch: the momentum from the caller's normal draws, both energies,
// this trajectory and the Metropolis accept.
//
// Numerics. Build without --use_fast_math and with --fmad=false: expf is the
// accurate library version and no multiply-add is contracted. Every expression
// keeps the reference's operation order (fused_leapfrog.py:114-129, the tile
// functions at :247-269 and :303-307, fused_hmc.py:82-110), masks included, so
// the kernel rounds like the plain PyTorch version except for the order of its
// sums.
#include <cuda_runtime.h>
#include <math.h>

#include "matrix_targets.cuh"  // warp_sum, target_grad, target_logdensity

namespace {

struct Params {
  const float* x0;       // (C, d) initial positions
  const float* m0;       // (C, d) initial momenta
  const float* imm;      // (d,) diagonal inverse mass matrix
  const float* inv_var;  // (d,) Gaussian target only, else null
  float* out_x;          // (C, d) end positions
  float* out_m;          // (C, d) end momenta
  float* out_energy;     // (C,) -logdensity(x_end) + kinetic(m_end)
  int C, d, num_steps, target;
  float eps;
  MatrixData mat;        // logistic regression's tiles of X, y, else zeros
};

template <int N, int F>
__global__ void __launch_bounds__(fused_block_warps<F>() * 32) leapfrog_kernel(const Params p) {
  constexpr bool kTiles = F == kLogisticRegression;
  extern __shared__ __align__(16) float smem[];  // the tiles form's ring of tiles
  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x * fused_block_warps<F>() + (threadIdx.x >> 5);
  const bool present = chain < p.C;
  if (!kTiles && !present) return;  // the whole warp leaves together
  const size_t row = (size_t)chain * p.d;

  // pad dims (j >= d), and every dim of a warp past the last chain, hold
  // zeros and a zero inverse mass, so they stay zero
  float x[N], m[N], g[N], imm[N], iv[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    const bool valid = present && j < p.d;
    x[k] = valid ? p.x0[row + j] : 0.f;
    m[k] = valid ? p.m0[row + j] : 0.f;
    imm[k] = valid ? p.imm[j] : 0.f;
    iv[k] = (valid && p.inv_var != nullptr) ? p.inv_var[j] : 0.f;
  }

  const float half = 0.5f * p.eps;
  target_grad<N, F, kTiles>(p, x, iv, g, lane, smem);
  for (int s = 0; s < p.num_steps; ++s) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      m[k] = m[k] + half * g[k];
      x[k] = x[k] + p.eps * (m[k] * imm[k]);
    }
    target_grad<N, F, kTiles>(p, x, iv, g, lane, smem);
#pragma unroll
    for (int k = 0; k < N; ++k) m[k] = m[k] + half * g[k];
  }

  float kin = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) kin += m[k] * m[k] * imm[k];
  const float energy =
      -target_logdensity<N, F, kTiles>(p, x, iv, lane, smem) + 0.5f * warp_sum(kin);
  if (!present) return;

#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    if (j < p.d) {
      p.out_x[row + j] = x[k];
      p.out_m[row + j] = m[k];
    }
  }
  if (lane == 0) p.out_energy[chain] = energy;
}

// A block of the tiles form asks for more than the 48 KB default of shared
// memory through the attribute; a refusal comes back to the wrapper, which
// raises.
template <int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.target == kLogisticRegression) {
    const size_t smem = fused_lr_block_bytes<N>(p.mat.cols);
    const auto kernel = leapfrog_kernel<N, kLogisticRegression>;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    constexpr int kBlock = fused_block_warps<kLogisticRegression>();
    kernel<<<(p.C + kBlock - 1) / kBlock, kBlock * 32, smem, stream>>>(p);
  } else {
    leapfrog_kernel<N, 0>
        <<<(p.C + kFusedWarps - 1) / kFusedWarps, kFusedWarps * 32, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

// ---- the transition form (hmc_transition): the analytic targets ----
//
// One launch is one fused_hmc transition, for every chain: from the caller's
// draws z ~ N(0, I) and u ~ U(0, 1),
//   m = z / sqrt(imm);  energy0 = -logdensity + 0.5 sum(m m imm);
//   the trajectory and energy1, as leapfrog_kernel computes them;
//   delta = energy0 - energy1 (NaN -> -inf);  p_accept = min(exp(delta), 1);
//   accept = u < p_accept;  then the position and the log density
//   -(energy1 - 0.5 sum(m_end m_end imm)) of the proposal, or the old ones.
// It writes the new positions, log densities, p_accept, the accept flags and
// energy1; the end momenta stay in registers (nothing reads them).
//
// The target is a template parameter (no run-time branch, and the masks of
// the hierarchical target are loop invariants). One warp holds one chain, as
// in leapfrog_kernel, and every sum runs in that kernel's order, so the
// trajectory and energy1 are its bits. x0 stays in registers for the reject.
//
// Bound. Device memory sees x0 and z in, x out (12 bytes a dim and chain)
// and 21 bytes a chain (the log density and u in; the log density,
// p_accept, energy1 and the flag out): 5.00 MB at 4,096 x 100, 1.49 us at
// 3.35 TB/s. Its operations are O(d) a step and chain. The flagship's 4,096
// chains run in one wave, and a step on a full SM takes about what it takes
// a lone chain: the launch is bound by the latency of the loads and of each
// step's dependent chain (the butterfly, expf), not by bytes or issue. So
// blocks of 2 to 32 warps measured no faster at d = 100, and neither did 16
// or 8 lanes a chain (a shorter butterfly, a longer sum in each lane; PERF.md
// has the sweep): one warp a chain and 4 warps a block stay
// (dc_kernel_ms.py --machine hmc --block-warps).

struct TransitionParams {
  const float* x0;       // (C, d) positions
  const float* ld0;      // (C,) their log densities
  const float* z;        // (C, d) standard normals, the momenta in the M^{1/2} basis
  const float* u;        // (C,) accept uniforms
  const float* imm;      // (d,) diagonal inverse mass matrix
  const float* inv_var;  // (d,) Gaussian target only, else null
  float* out_x;          // (C, d) new positions
  float* out_ld;         // (C,) new log densities
  float* out_p;          // (C,) p_accept
  bool* out_accept;      // (C,) is_accepted
  float* out_energy;     // (C,) energy1, the proposal's energy
  int C, d, num_steps;
  float eps;
};

// warps a block of the transition form
constexpr int kTransitionBlockWarps = 4;

template <int N, int T>
__global__ void __launch_bounds__(kTransitionBlockWarps * 32)
    hmc_transition(const TransitionParams p) {
  const int chain = blockIdx.x * kTransitionBlockWarps + (threadIdx.x >> 5);
  if (chain >= p.C) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const Analytic<T> tp{p.d};
  const size_t row = (size_t)chain * p.d;

  // ---- prologue (transition) ----
  // pad dims (j >= d) hold zeros and a zero inverse mass, so they stay zero
  float x[N], x0[N], m[N], g[N], imm[N], iv[N];
  float kin = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    const bool valid = j < p.d;
    x0[k] = x[k] = valid ? p.x0[row + j] : 0.f;
    imm[k] = valid ? p.imm[j] : 0.f;
    m[k] = valid ? p.z[row + j] / sqrtf(imm[k]) : 0.f;
    iv[k] = (T == kGaussian && valid) ? p.inv_var[j] : 0.f;
    kin += m[k] * m[k] * imm[k];
  }
  const float ld0 = p.ld0[chain];
  const float u = p.u[chain];
  const float energy0 = -ld0 + 0.5f * warp_sum(kin);
  const float half = 0.5f * p.eps;
  grad<N>(tp, x, iv, g, lane);
  // ---- the trajectory (transition) ----
  for (int s = 0; s < p.num_steps; ++s) {
    // ---- a kick and the drift (transition) ----
#pragma unroll
    for (int k = 0; k < N; ++k) {
      m[k] = m[k] + half * g[k];
      x[k] = x[k] + p.eps * (m[k] * imm[k]);
    }
    // ---- the gradient (transition) ----
    grad<N>(tp, x, iv, g, lane);
    // ---- the second kick (transition) ----
#pragma unroll
    for (int k = 0; k < N; ++k) m[k] = m[k] + half * g[k];
    // ---- the step's end (transition) ----
  }

  // ---- epilogue (transition) ----
  float kin1 = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) kin1 += m[k] * m[k] * imm[k];
  const float kinetic1 = 0.5f * warp_sum(kin1);
  const float energy1 = -logdensity<N>(tp, x, iv, lane) + kinetic1;
  float delta = energy0 - energy1;
  if (isnan(delta)) delta = -INFINITY;
  const float p_accept = fminf(expf(delta), 1.0f);
  const bool accept = u < p_accept;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    if (j < p.d) p.out_x[row + j] = accept ? x[k] : x0[k];
  }
  if (lane == 0) {
    p.out_ld[chain] = accept ? -(energy1 - kinetic1) : ld0;
    p.out_p[chain] = p_accept;
    p.out_accept[chain] = accept;
    p.out_energy[chain] = energy1;
  }
  // ---- the chain's end (transition) ----
}

template <int N, int T>
cudaError_t launch_transition(const TransitionParams& p, cudaStream_t stream) {
  hmc_transition<N, T><<<(p.C + kTransitionBlockWarps - 1) / kTransitionBlockWarps,
                         kTransitionBlockWarps * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

// registers a lane and vector at width d: the fewest of 1, 2, 4, 8 that hold
// d on 32 lanes (d <= 256)
template <int T>
cudaError_t launch_transition_n(const TransitionParams& p, cudaStream_t stream) {
  if (p.d <= 32) return launch_transition<1, T>(p, stream);
  if (p.d <= 64) return launch_transition<2, T>(p, stream);
  if (p.d <= 128) return launch_transition<4, T>(p, stream);
  return launch_transition<8, T>(p, stream);
}

}  // namespace

extern "C" {

// Runs the trajectory; returns cudaGetLastError() of the launch (0 = success).
// X is logistic regression's data matrix as tiles
// (bjt_fused_tiles_layout: rows at the stride shared_x_stride(d),
// zero padded to whole tiles), y its rows labels (rows,), and k0, k1 its 1 /
// prior_scale^2 and -0.5 / prior_scale^2 (null and 0 otherwise).
int bjt_fused_leapfrog(const float* x0, const float* m0, const float* imm,
                       const float* inv_var, const float* X,
                       const float* y, float* out_x, float* out_m,
                       float* out_energy, int C, int d, int num_steps,
                       int target, int rows, float eps, float k0, float k1,
                       void* stream) {
  Params p{x0, m0, imm, inv_var, out_x, out_m, out_energy,
           C, d, num_steps, target, eps, {X, nullptr, y, nullptr, rows, d, {k0, k1}}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (target != kHierarchical && target != kGaussian && target != kLogisticRegression)
    return cudaErrorInvalidValue;
  if (target == kGaussian && inv_var == nullptr) return cudaErrorInvalidValue;
  if (target == kLogisticRegression && (X == nullptr || y == nullptr))
    return cudaErrorInvalidValue;
  if (C <= 0) return cudaSuccess;
  const int n = (d + 31) / 32;
  if (n <= 1) return launch<1>(p, s);
  if (n <= 2) return launch<2>(p, s);
  if (n <= 4) return launch<4>(p, s);
  if (n <= 8) return launch<8>(p, s);
  return cudaErrorInvalidValue;
}

// Runs one fused_hmc transition on the hierarchical (target 0) or the
// Gaussian (target 1) target; returns cudaGetLastError() of the launch (0 =
// success). z and u are the transition's draws; the outputs are the new
// positions and log densities, p_accept, the accept flags and energy1.
int bjt_hmc_transition(const float* x0, const float* ld0, const float* z, const float* u,
                       const float* imm, const float* inv_var, float* out_x, float* out_ld,
                       float* out_p, bool* out_accept, float* out_energy, int C, int d,
                       int num_steps, int target, float eps, void* stream) {
  const TransitionParams p{x0, ld0, z, u, imm, inv_var, out_x, out_ld, out_p, out_accept,
                           out_energy, C, d, num_steps, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (target != kHierarchical && target != kGaussian) return cudaErrorInvalidValue;
  if (target == kGaussian && inv_var == nullptr) return cudaErrorInvalidValue;
  if (d < 1 || d > 256) return cudaErrorInvalidValue;
  if (C <= 0) return cudaSuccess;
  return target == kHierarchical
             ? launch_transition_n<kHierarchical>(p, s)
             : launch_transition_n<kGaussian>(p, s);
}

// The tiles form's layout for width d (fused_lr_layout), which both fused
// kernels' wrappers read.
int bjt_fused_tiles_layout(int d, long long* out) { return fused_lr_layout(d, out); }

const char* bjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

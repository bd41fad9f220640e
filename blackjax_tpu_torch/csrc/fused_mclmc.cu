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
// store per chain.
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
  float eps, L;
  uint32_t seed;
  float coef[kMaxStages];  // kicks at even stages, drifts at odd ones
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

// The overflow-free ESH momentum update (fused_mclmc.py:146-157).
template <int N>
__device__ __forceinline__ void kick(float (&m)[N], const float (&g)[N],
                                     const float (&sqrt_imm)[N], float dt,
                                     float dims) {
  float gw[N], e[N];
#pragma unroll
  for (int k = 0; k < N; ++k) gw[k] = g[k] * sqrt_imm[k];
  const float grad_norm = row_norm<N>(gw);
  const float scale = nan_max(grad_norm, 1e-30f);
  float pr = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    e[k] = gw[k] / scale;
    pr += m[k] * e[k];
  }
  const float proj = warp_sum(pr);
  const float delta = dt * grad_norm / (dims - 1.0f);
  const float zeta = expf(-delta);
  const float a = (1.0f - zeta) * (1.0f + zeta + proj * (1.0f - zeta));
  const float b = 2.0f * zeta;
#pragma unroll
  for (int k = 0; k < N; ++k) gw[k] = e[k] * a + b * m[k];  // unnormalized
  const float norm = nan_max(row_norm<N>(gw), 1e-30f);
#pragma unroll
  for (int k = 0; k < N; ++k) m[k] = gw[k] / norm;
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
// prior_scale^2 and -0.5 / prior_scale^2 (null and 0 otherwise).
int bjt_fused_mclmc(const float* x0, const float* m0, const float* imm,
                    const float* inv_var, const float* X,
                    const float* y, const int* track, float* out_x,
                    float* out_m, float* out_logdensity, float* out_hist,
                    const float* coefs, int n_coef, int C, int d, int num_steps,
                    int n_track, int target, int rows, int refresh, float eps,
                    float L, float k0, float k1, uint32_t seed, void* stream) {
  if (target != kHierarchical && target != kGaussian && target != kLogisticRegression)
    return cudaErrorInvalidValue;
  if (target == kGaussian && inv_var == nullptr) return cudaErrorInvalidValue;
  if (target == kLogisticRegression && (X == nullptr || y == nullptr))
    return cudaErrorInvalidValue;
  if (n_coef < 1 || n_coef > kMaxStages || n_coef % 2 == 0) return cudaErrorInvalidValue;
  if (n_track > 0 && track == nullptr) return cudaErrorInvalidValue;
  Params p{x0, m0, imm, inv_var, track, out_x, out_m, out_logdensity, out_hist,
           C, d, round_up_lanes(d), num_steps, n_track, target, refresh, n_coef,
           eps, L, seed, {}, {X, nullptr, y, nullptr, rows, d, {k0, k1}}};
  for (int i = 0; i < n_coef; ++i) p.coef[i] = coefs[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0) return cudaSuccess;
  const int n = (d + 31) / 32;
  if (n <= 1) return launch<1>(p, s);
  if (n <= 2) return launch<2>(p, s);
  if (n <= 4) return launch<4>(p, s);
  if (n <= 8) return launch<8>(p, s);
  return cudaErrorInvalidValue;
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

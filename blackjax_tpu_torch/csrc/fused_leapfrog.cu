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
// analytic instantiations carry no code of the matrix target; logistic
// regression stages w and each chunk of 32 rows in a per-warp scratch of
// shared memory.
//
// Bound. Device memory sees x and m once in and once out (16 bytes per dim and
// chain); per step a chain does O(d) FP32 multiply-adds, one exp and one warp
// reduction. The kernel is bound by the latency of that dependent chain of
// steps and reductions, not by bytes or FLOP: at d = 100 and 4,096 chains the
// whole grid is resident at once. Logistic regression adds two contractions
// with X per step (4 N d FLOP, 8 N d bytes from L2 per chain): with every warp
// reading X on its own, the kernel is bound by L2 bandwidth (see
// matrix_targets.cuh).
//
// Numerics. Build without --use_fast_math and with --fmad=false: expf is the
// accurate library version and no multiply-add is contracted. Every expression
// keeps the reference's operation order (fused_leapfrog.py:114-129, the tile
// functions at :247-269 and :303-307), masks included, so the kernel rounds
// like the plain PyTorch version except for the order of its sums.
#include <cuda_runtime.h>
#include <math.h>

#include "matrix_targets.cuh"  // warp_sum, target_grad, target_logdensity

namespace {

constexpr int kWarps = 4;  // chains per block

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
  MatrixData mat;        // logistic regression's data, else zeros
};

template <int N, int F>
__global__ void __launch_bounds__(kWarps * 32) leapfrog_kernel(const Params p) {
  extern __shared__ float smem[];  // logistic regression's per-warp scratch
  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (chain >= p.C) return;  // the whole warp leaves together
  float* scratch = smem + (threadIdx.x >> 5) * scratch_floats<N>();
  const size_t row = (size_t)chain * p.d;

  // pad dims (j >= d) hold zeros and a zero inverse mass, so they stay zero
  float x[N], m[N], g[N], imm[N], iv[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    const bool valid = j < p.d;
    x[k] = valid ? p.x0[row + j] : 0.f;
    m[k] = valid ? p.m0[row + j] : 0.f;
    imm[k] = valid ? p.imm[j] : 0.f;
    iv[k] = (valid && p.inv_var != nullptr) ? p.inv_var[j] : 0.f;
  }

  const float half = 0.5f * p.eps;
  target_grad<N, F>(p, x, iv, g, lane, scratch);
  for (int s = 0; s < p.num_steps; ++s) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      m[k] = m[k] + half * g[k];
      x[k] = x[k] + p.eps * (m[k] * imm[k]);
    }
    target_grad<N, F>(p, x, iv, g, lane, scratch);
#pragma unroll
    for (int k = 0; k < N; ++k) m[k] = m[k] + half * g[k];
  }

  float kin = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) kin += m[k] * m[k] * imm[k];
  const float energy = -target_logdensity<N, F>(p, x, iv, lane, scratch) + 0.5f * warp_sum(kin);

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

template <int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int blocks = (p.C + kWarps - 1) / kWarps;
  if (p.target == kLogisticRegression) {
    const size_t smem = (size_t)kWarps * scratch_floats<N>() * sizeof(float);
    leapfrog_kernel<N, kLogisticRegression><<<blocks, kWarps * 32, smem, stream>>>(p);
  } else {
    leapfrog_kernel<N, 0><<<blocks, kWarps * 32, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs the trajectory; returns cudaGetLastError() of the launch (0 = success).
// X (rows, d), Xt and y (rows,) are logistic regression's data and k0, k1 its
// 1 / prior_scale^2 and -0.5 / prior_scale^2 (null and 0 otherwise).
int bjt_fused_leapfrog(const float* x0, const float* m0, const float* imm,
                       const float* inv_var, const float* X, const float* Xt,
                       const float* y, float* out_x, float* out_m,
                       float* out_energy, int C, int d, int num_steps,
                       int target, int rows, float eps, float k0, float k1,
                       void* stream) {
  Params p{x0, m0, imm, inv_var, out_x, out_m, out_energy,
           C, d, num_steps, target, eps, {X, Xt, y, nullptr, rows, d, {k0, k1}}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (target != kHierarchical && target != kGaussian && target != kLogisticRegression)
    return cudaErrorInvalidValue;
  if (target == kGaussian && inv_var == nullptr) return cudaErrorInvalidValue;
  if (target == kLogisticRegression && (X == nullptr || Xt == nullptr || y == nullptr))
    return cudaErrorInvalidValue;
  if (C <= 0) return cudaSuccess;
  const int n = (d + 31) / 32;
  if (n <= 1) return launch<1>(p, s);
  if (n <= 2) return launch<2>(p, s);
  if (n <= 4) return launch<4>(p, s);
  if (n <= 8) return launch<8>(p, s);
  return cudaErrorInvalidValue;
}

const char* bjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

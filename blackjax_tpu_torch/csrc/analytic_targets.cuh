// Device functions of the analytic targets that the fused kernels share
// (csrc/fused_leapfrog.cu, csrc/fused_mclmc.cu): the hierarchical Gaussian and
// the independent Gaussian, as the reference's tile functions compute them
// (blackjax_tpu/ops/fused_leapfrog.py, make_hierarchical_gaussian_target and
// make_gaussian_target).
//
// One warp holds one chain: lane j holds dims j, j+32, j+64, ... in N registers
// per vector, and pad dims (j >= d) hold zeros. The functions take the kernel's
// parameter struct P for its fields d (the dimension) and target (a Target).
// Sums over dims are xor-shuffle warp reductions, whose butterfly leaves the
// same bits in every lane.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

enum Target { kHierarchical = 0, kGaussian = 1 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The analytic target T fixed at compile time, for grad and logdensity,
// which read the fields d and target.
template <int T>
struct Analytic {
  int d;
  static constexpr int target = T;
};

// sum over dims of (x * theta_mask)^2, theta_mask = 1 on dims 1..d-1
template <int N, class P>
__device__ __forceinline__ float theta_sq(const P& p, const float (&x)[N],
                                          int lane) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    const float t = x[k] * ((j >= 1 && j < p.d) ? 1.f : 0.f);
    s += t * t;
  }
  return warp_sum(s);
}

// The target's gradient, as grad_tile (fused_leapfrog.py:259-269, :306-307).
template <int N, class P>
__device__ __forceinline__ void grad(const P& p, const float (&x)[N],
                                     const float (&iv)[N], float (&g)[N],
                                     int lane) {
  if (p.target == kHierarchical) {
    const float log_tau = __shfl_sync(kFull, x[0], 0);
    const float exp_neg = expf(-log_tau);
    const float ts = theta_sq<N>(p, x, lane);
    const float half_n_theta = 0.5f * (float)(p.d - 1);
    const float g_tau = -log_tau + 0.5f * ts * exp_neg - half_n_theta;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int j = k * 32 + lane;
      const float is_tau = j == 0 ? 1.f : 0.f;
      const float theta_mask = (j >= 1 && j < p.d) ? 1.f : 0.f;
      g[k] = is_tau * g_tau + -(x[k] * theta_mask) * exp_neg;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < N; ++k) g[k] = -x[k] * iv[k];
}

// The target's log density, as logdensity_tile (:247-257, :303-304).
template <int N, class P>
__device__ __forceinline__ float logdensity(const P& p, const float (&x)[N],
                                            const float (&iv)[N], int lane) {
  if (p.target == kHierarchical) {
    const float log_tau = __shfl_sync(kFull, x[0], 0);
    const float ts = theta_sq<N>(p, x, lane);
    const float half_n_theta = 0.5f * (float)(p.d - 1);
    return -0.5f * (log_tau * log_tau) - 0.5f * ts * expf(-log_tau) -
           half_n_theta * log_tau;
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) s += x[k] * x[k] * iv[k];
  return -0.5f * warp_sum(s);
}

}  // namespace

// The sustained FP32 element-update rate of one instruction mix, as one CUDA
// kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel benchmarks/vpu_peak.py:_kernel (run by _run,
// pallas_call at vpu_peak.py:58), the roofline through which every bound of
// the dc machine was read. The Python wrapper and the plain PyTorch version of
// the same loop live in blackjax_tpu_torch/ops/vpu_peak.py.
//
// What it computes, per element of x (rows, 128) f32: iters updates with
// b = a * 0.5 and t = a * 0.25, where a is a run-time scalar (nothing
// constant-folds), in one of two modes:
//   fma:    x = x * a + b
//   select: x = x > t ? x * a + b : x + b
// and in one of two roundings of x * a + b: fused, one rounding (__fmaf_rn),
// or unfused, two (__fmul_rn then __fadd_rn), which is what the port's other
// kernels compile x * a + b to under --fmad=false. Both roundings are written
// with intrinsics, so the flags leave them as they are.
//
// Design. The TPU kernel holds the whole block in vector registers and sweeps
// its height (64-1,024 rows: 8-128 vregs) to change the live-register
// pressure. Here each thread keeps N values in registers (the N = ceil(d / 32)
// values a lane of the port's one-warp-a-chain kernels, N = 1..16), elements
// t, t + T, ..., t + (N - 1) T of the flat block for T threads in all, so
// loads and stores are coalesced. A block is W warps; the wrapper sizes x so
// that the grid is one block an SM, which fills every SM at W warps. The
// iteration loop is unrolled by 16, so loop control costs one integer
// instruction in 16 updates of each value.

#include <cuda_runtime.h>

namespace {

template <int N, bool kFused, bool kSelect>
__global__ void vpu_peak_kernel(const float* __restrict__ x, float* __restrict__ out,
                                float a, int iters, long long total) {
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float b = __fmul_rn(a, 0.5f);
  const float thr = __fmul_rn(a, 0.25f);
  float v[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const long long i = t + k * threads;
    v[k] = i < total ? x[i] : 0.0f;
  }
#pragma unroll 16
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float update = kFused ? __fmaf_rn(v[k], a, b) : __fadd_rn(__fmul_rn(v[k], a), b);
      if constexpr (kSelect) {
        v[k] = v[k] > thr ? update : __fadd_rn(v[k], b);
      } else {
        v[k] = update;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const long long i = t + k * threads;
    if (i < total) out[i] = v[k];
  }
}

template <int N>
cudaError_t launch_n(const float* x, float* out, float a, int iters, long long total, int fused,
                     int select, int warps, cudaStream_t stream) {
  const int threads = 32 * warps;
  const long long per_block = static_cast<long long>(threads) * N;
  const int blocks = static_cast<int>((total + per_block - 1) / per_block);
  if (fused && select) {
    vpu_peak_kernel<N, true, true><<<blocks, threads, 0, stream>>>(x, out, a, iters, total);
  } else if (fused) {
    vpu_peak_kernel<N, true, false><<<blocks, threads, 0, stream>>>(x, out, a, iters, total);
  } else if (select) {
    vpu_peak_kernel<N, false, true><<<blocks, threads, 0, stream>>>(x, out, a, iters, total);
  } else {
    vpu_peak_kernel<N, false, false><<<blocks, threads, 0, stream>>>(x, out, a, iters, total);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs iters updates of the total elements of x into out; n values a thread
// (1, 2, 4, 8, 13 or 16), warps a block (1..32), fused (0/1) and select
// (0/1). Returns cudaGetLastError() of the launch (0 = success);
// cudaErrorInvalidValue for an n that is not instantiated.
int bjt_vpu_peak(const void* x, void* out, float a, int iters, long long total, int n,
                 int warps, int fused, int select, void* stream) {
  const float* xs = static_cast<const float*>(x);
  float* os = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warps < 1 || warps > 32 || total <= 0) return cudaErrorInvalidValue;
  switch (n) {
    case 1: return launch_n<1>(xs, os, a, iters, total, fused, select, warps, s);
    case 2: return launch_n<2>(xs, os, a, iters, total, fused, select, warps, s);
    case 4: return launch_n<4>(xs, os, a, iters, total, fused, select, warps, s);
    case 8: return launch_n<8>(xs, os, a, iters, total, fused, select, warps, s);
    case 13: return launch_n<13>(xs, os, a, iters, total, fused, select, warps, s);
    case 16: return launch_n<16>(xs, os, a, iters, total, fused, select, warps, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* bjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

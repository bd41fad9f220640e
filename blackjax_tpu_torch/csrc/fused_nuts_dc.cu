// The continuous NUTS machine with the diagonal metric (the machine itself is
// in fused_nuts_dc.cuh), and the kernel's own threefry2x32 as an export with a
// key per element: the port's jax.random draws through it, and it is checked bit
// for bit against the plain version.
#define BJT_DC_METRIC kDiag
#include "fused_nuts_dc.cuh"

namespace {

// one block per element, each under its own key: the port's jax.random
// (blackjax_tpu_torch/prng.py) derives every chain's keys through it. Words
// travel as int64 (PyTorch's integer type): the low 32 bits in, the word in
// [0, 2^32) out.
__global__ void threefry_kernel(const int64_t* k0, const int64_t* k1, const int64_t* c0,
                                const int64_t* c1, int64_t* o0, int64_t* o1, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x0, x1;
  threefry2x32((uint32_t)k0[i], (uint32_t)k1[i], (uint32_t)c0[i], (uint32_t)c1[i], x0, x1);
  o0[i] = (int64_t)x0;
  o1[i] = (int64_t)x1;
}

}  // namespace

extern "C" int bjt_threefry2x32(const int64_t* k0, const int64_t* k1, const int64_t* c0,
                                const int64_t* c1, int64_t* o0, int64_t* o1, int n,
                                void* stream) {
  if (n <= 0) return cudaSuccess;
  threefry_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, c0, c1, o0, o1, n);
  return cudaGetLastError();
}

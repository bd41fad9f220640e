// The continuous NUTS machine with the diagonal metric (the machine itself is
// in fused_nuts_dc.cuh), and the kernel's own threefry2x32 as an export for
// checking it bit for bit against the plain version.
#define BJT_DC_METRIC kDiag
#include "fused_nuts_dc.cuh"

namespace {

__global__ void threefry_kernel(const uint32_t* c0, const uint32_t* c1,
                                uint32_t k0, uint32_t k1, uint32_t* o0,
                                uint32_t* o1, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) threefry2x32(k0, k1, c0[i], c1[i], o0[i], o1[i]);
}

}  // namespace

extern "C" int bjt_threefry2x32(const uint32_t* c0, const uint32_t* c1, uint32_t k0,
                                uint32_t k1, uint32_t* o0, uint32_t* o1, int n,
                                void* stream) {
  if (n <= 0) return cudaSuccess;
  threefry_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      c0, c1, k0, k1, o0, o1, n);
  return cudaGetLastError();
}

// What the resident forms of the two NUTS machines share: the dc machine's
// (nuts_dc_resident in csrc/fused_nuts_dc.cuh) and the older machine's
// (nuts_resident in csrc/fused_nuts.cu).
//
// A resident form runs one chain a warp and one warp a block, so that a
// finished chain's slot takes the next chain at once, and is built for many
// warps an SM. It keeps in registers only the leaf's hot vectors; the chain's
// state that a transition touches only at its restarts and subtree boundaries
// lives in a per-chain scratch in device memory (ColdVec, which stays in
// L2), and the checkpoint slots live in shared memory where the SM's warps
// fit them (slots_fit_shared), else beside the rest. Its reductions run their
// butterflies side by side (warp_sums).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "analytic_targets.cuh"  // kFull

namespace {

// A vector of a warp's chain in device memory: the lane's element k lies at
// p[k * 32], so that the warp reads and writes it coalesced.
template <int N>
struct ColdVec {
  float* p;
  __device__ __forceinline__ float& operator[](int k) { return p[k * 32]; }
  __device__ __forceinline__ float operator[](int k) const { return p[k * 32]; }
};

template <int N, class A, class B>
__device__ __forceinline__ void copy(A& dst, const B& src) {
#pragma unroll
  for (int k = 0; k < N; ++k) dst[k] = src[k];
}

// the xor butterfly of warp_sum on K values at once: each value is summed in
// warp_sum's order (so every lane holds the same bits), and the K chains of
// shuffles overlap
template <int K>
__device__ __forceinline__ void warp_sums(float (&v)[K]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] += __shfl_xor_sync(kFull, v[i], o);
  }
}

// checkpoint slot i of a chain whose slots hold V vectors each (m and msum,
// and w for the dc machine's dense and low-rank metrics), one vector after
// the other, level by level
template <int N, int V>
__device__ __forceinline__ float* slot_level(float* slots, int i) {
  return slots + i * V * N * 32;
}

// the shared memory an SM shares among its blocks (228 KB), and what each
// block of them reserves for the system
constexpr int kSmemPerSM = 233472;
constexpr int kSmemReserved = 1024;

// whether blocks of block_warps warps, each warp with floats of shared
// memory, fit warps warps on an SM beside each block's reserve
__host__ __device__ constexpr bool slots_fit_shared(int warps, int block_warps, int floats) {
  return warps / block_warps * (block_warps * floats * (int)sizeof(float) + kSmemReserved) <=
         kSmemPerSM;
}

// the carveout of the SM's shared memory that a resident form asks for: the
// most shared memory where its slots live there, else the default carveout (a
// carveout for the most L1 leaves room for the 1 KB that each block reserves
// for 8 blocks only, 8 warps an SM at one warp a block)
inline int carveout_for(bool slots_shared) {
  return slots_shared ? (int)cudaSharedmemCarveoutMaxShared
                      : (int)cudaSharedmemCarveoutDefault;
}

// registers, local memory and resident warps an SM of a kernel launched
// with block_warps warps a block and smem bytes of dynamic shared memory
template <class K>
cudaError_t occupancy_of(K kernel, int block_warps, size_t smem, int* out, int carveout = -1) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess && carveout >= 0)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, block_warps * 32, smem);
  out[0] *= block_warps;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  return e;
}

}  // namespace

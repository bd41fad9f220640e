// The reference's counter-based random numbers as device functions, shared by
// csrc/fused_nuts_dc.cu and csrc/fused_mclmc.cu; the plain versions are in
// blackjax_tpu_torch/ops/counter_rng.py, and the two agree bit for bit on the
// threefry words.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t kKey1 = 0x9E3779B9u;  // second key word of every draw
constexpr float kU24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoPi = 6.283185307179586f;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// 20-round threefry2x32, the reference's _threefry2x32
// (blackjax_tpu/ops/fused_mclmc.py:54) in native uint32 arithmetic.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
  constexpr int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const uint32_t keys[6] = {k1, ks2, k0, k1, ks2, k0};
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#pragma unroll
  for (int b = 0; b < 5; ++b) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, rot[(b % 2) * 4 + i]);
      x1 ^= x0;
    }
    x0 += keys[b];
    x1 += keys[b + 1] + (uint32_t)(b + 1);
  }
  o0 = x0;
  o1 = x1;
}

// top 24 bits as f32 in [0, 1), as _counter_uniforms builds it
__device__ __forceinline__ float to_unit(uint32_t w) {
  return (float)(int)(w >> 8) * kU24;
}

// One standard normal from a threefry block by Box-Muller; u1 carries the +1
// offset that keeps it off zero before the log (fused_mclmc.py:83-89,
// fused_nuts_dc.py:417-425).
__device__ __forceinline__ float box_muller(uint32_t b1, uint32_t b2) {
  const float u1 = ((float)(int)(b1 >> 8) + 1.0f) * kU24;
  const float u2 = to_unit(b2);
  return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
}

}  // namespace

// Shared helpers for the hand-written attention kernels (built with nvcc for sm_90a,
// bound through ctypes by surya_tpu_torch/ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace surya {

// Finite mask sentinel, as in the Pallas kernels: exp(m_prev - m_new) never
// becomes exp(-inf + inf) while a row has seen no valid key yet.
constexpr float NEG_INF = -1e30f;

// 8 bf16 values (one 16-byte load) -> 8 floats.
__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 8 floats -> 8 bf16 values (round to nearest even) packed for one 16-byte store.
__device__ __forceinline__ uint4 float_to_bf16x8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// Sum of `x` over the `width` neighbouring lanes that share one row (width a
// power of two dividing 32). Every lane of the warp must call it.
template <int WIDTH>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < WIDTH; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace surya

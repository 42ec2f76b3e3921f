// Shared helpers of the port's attention kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro {

constexpr float kNegInf = -1e30f;  // finite, as in the JAX kernels

// dtype codes shared with the Python wrappers (kernels/build.py)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like astype
}

// Load N consecutive elements starting at p into fp32 registers. N * sizeof(T)
// of 4, 8 or 16 bytes is one vector load; the wrapper checks the alignment.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float* out) {
  constexpr int bytes = N * static_cast<int>(sizeof(T));
  if constexpr (bytes == 16) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f<T>(e[i]);
  } else if constexpr (bytes == 8) {
    uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f<T>(e[i]);
  } else if constexpr (bytes == 4) {
    uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f<T>(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f<T>(p[i]);
  }
}

}  // namespace repro

// Element-type helpers shared by the port's kernels.
//
// Kernels read bf16 or f32 tensors, compute in f32 and round results back
// to the tensor's type with round-to-nearest-even, as XLA's astype does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sleap {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T's precision, kept as f32.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// jnp.maximum(v, 0): NaN stays NaN.
__device__ __forceinline__ float relu_nan(float v) { return v < 0.f ? 0.f : v; }

}  // namespace sleap

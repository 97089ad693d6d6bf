// Shared helpers for the port's CUDA kernels: element conversion between
// the storage types (float, bf16) and the fp32 the kernels compute in.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace spann3r {

template <typename T>
__device__ __forceinline__ float to_f(T x);

template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }

template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);

template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// round to nearest even, as torch's .to(torch.bfloat16)
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// dtype codes passed by the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

}  // namespace spann3r

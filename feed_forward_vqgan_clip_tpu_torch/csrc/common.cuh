// Helpers shared by the port's CUDA kernels (built for sm_90a by ops/kernels/build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ffvc {

// Working types of the kernels: 0 = float32, 1 = bfloat16 (the `dtype` argument of
// every entry point that takes activations).
enum DType : int { kF32 = 0, kBF16 = 1 };

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
// round to nearest even, as torch and XLA round f32 -> bf16
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

}  // namespace ffvc

// Every C entry point returns this: the launch's cudaGetLastError() as an int, so a
// refused launch (bad grid, too much shared memory) reaches the Python wrapper.
#define FFVC_RETURN_LAST_ERROR() return static_cast<int>(cudaGetLastError())

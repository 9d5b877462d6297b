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

// Eight consecutive elements, one 16-byte vector in bf16 or two in float32, widened to
// float32 and written back with one rounding: the vectors of the channels-last kernels
// (group_norm.cu, residual.cu). The address is 16-byte aligned.
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Exact GELU (erff), the Mixer's activation and one of the CLIP MLP sublayer's.
__device__ __forceinline__ float gelu_f(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// d/dv gelu(v) = Phi(v) + v phi(v)
__device__ __forceinline__ float gelu_grad_f(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * expf(-0.5f * v * v) * 0.3989422804014327f;
}

// The activations of the CLIP MLP sublayer (csrc/mlp_ln.cu): exact GELU, or CLIP's
// quick_gelu(v) = v * sigmoid(1.702 v).
enum Activation : int { kActGelu = 0, kActQuickGelu = 1 };

}  // namespace ffvc

// Every C entry point returns this: the launch's cudaGetLastError() as an int, so a
// refused launch (bad grid, too much shared memory) reaches the Python wrapper.
#define FFVC_RETURN_LAST_ERROR() return static_cast<int>(cudaGetLastError())

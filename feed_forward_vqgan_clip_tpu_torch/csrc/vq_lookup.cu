// Nearest-codebook search: idx[n] = first-match argmin_k (|c_k|^2 - 2 x_n . c_k).
//
// Replaces feed_forward_vqgan_clip_tpu/ops/pallas/vq_lookup.py `_vq_kernel`
// (`nearest_codebook_indices_pallas`). x (N, C) float32, codebook (K, C) float32,
// |c|^2 (K,) float32 computed by the wrapper; out int32 (N,).
//
// What bounds it on an H100: the scores are an (N, K, C) product, 2*N*K*C flops
// (34 GFLOP at N=4096, K=16384, C=256) in float32 FMA, with N*C + K*C*ceil(N/64)
// floats read from L2 and no (N, K) matrix anywhere in device memory. The design:
//   * a block owns 64 tokens and one contiguous range of the codebook (a "split"),
//     streams 64-code x 32-channel tiles of it through shared memory and keeps a
//     running (min, argmin) per token in registers;
//   * splits exist only to fill 132 SMs at small N (batch 1 is 256 tokens: 4 token
//     tiles); a second tiny kernel folds the per-split pairs in split order;
//   * ties keep the LOWEST index everywhere: every comparison, within a thread,
//     across the 16 threads that share a token and across splits, is the
//     lexicographic (score, index) minimum, which is exactly the first-match argmin
//     of the TPU kernel (strict `<` across its sequential codebook tiles).
// Ragged N, K and C are masked at the tile edges.

#include <climits>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kTN = 64;   // tokens per block
constexpr int kTK = 64;   // codes per shared-memory tile
constexpr int kTC = 32;   // channels per shared-memory tile
constexpr int kThreads = 256;

__device__ __forceinline__ bool better(float v, int i, float best_v, int best_i) {
  return v < best_v || (v == best_v && i < best_i);
}

__global__ void __launch_bounds__(kThreads)
vq_partial_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                  const float* __restrict__ c2, float* __restrict__ part_min,
                  int* __restrict__ part_arg, int n, int k, int c, int codes_per_split) {
  // transposed tiles: xs[channel][token], cs[channel][code]; rows stay 16-byte aligned
  __shared__ __align__(16) float xs[kTC][kTN + 4];
  __shared__ __align__(16) float cs[kTC][kTK + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // 4 codes:  tx*4 .. tx*4+3 of the tile
  const int ty = tid / 16;  // 4 tokens: ty*4 .. ty*4+3 of the tile
  const int n0 = blockIdx.x * kTN;
  const int split = blockIdx.y;
  const int k_begin = split * codes_per_split;
  const int k_end = min(k, k_begin + codes_per_split);

  float best_v[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best_v[i] = CUDART_INF_F;
    best_i[i] = INT_MAX;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
    float acc[4][4] = {};
    for (int c0 = 0; c0 < c; c0 += kTC) {
      for (int e = tid; e < kTN * kTC; e += kThreads) {
        const int t = e / kTC, cc = e % kTC, gn = n0 + t, gc = c0 + cc;
        xs[cc][t] = (gn < n && gc < c) ? x[(long long)gn * c + gc] : 0.f;
      }
      for (int e = tid; e < kTK * kTC; e += kThreads) {
        const int t = e / kTC, cc = e % kTC, gk = k0 + t, gc = c0 + cc;
        cs[cc][t] = (gk < k_end && gc < c) ? cb[(long long)gk * c + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < kTC; ++cc) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[cc][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&cs[cc][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k0 + tx * 4 + j;
      if (kk < k_end) {
        const float ck = c2[kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = ck - 2.f * acc[i][j];
          if (better(s, kk, best_v[i], best_i[i])) {
            best_v[i] = s;
            best_i[i] = kk;
          }
        }
      }
    }
  }

  // the 16 threads sharing a token row differ only in the low 4 lane bits
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = best_v[i];
    int bi = best_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, v, bi)) {
        v = ov;
        bi = oi;
      }
    }
    const int gn = n0 + ty * 4 + i;
    if (tx == 0 && gn < n) {
      part_min[(long long)split * n + gn] = v;
      part_arg[(long long)split * n + gn] = bi;
    }
  }
}

__global__ void vq_combine_kernel(const float* __restrict__ part_min,
                                  const int* __restrict__ part_arg, int* __restrict__ out,
                                  int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float bv = part_min[i];
  int bi = part_arg[i];
  for (int s = 1; s < splits; ++s) {
    const float v = part_min[(long long)s * n + i];
    const int a = part_arg[(long long)s * n + i];
    if (better(v, a, bv, bi)) {
      bv = v;
      bi = a;
    }
  }
  // all-NaN scores never compare: index 0, as argmin's first-NaN rule gives
  out[i] = bi == INT_MAX ? 0 : bi;
}

}  // namespace

extern "C" int ffvc_vq_argmin(const float* x, const float* codebook, const float* c2,
                              float* part_min, int* part_arg, int* out, int n, int k, int c,
                              int splits, int codes_per_split, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kTN - 1) / kTN, splits);
  vq_partial_kernel<<<grid, kThreads, 0, s>>>(x, codebook, c2, part_min, part_arg, n, k, c,
                                              codes_per_split);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  vq_combine_kernel<<<(n + 255) / 256, 256, 0, s>>>(part_min, part_arg, out, n, splits);
  FFVC_RETURN_LAST_ERROR();
}

extern "C" const char* ffvc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Row and reduction kernels of the MLP-Mixer block's train backward. Together with
// the GEMM and LayerNorm kernels of csrc/mixer_block.cu, ops/kernels/mixer_block.py
// chains them into
//
//   mixer_channel_bwd  replaces ops/pallas/mixer_block.py `_channel_bwd_kernel`
//                      (and its skewed schedule `_channel_bwd_pipe_kernel`)
//   mixer_token_bwd    replaces `_token_bwd_kernel`
//
// The TPU kernels run a sequential grid over the batch and carry each parameter
// gradient in a VMEM accumulator from one element to the next (`_accum`). Blocks of
// a Hopper grid run in no order, so here every sum over the batch is either the K
// dimension of a GEMM (the channel weight grads fold B*T into K), a GEMM over the
// batch whose partial products are added in batch order (the token weight grads: on
// wgmma_gemm.cuh each element's product as an f32 partial, then the batch sum below;
// on the WMMA tile `batch_sum` in mixer_block.cu), or the two-pass column sum below:
// each block sums a fixed range of rows, a second pass adds the ranges in order. No
// float atomics, so two runs of the same step give bitwise-equal gradients.
//
// What bounds the backward on an H100 is its GEMMs (mixer_block.cu; all eight on
// wgmma_gemm.cuh wherever TMA can read them, the channel weight grads with an M-major
// A and K = B*T summed in one wgmma chain, the token weight grads as 8 batched
// partials of one wave of 128 tiles, 8 MB of f32 each, added in order): at the
// flagship (B=8, T=256, D=1024, Et=1024, Ec=4096) the channel half is four
// products of 2*2048*4096*1024 = 69 GFLOP (0.069 ms at 989 TFLOP/s bf16), the
// token half four of 2*8*1024*256*1024 = 17 GFLOP (0.017 ms), against about 105
// and 58 MB of inputs and outputs (0.031, 0.017 ms at 3.35 TB/s). The kernels here
// only stream (B*T, D) or (B*T, Ec) f32 rows once or twice; the largest, the
// column sum of the f32 da3 (33.5 MB), needs about 10 us at 3.35 TB/s. The f32
// copies they read come from the GEMM epilogues, so the reductions add passes over
// f32 rows but no extra GEMM.

#include <algorithm>
#include <cstdint>

#include "common.cuh"

using namespace ffvc;

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr int kRowsPerBlock = 8;  // one warp per row

// out = round(x * scale[col] + bias[col]) in the working type: `rn` of the channel
// backward rebuilt from the saved, already rounded rhat (`_channel_bwd_kernel`).
template <typename T>
__global__ void __launch_bounds__(256) affine_rows_kernel(const T* __restrict__ x,
                                                          const float* __restrict__ scale,
                                                          const float* __restrict__ bias,
                                                          T* __restrict__ out, long long total,
                                                          int d) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total; i += gridDim.x * 256LL) {
    const int c = static_cast<int>(i % d);
    out[i] = from_f<T>(__fadd_rn(__fmul_rn(to_f(x[i]), scale[c]), bias[c]));
  }
}

// LayerNorm backward of one row (`_ln_bwd`), all f32:
//   g = dy * scale;  out = res + inv * (g - mean(g) - xhat * mean(g * xhat))
// and prod = dy * xhat (the row's terms of the LN scale grad). xhat and inv come
// from the forward (saved rhat in the working type and inv, the channel half), or,
// where inv_saved is null, are recomputed from x as `_ln_stats` does: (x - mean)*inv
// (the token half).
template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
ln_bwd_rows_kernel(const float* __restrict__ dy, const T* __restrict__ xsrc,
                   const float* __restrict__ inv_saved, const float* __restrict__ scale,
                   const float* __restrict__ res, float* __restrict__ out,
                   float* __restrict__ prod, int rows, int d) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warp leaves together
  const long long o = (long long)row * d;
  float mean = 0.f, inv;
  if (inv_saved) {
    inv = inv_saved[row];
  } else {
    float s = 0.f, ss = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float v = to_f(xsrc[o + i]);
      s += v;
      ss = fmaf(v, v, ss);
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    mean = s / d;
    inv = rsqrtf(fmaxf(ss / d - mean * mean, 0.f) + 1e-5f);
  }
  auto xhat = [&](int i) {
    return inv_saved ? to_f(xsrc[o + i]) : (to_f(xsrc[o + i]) - mean) * inv;
  };
  float s1 = 0.f, s2 = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float g = dy[o + i] * scale[i];
    s1 += g;
    s2 += g * xhat(i);
  }
  const float m1 = warp_sum(s1) / d;
  const float m2 = warp_sum(s2) / d;
  for (int i = lane; i < d; i += 32) {
    const float xh = xhat(i);
    const float g = dy[o + i] * scale[i];
    out[o + i] = res[o + i] + inv * ((g - m1) - xh * m2);
    prod[o + i] = dy[o + i] * xh;
  }
}

// out[row] = sum over the row's d values, one warp per row, in a fixed order.
__global__ void __launch_bounds__(32 * kRowsPerBlock)
row_sum_kernel(const float* __restrict__ a, float* __restrict__ out, int rows, int d) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* ar = a + (long long)row * d;
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += ar[i];
  s = warp_sum(s);
  if (lane == 0) out[row] = s;
}

// Column sums of a (rows, cols) f32 matrix in two passes: block (x, y) sums rows
// [y*rows_per_chunk, ...) of 256 columns into partial[y], one thread per column,
// rows in order; then each column's chunks are added in order.
__global__ void __launch_bounds__(256)
col_sum_chunks_kernel(const float* __restrict__ a, float* __restrict__ partial, int rows,
                      int cols, int rows_per_chunk) {
  const int col = blockIdx.x * 256 + threadIdx.x;
  if (col >= cols) return;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += a[(long long)r * cols + col];
  partial[(long long)blockIdx.y * cols + col] = s;
}

__global__ void __launch_bounds__(256)
col_sum_finish_kernel(const float* __restrict__ partial, float* __restrict__ out, int cols,
                      int chunks) {
  const int col = blockIdx.x * 256 + threadIdx.x;
  if (col >= cols) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(long long)c * cols + col];
  out[col] = s;
}

// out[i] = partial[0][i] + partial[1][i] + ... + partial[batch - 1][i], in that
// order, one thread per output (4 adjacent ones, 16-byte loads): the token weight
// grads dt2 and dt1 from their batch elements' f32 products. n % 4 == 0.
__global__ void __launch_bounds__(256)
batch_sum_kernel(const float4* __restrict__ partial, float4* __restrict__ out, int batch,
                 long long n4) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4; i += gridDim.x * 256LL) {
    float4 s = partial[i];
    for (int b = 1; b < batch; ++b) {
      const float4 v = partial[b * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

}  // namespace

// out (n,) = the sum over b < batch of partial (batch, n), in batch order. n a
// multiple of 4 and both bases 16-byte aligned (the wrapper's wgmma route has both).
extern "C" int ffvc_batch_sum(const float* partial, float* out, int batch, long long n,
                              void* stream) {
  if (n % 4 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = n / 4;
  const int blocks = static_cast<int>(std::min<long long>((n4 + 255) / 256, 4096));
  batch_sum_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(out), batch, n4);
  FFVC_RETURN_LAST_ERROR();
}

extern "C" int ffvc_affine_rows(const void* x, const float* scale, const float* bias,
                                void* out, long long total, int d, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = static_cast<int>(std::min<long long>((total + 255) / 256, 8192));
  if (dtype == kBF16)
    affine_rows_kernel<bf16><<<blocks, 256, 0, s>>>(static_cast<const bf16*>(x), scale, bias,
                                                    static_cast<bf16*>(out), total, d);
  else
    affine_rows_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(x), scale,
                                                     bias, static_cast<float*>(out), total, d);
  FFVC_RETURN_LAST_ERROR();
}

extern "C" int ffvc_ln_bwd_rows(const float* dy, const void* xsrc, const float* inv_saved,
                                const float* scale, const float* res, float* out, float* prod,
                                int rows, int d, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (dtype == kBF16)
    ln_bwd_rows_kernel<bf16><<<blocks, 32 * kRowsPerBlock, 0, s>>>(
        dy, static_cast<const bf16*>(xsrc), inv_saved, scale, res, out, prod, rows, d);
  else
    ln_bwd_rows_kernel<float><<<blocks, 32 * kRowsPerBlock, 0, s>>>(
        dy, static_cast<const float*>(xsrc), inv_saved, scale, res, out, prod, rows, d);
  FFVC_RETURN_LAST_ERROR();
}

extern "C" int ffvc_row_sum(const float* a, float* out, int rows, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_sum_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, s>>>(
      a, out, rows, d);
  FFVC_RETURN_LAST_ERROR();
}

// partial: chunks * cols floats of scratch, chunks = ceil(rows / rows_per_chunk).
extern "C" int ffvc_col_sum(const float* a, float* out, float* partial, int rows, int cols,
                            int rows_per_chunk, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  const int col_blocks = (cols + 255) / 256;
  col_sum_chunks_kernel<<<dim3(col_blocks, chunks), 256, 0, s>>>(a, partial, rows, cols,
                                                                  rows_per_chunk);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  col_sum_finish_kernel<<<col_blocks, 256, 0, s>>>(partial, out, cols, chunks);
  FFVC_RETURN_LAST_ERROR();
}

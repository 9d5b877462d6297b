// The VQGAN decoder's GroupNorm, with the SiLU that follows it where asked: two passes over
// channels-last or NCHW activations, bf16 or float32 in and out, float32 statistics.
//
// Replaces no TPU kernel: the JAX decoder's GroupNorm is plain XLA, which fuses it. In
// eager PyTorch the same arithmetic (ops/kernels/group_norm.py `group_norm_silu_plain`)
// takes 18 launches a norm (a float32 copy and its mean, a square and its mean, about ten
// launches on the (B, G) statistics, the scale and the shift as two passes, the SiLU as a
// third) and moves ~34 bytes a bf16 element. At the batch-256 decode, 39 norms over
// 83.36 M elements an image, that was 368.7 ms of a 697-ms batch on an H100 (53%).
//
// What bounds it on an H100: bytes. Each element is read twice (once for the statistics,
// once to apply them) and written once: 6 bytes a bf16 element, 12 in float32. The batch-256
// decode's 21.34 G elements take 128 GB, 38.2 ms at 3.35 TB/s. The arithmetic (~12
// instructions and two MUFU operations an element with the SiLU) stays under the SM's
// issue rate at that byte rate. A group smaller than L2 (every group at batch 1) is read
// the second time from L2.
//
// G groups of Cg = C / G channels; gamma, beta (C,) float32. Two layouts, each read as it
// lies:
//   * channels-last (B, H, W, C), C a power of two from 8 to 2048 (the decoder's layout:
//     cuDNN keeps the layout of the NHWC latent it is handed): a span is one image's
//     H W C elements, and a CTA holds a slice of whole pixels with every group in it; each
//     thread reads the same 8 channels (one 16-byte vector) at every step.
//   * NCHW, contiguous (any other tensor; the decoder hands on none): a group of one image
//     is the contiguous span of L = Cg H W elements, and B G such spans lie back to back;
//     a CTA holds one slice of one span and reads it one element at a time.
// The plan (ops/kernels/group_norm.py `gn_plan`) cuts each span into `splits` slices of
// `slice` elements (the last shorter), from the span's length alone, so an image's
// statistics do not depend on the batch it is in; CTA i holds span i / splits and slice
// i % splits, in both passes.
//   * Statistics: a CTA streams its slice, sums x and x^2 in float32 per thread (per
//     channel, channels-last), reduces them across the block in a fixed order (channels-
//     last: each channel over its threads in order, then each group over its channels in
//     order; NCHW: shuffles, then the warps in order), and writes one (sum, sumsq) pair a
//     group to the float32 workspace `partial`. No atomics: the result repeats bit for bit.
//   * Apply: every CTA of a span folds each group's pairs in split order, so all derive the
//     same statistics: mean = sum / L, var = max(sumsq / L - mean^2, 0) (the plain form's
//     formula and the JAX package's), inv = rsqrt(var + eps). Per channel it forms the
//     plain fold's scale a = rnd(inv gamma) and shift = rnd(beta - mean inv gamma), rnd
//     rounding to the tensor's dtype as the plain form rounds them, in shared memory;
//     then y = x a + shift in float32, y sigmoid(y) where `silu`, one rounding to the
//     dtype.
//   * Pre-bias (optional): a per-channel float32 vector that both passes add to x in
//     float32 before anything else, so x + pre_bias is never rounded to the dtype. It is
//     the bias of the convolution that wrote x, which the decoder hands on here in place of
//     cuDNN's separate bias pass (a broadcast add that moved 4 bytes a bf16 element). A
//     thread's channels-last channels are fixed, so its 8 values sit in registers: one
//     float32 add an element, no extra bytes. Without it the kernels are as before.

#include <math.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace ffvc {
namespace gn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;            // elements of one vector
constexpr int kMaxChannels = 2048; // channels whose fold sits in shared memory
constexpr int kMinBlocks = 4;      // CTAs an SM holds at once: 64 registers a thread

// y sigmoid(y) as y / (1 + e^-y); e^-y = inf for y below about -88 gives -0.
__device__ __forceinline__ float silu_f(float y) { return __fdividef(y, 1.f + __expf(-y)); }

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// A group's statistics from its `splits` (sum, sumsq) pairs, `stride` floats apart, folded
// in split order: inv = rsqrt(var + eps) and mean inv.
__device__ __forceinline__ void fold(const float* p, long long stride, int splits, float n,
                                     float eps, float& inv, float& mean_inv) {
  float sum = 0.f, sq = 0.f;
  for (int k = 0; k < splits; ++k) sum += p[k * stride], sq += p[k * stride + 1];
  const float mean = sum / n;
  const float var = fmaxf(__fsub_rn(sq / n, __fmul_rn(mean, mean)), 0.f);
  inv = rsqrtf(__fadd_rn(var, eps));
  mean_inv = __fmul_rn(mean, inv);
}

// The plain fold's per-channel scale and shift, rounded to T.
template <typename T>
__device__ __forceinline__ void scale_shift(float inv, float mean_inv, float gm, float bt,
                                            float& scale, float& shift) {
  scale = round_to<T>(__fmul_rn(inv, gm));
  shift = round_to<T>(__fsub_rn(bt, __fmul_rn(mean_inv, gm)));
}

// Channels-last x (B, H, W, C): a span is one image, hw pixels x c channels (len = hw c, the
// slice a multiple of c: whole pixels), and a CTA takes every group of its pixels. c is a
// power of two from 8 to kMaxChannels, so kThreads is a multiple of the c / 8 vectors of a
// pixel and each thread reads the same 8 channels at every step: their pre-bias sits in
// registers. kBias: the value normalized is x + pre_bias[channel], summed in float32.
template <typename T, bool kBias>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gn_stats_nhwc_kernel(const T* __restrict__ x, const float* __restrict__ pre_bias,
                         float* __restrict__ partial, int c, int groups, int len, int slice,
                         int splits) {
  const long long span = blockIdx.x / splits;
  const int begin = (blockIdx.x % splits) * slice;
  const int end = static_cast<int>(min(static_cast<long long>(len), 1ll * begin + slice));
  const T* g = x + span * len;
  const int cvecs = c / kVec;
  float pb[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) pb[k] = kBias ? pre_bias[(threadIdx.x % cvecs) * kVec + k] : 0.f;
  float sum[kVec] = {}, sq[kVec] = {};
  const int ve = end / kVec;
  int v = begin / kVec + threadIdx.x;
  for (; v + kThreads < ve; v += 2 * kThreads) {
    float e[2][kVec];
    load_vec(g + v * kVec, e[0]);
    load_vec(g + (v + kThreads) * kVec, e[1]);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float f = kBias ? e[u][k] + pb[k] : e[u][k];
        sum[k] += f;
        sq[k] = fmaf(f, f, sq[k]);
      }
  }
  if (v < ve) {
    float e[kVec];
    load_vec(g + v * kVec, e);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float f = kBias ? e[k] + pb[k] : e[k];
      sum[k] += f;
      sq[k] = fmaf(f, f, sq[k]);
    }
  }
  // per channel over the threads that read it, in thread order; then per group over its
  // channels in order
  __shared__ float red[2 * kVec][kThreads];
  __shared__ float ch_sum[kMaxChannels], ch_sq[kMaxChannels];
#pragma unroll
  for (int k = 0; k < kVec; ++k) red[k][threadIdx.x] = sum[k], red[kVec + k][threadIdx.x] = sq[k];
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    const int k = ch % kVec;
    float s = 0.f, q = 0.f;
    for (int t = ch / kVec; t < kThreads; t += cvecs) s += red[k][t], q += red[kVec + k][t];
    ch_sum[ch] = s, ch_sq[ch] = q;
  }
  __syncthreads();
  const int cg = c / groups;
  float* out = partial + 2ll * blockIdx.x * groups;
  for (int gi = threadIdx.x; gi < groups; gi += kThreads) {
    float s = 0.f, q = 0.f;
    for (int ch = gi * cg; ch < (gi + 1) * cg; ++ch) s += ch_sum[ch], q += ch_sq[ch];
    out[2 * gi] = s;
    out[2 * gi + 1] = q;
  }
}

template <typename T, bool kSilu, bool kBias>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gn_apply_nhwc_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, const float* __restrict__ pre_bias,
                         const float* __restrict__ partial, T* __restrict__ out, int c,
                         int groups, int len, int slice, int splits, float eps) {
  const long long span = blockIdx.x / splits;
  const int begin = (blockIdx.x % splits) * slice;
  const int end = static_cast<int>(min(static_cast<long long>(len), 1ll * begin + slice));
  __shared__ float s_inv[kMaxChannels], s_mean_inv[kMaxChannels];
  __shared__ float s_scale[kMaxChannels], s_shift[kMaxChannels];
  const float n = static_cast<float>(len / groups);
  const float* p = partial + 2ll * span * splits * groups;
  for (int gi = threadIdx.x; gi < groups; gi += kThreads)
    fold(p + 2 * gi, 2ll * groups, splits, n, eps, s_inv[gi], s_mean_inv[gi]);
  __syncthreads();
  const int cg = c / groups;
  for (int ch = threadIdx.x; ch < c; ch += kThreads)
    scale_shift<T>(s_inv[ch / cg], s_mean_inv[ch / cg], gamma[ch], beta[ch], s_scale[ch],
                   s_shift[ch]);
  __syncthreads();
  const int c0 = (threadIdx.x % (c / kVec)) * kVec;
  float a[kVec], b[kVec], pb[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    a[k] = s_scale[c0 + k], b[k] = s_shift[c0 + k];
    pb[k] = kBias ? pre_bias[c0 + k] : 0.f;
  }
  const T* xg = x + span * len;
  T* og = out + span * len;
  const int ve = end / kVec;
  int v = begin / kVec + threadIdx.x;
  for (; v + kThreads < ve; v += 2 * kThreads) {
    float e[2][kVec];
    load_vec(xg + v * kVec, e[0]);
    load_vec(xg + (v + kThreads) * kVec, e[1]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float y = fmaf(kBias ? e[u][k] + pb[k] : e[u][k], a[k], b[k]);
        e[u][k] = kSilu ? silu_f(y) : y;
      }
      store_vec(og + (v + u * kThreads) * kVec, e[u]);
    }
  }
  if (v < ve) {
    float e[kVec];
    load_vec(xg + v * kVec, e);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float y = fmaf(kBias ? e[k] + pb[k] : e[k], a[k], b[k]);
      e[k] = kSilu ? silu_f(y) : y;
    }
    store_vec(og + v * kVec, e);
  }
}

// NCHW x: a span is one group of one image, len = cg hw contiguous elements; element i of
// span s lies in channel (s % groups) cg + i / hw.
template <typename T, bool kBias>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gn_stats_kernel(const T* __restrict__ x, const float* __restrict__ pre_bias,
                    float* __restrict__ partial, int groups, int cg, int hw, int slice,
                    int splits) {
  const long long span = blockIdx.x / splits;
  const int len = cg * hw;
  const int begin = (blockIdx.x % splits) * slice;
  const int end = static_cast<int>(min(static_cast<long long>(len), 1ll * begin + slice));
  const T* g = x + span * len;
  const float* pbg = kBias ? pre_bias + static_cast<int>(span % groups) * cg : nullptr;
  float sum = 0.f, sq = 0.f;
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    const float f = kBias ? to_f<T>(g[i]) + pbg[i / hw] : to_f<T>(g[i]);
    sum += f;
    sq = fmaf(f, f, sq);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  __shared__ float warp_sum[kWarps], warp_sq[kWarps];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) warp_sum[warp] = sum, warp_sq[warp] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f, q = 0.f;
    for (int w = 0; w < kWarps; ++w) s += warp_sum[w], q += warp_sq[w];
    partial[2ll * blockIdx.x] = s;
    partial[2ll * blockIdx.x + 1] = q;
  }
}

template <typename T, bool kSilu, bool kBias>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const float* __restrict__ pre_bias,
                    const float* __restrict__ partial, T* __restrict__ out, int groups, int cg,
                    int hw, int slice, int splits, float eps) {
  const long long span = blockIdx.x / splits;
  const int len = cg * hw;
  const int begin = (blockIdx.x % splits) * slice;
  const int end = static_cast<int>(min(static_cast<long long>(len), 1ll * begin + slice));
  __shared__ float s_scale[kMaxChannels], s_shift[kMaxChannels], s_pb[kMaxChannels];
  float inv, mean_inv;
  fold(partial + 2ll * span * splits, 2, splits, static_cast<float>(len), eps, inv, mean_inv);
  const int c0 = static_cast<int>(span % groups) * cg;
  for (int c = threadIdx.x; c < cg; c += kThreads) {
    scale_shift<T>(inv, mean_inv, gamma[c0 + c], beta[c0 + c], s_scale[c], s_shift[c]);
    if (kBias) s_pb[c] = pre_bias[c0 + c];
  }
  __syncthreads();
  const T* xg = x + span * len;
  T* og = out + span * len;
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    const int c = i / hw;
    const float xv = kBias ? to_f<T>(xg[i]) + s_pb[c] : to_f<T>(xg[i]);
    const float y = fmaf(xv, s_scale[c], s_shift[c]);
    og[i] = from_f<T>(kSilu ? silu_f(y) : y);
  }
}

// The entry point's `path`: how x lies.
enum Path : int { kNchw = 0, kNhwc = 1 };

template <typename T, bool kSilu, bool kBias>
void launch_apply(const T* x, const float* gamma, const float* beta, const float* pre_bias,
                  T* out, const float* partial, unsigned grid, int groups, int cg, int hw,
                  int slice, int splits, float eps, int path, cudaStream_t stream) {
  if (path == kNhwc)
    gn_apply_nhwc_kernel<T, kSilu, kBias><<<grid, kThreads, 0, stream>>>(
        x, gamma, beta, pre_bias, partial, out, cg * groups, groups, cg * hw * groups, slice,
        splits, eps);
  else
    gn_apply_kernel<T, kSilu, kBias><<<grid, kThreads, 0, stream>>>(
        x, gamma, beta, pre_bias, partial, out, groups, cg, hw, slice, splits, eps);
}

template <typename T, bool kBias>
void launch(const T* x, const float* gamma, const float* beta, const float* pre_bias, T* out,
            float* partial, int rows, int groups, int cg, int hw, int slice, int splits,
            float eps, bool silu, int path, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(rows) * static_cast<unsigned>(splits);
  if (path == kNhwc)
    gn_stats_nhwc_kernel<T, kBias><<<grid, kThreads, 0, stream>>>(
        x, pre_bias, partial, cg * groups, groups, cg * hw * groups, slice, splits);
  else
    gn_stats_kernel<T, kBias><<<grid, kThreads, 0, stream>>>(x, pre_bias, partial, groups, cg,
                                                             hw, slice, splits);
  if (silu)
    launch_apply<T, true, kBias>(x, gamma, beta, pre_bias, out, partial, grid, groups, cg, hw,
                                 slice, splits, eps, path, stream);
  else
    launch_apply<T, false, kBias>(x, gamma, beta, pre_bias, out, partial, grid, groups, cg, hw,
                                  slice, splits, eps, path, stream);
}

template <typename T>
void launch(const void* x, const float* gamma, const float* beta, const float* pre_bias,
            void* out, float* partial, int rows, int groups, int cg, int hw, int slice,
            int splits, float eps, bool silu, int path, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (pre_bias)
    launch<T, true>(xt, gamma, beta, pre_bias, ot, partial, rows, groups, cg, hw, slice, splits,
                    eps, silu, path, stream);
  else
    launch<T, false>(xt, gamma, beta, pre_bias, ot, partial, rows, groups, cg, hw, slice,
                     splits, eps, silu, path, stream);
}

}  // namespace gn
}  // namespace ffvc

using namespace ffvc;

// x of B images, each `groups` groups of cg channels over hw pixels, f32 or bf16 (`dtype`)
// -> out, the same layout; gamma, beta (groups cg,) float32; pre_bias (groups cg,) float32,
// added to x in float32 before the statistics and the normalization, or null for none.
// `path` kNhwc: x (B, H, W, C) contiguous, rows = B spans of hw C elements, C a power of two
// from 8 to kMaxChannels, the slice a multiple of C, x and out 16-byte aligned; kNchw: x
// (B, C, H, W) contiguous, rows = B groups spans of cg hw elements. A span is cut into
// `splits` slices of `slice` (slice (splits - 1) < span <= slice splits); partial holds rows
// splits groups-or-1 (sum, sumsq) float32 pairs. Two launches on `stream`.
extern "C" int ffvc_group_norm(const void* x, const float* gamma, const float* beta,
                               const float* pre_bias, void* out, float* partial, int rows,
                               int groups, int cg, int hw, int slice, int splits, float eps,
                               int silu, int path, int dtype, void* stream) {
  const long long c = static_cast<long long>(cg) * groups;
  const long long len = static_cast<long long>(cg) * hw * (path == gn::kNhwc ? groups : 1);
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  bool ok = rows >= 1 && groups >= 1 && cg >= 1 && cg <= gn::kMaxChannels && hw >= 1 &&
            len <= INT_MAX && splits >= 1 && slice >= 1 &&
            static_cast<long long>(slice) * (splits - 1) < len &&
            static_cast<long long>(slice) * splits >= len &&
            static_cast<long long>(rows) * splits <= INT_MAX && (dtype == kBF16 || dtype == kF32);
  if (path == gn::kNhwc)
    ok = ok && c >= gn::kVec && c <= gn::kMaxChannels && (c & (c - 1)) == 0 && slice % c == 0 &&
         aligned;
  else
    ok = ok && path == gn::kNchw && rows % groups == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    gn::launch<bf16>(x, gamma, beta, pre_bias, out, partial, rows, groups, cg, hw, slice, splits,
                     eps, silu, path, st);
  else
    gn::launch<float>(x, gamma, beta, pre_bias, out, partial, rows, groups, cg, hw, slice,
                      splits, eps, silu, path, st);
  FFVC_RETURN_LAST_ERROR();
}

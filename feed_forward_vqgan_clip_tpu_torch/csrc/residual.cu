// The VQGAN decoder's residual add with the pending conv biases: out = skip + h + vec[c],
// summed in float32 in that order and rounded once to the dtype (bf16 or float32).
//
// Replaces no TPU kernel: the JAX decoder adds in plain XLA, which fuses the convs' bias
// adds into their epilogues. On cuDNN, PyTorch runs a conv without its bias and then adds
// the bias in a pass of its own, a broadcast add that TensorIterator cannot vectorize
// (`elementwise_kernel<128, 4>`), reading and writing the whole output: ~70 ms of a
// batch-256 decode on an H100. The decoder runs its ResnetBlocks' convs without their
// biases (models/vqgan.py) and hands them here, where the residual add reads both tensors
// anyway: vec is conv2's bias plus the skip path's, so the biases cost no bytes.
//
// What bounds it on an H100: bytes. Two tensors read and one written, 6 bytes a bf16
// element (12 in float32); vec (C,) float32 stays in L1/L2. The batch-256 decode's 17
// residuals, 36.04 M elements an image (9.23 G a batch), take 55.4 GB: 16.5 ms at 3.35
// TB/s, what the vectorized `x + h` it replaces moved without the biases.
//
// One launch, over the layout both operands share (`path`):
//   * 1, channels-last (B, H, W, C), C a multiple of 8: one 8-element vector a thread (one
//     16-byte load an operand in bf16, two in float32), 8 consecutive channels of one pixel,
//     from channel (i mod C);
//   * 0, NCHW, contiguous, H W a multiple of 8: the same vectors, each in one channel,
//     (i / HW) mod C;
//   * 2, NCHW, contiguous, any H W and any element-aligned address: one element a thread,
//     for shapes and views the vectors cannot read (tiny decoders, offset views).
// The wrapper (ops/kernels/residual.py) makes the decoder's operands one of these.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace ffvc {
namespace residual {

constexpr int kThreads = 256;
constexpr int kVec = 8;

template <typename T, bool kNhwc>
__global__ void __launch_bounds__(kThreads)
    residual_kernel(const T* __restrict__ skip, const T* __restrict__ h,
                    const float* __restrict__ vec, T* __restrict__ out, long long vectors, int c,
                    int hw) {
  const long long v = 1ll * blockIdx.x * kThreads + threadIdx.x;
  if (v >= vectors) return;
  const long long i = v * kVec;
  float a[kVec], b[kVec], bias[kVec];
  load_vec(skip + i, a);
  load_vec(h + i, b);
  if (kNhwc) {
    load_vec(vec + i % c, bias);
  } else {
    const float bv = vec[(i / hw) % c];
#pragma unroll
    for (int k = 0; k < kVec; ++k) bias[k] = bv;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) a[k] = __fadd_rn(__fadd_rn(a[k], b[k]), bias[k]);
  store_vec(out + i, a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    residual_elements(const T* __restrict__ skip, const T* __restrict__ h,
                      const float* __restrict__ vec, T* __restrict__ out, long long n, int c,
                      int hw) {
  const long long i = 1ll * blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = from_f<T>(__fadd_rn(__fadd_rn(to_f(skip[i]), to_f(h[i])), vec[(i / hw) % c]));
}

template <typename T>
void launch(const void* skip, const void* h, const float* vec, void* out, long long n, int c,
            int hw, int path, cudaStream_t stream) {
  const long long threads = path == 2 ? n : n / kVec;
  const unsigned grid = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const T* st = static_cast<const T*>(skip);
  const T* ht = static_cast<const T*>(h);
  T* ot = static_cast<T*>(out);
  if (path == 2)
    residual_elements<T><<<grid, kThreads, 0, stream>>>(st, ht, vec, ot, n, c, hw);
  else if (path == 1)
    residual_kernel<T, true><<<grid, kThreads, 0, stream>>>(st, ht, vec, ot, threads, c, hw);
  else
    residual_kernel<T, false><<<grid, kThreads, 0, stream>>>(st, ht, vec, ot, threads, c, hw);
}

}  // namespace residual
}  // namespace ffvc

using namespace ffvc;

// skip, h (B, C, H, W), both channels-last (`path` 1, C a multiple of 8) or both contiguous
// NCHW (`path` 0, hw = H W a multiple of 8; `path` 2, any hw), f32 or bf16 (`dtype`), n
// elements; vec (C,) float32 -> out in their layout: out = skip + h + vec[c] in float32, one
// rounding. On paths 0 and 1 skip, h, out and vec are 16-byte aligned. One launch on
// `stream`.
extern "C" int ffvc_residual_add(const void* skip, const void* h, const float* vec, void* out,
                                 long long n, int c, int hw, int path, int dtype,
                                 void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(skip) | reinterpret_cast<uintptr_t>(h) |
                        reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(vec)) %
                           16 == 0;
  const long long threads = path == 2 ? n : n / residual::kVec;
  bool ok = n >= 1 && c >= 1 && hw >= 1 && n % (1ll * c * hw) == 0 &&
            (threads + residual::kThreads - 1) / residual::kThreads <= INT_MAX &&
            (dtype == kBF16 || dtype == kF32);
  if (path == 1)
    ok = ok && aligned && c % residual::kVec == 0;
  else if (path == 0)
    ok = ok && aligned && hw % residual::kVec == 0;
  else
    ok = ok && path == 2;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    residual::launch<bf16>(skip, h, vec, out, n, c, hw, path, st);
  else
    residual::launch<float>(skip, h, vec, out, n, c, hw, path, st);
  FFVC_RETURN_LAST_ERROR();
}

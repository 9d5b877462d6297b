// The whole MLP-Mixer block stack in one kernel launch (K4) on the tiles of
// mixer_tile.cuh: the float32 route and the bf16 shapes TMA cannot read (the others
// take csrc/mixer_stream_wgmma.cu, ops/kernels/mixer_stream.py `stream_route`). Over
// the stacked layout of ops/kernels/mixer_block.py `stack_mixer_params`: per block l, with the
// channel LayerNorm's affine folded into w1f and b1f,
//
//   (a) xn = LN1(x)                          rows,  one warp per row
//   (b) g1 = gelu(t1[l] . xn + t1b[l])       GEMM, batched over B        (Et, D)
//   (c) r  = x + (t2[l] . g1 + t2b[l])       GEMM, batched over B        (T, D)
//   (d) xn = LN-hat(r)                       rows, no affine, centered
//   (e) g3 = gelu(xn . w1f[l]^T + b1f[l])    GEMM, batch folded into M   (B*T, Ec)
//   (f) x' = r + (g3 . w2[l]^T + b2[l])      GEMM, batch folded into M   (B*T, D)
//
// Replaces feed_forward_vqgan_clip_tpu/ops/pallas/mixer_block.py `_stream_kernel`
// (fused_mixer_stream -> _fused_mixer_stream_impl): the same function. The TPU
// kernel walks a (B, L) grid in order, keeps one batch element's activation in
// VMEM across the depth and double-buffers each block's weights into VMEM one
// step ahead. Blocks of a CUDA grid run in parallel and an SM holds 227 KB, so
// here one persistent cooperative launch (every block of the grid resident, the
// grid sized by the occupancy calculator) walks l = 0..L-1 through the six phases
// above. Each phase is a grid-stride loop over its output tiles, run by the same
// device code as K2 (mixer_tile.cuh: LN rows, the WMMA GEMM tile with its bias /
// GELU / residual epilogue); a GEMM whose tiles alone would leave SMs idle splits
// K (the K2 plan) and sums its partials in order in a further phase. A grid-wide
// barrier separates the phases (6 to 10 per block). The activation ping-pongs
// between two (B, T, D) buffers, with r, xn and the g1 (B, Et, D) and g3 (B, T, Ec)
// workspaces beside them: about 4.5 MB per batch element in bf16, L2-resident at
// B <= 8. The weights stream from HBM block by block.
//
// What bounds it on an H100: the weights are read once per launch, 32 x 17.8 MB =
// 570 MB bf16 (0.170 ms at 3.35 TB/s), and the work is 2*T*D*(2*Et + 2*Ec) * L =
// 1.72e11 FLOP per batch element (0.174 ms at 989 TFLOP/s): at B=1 both bounds
// are level, above it the tensor cores bound it. What the launch removes against
// 32 x K2 is 32 x 5-7 launches and their gaps; what it adds is the barriers.
//
// No fallback: a grid that cannot be co-resident fails the cooperative launch
// (cudaErrorCooperativeLaunchTooLarge) and the wrapper raises. Every block of the
// grid reaches every barrier, in the same order; the sums are taken in a fixed
// order, so two launches on the same inputs give the same bits.

#include <type_traits>

#include "mixer_tile.cuh"

using namespace ffvc;

namespace {

constexpr int kThreads = 256;
constexpr int kGemms = 4;  // token GEMM1, token GEMM2, channel GEMM1, channel GEMM2

struct StreamArgs {
  const void* x;    // (B, T, D) input
  void* out;        // (B, T, D) output, also one of the two activation buffers
  void* buf;        // (B, T, D) the other activation buffer
  void* r;          // (B, T, D) the token half's output
  void* xn;         // (B, T, D) LN1(x), then LN-hat(r)
  void* g1;         // (B, Et, D)
  void* g3;         // (B, T, Ec)
  float* partial;   // split-K partial tiles, f32
  unsigned int* barrier;  // zeroed before the launch
  // the stacked weights: matrices in the working type, the rest f32
  const float* ln1_w;  // (L, D)
  const float* ln1_b;  // (L, D)
  const void* t1;      // (L, Et, T)
  const float* t1b;    // (L, Et)
  const void* t2;      // (L, T, Et)
  const float* t2b;    // (L, T)
  const void* w1f;     // (L, Ec, D)
  const float* b1f;    // (L, Ec)
  const void* w2;      // (L, D, Ec)
  const float* b2;     // (L, D)
  int batch, layers, t, d, et, ec;
  int splits[kGemms], k_per_split[kGemms];
};

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Grid-wide barrier on one monotonic counter: the k-th barrier of the launch
// waits until every block has arrived k times. Thread 0 of each block arrives
// after a device-scope fence (the block's writes, ordered by the __syncthreads
// before it, become visible first) and spins with acquire loads, so what the
// other blocks wrote before arriving is seen after the barrier.
__device__ __forceinline__ void grid_sync(unsigned int* counter, unsigned int& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (ld_acquire(counter) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void ln_phase(const T* x, const float* scale, const float* bias,
                                         T* out, int rows, int d, bool centered) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = blockIdx.x * kLnRowsPerBlock + warp; row < rows;
       row += gridDim.x * kLnRowsPerBlock) {
    const long long o = (long long)row * d;
    ln_row<T>(x + o, scale, bias, out + o, nullptr, nullptr, d, centered, lane);
  }
}

// One GEMM of the block: its output tiles over the grid, a barrier, and where K
// was split, the in-order sum of the partials and another barrier.
template <typename T, bool kBKMajor>
__device__ __forceinline__ void gemm_phase(const GemmArgs& p, int batch, unsigned char* smem,
                                           unsigned int* barrier, unsigned int& target) {
  constexpr int kTile = std::is_same<T, bf16>::value ? 128 : 64;
  const int tn = (p.n + kTile - 1) / kTile, tm = (p.m + kTile - 1) / kTile;
  const long long total = (long long)tn * tm * batch * p.splits;
  for (long long i = blockIdx.x; i < total; i += gridDim.x) {
    __syncthreads();  // the previous tile's epilogue scratch overlays stage 0
    gemm_tile<T, GemmArgs, false, kBKMajor>(p, static_cast<int>(i % tn),
                                            static_cast<int>(i / tn % tm),
                                            static_cast<int>(i / ((long long)tn * tm)), smem);
  }
  grid_sync(barrier, target);
  if (p.splits > 1) {
    splitk_reduce<T>(p, batch, blockIdx.x * (long long)kThreads + threadIdx.x,
                     (long long)gridDim.x * kThreads);
    grid_sync(barrier, target);
  }
}

template <typename T>
struct StreamSmem {
  static constexpr int a = GemmTile<T, false, false>::kSmemBytes;
  static constexpr int b = GemmTile<T, false, true>::kSmemBytes;
  static constexpr int kBytes = a > b ? a : b;
};

// Two blocks per SM, as the K2 GEMM (128 registers a thread).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) mixer_stream_kernel(StreamArgs s) {
  __shared__ __align__(128) unsigned char smem[StreamSmem<T>::kBytes];
  const int b = s.batch, t = s.t, d = s.d, et = s.et, ec = s.ec;
  const long long td = (long long)t * d, etd = (long long)et * d;
  T* r = static_cast<T*>(s.r);
  T* xn = static_cast<T*>(s.xn);
  T* g1 = static_cast<T*>(s.g1);
  T* g3 = static_cast<T*>(s.g3);
  unsigned int target = 0;
  const T* cur = static_cast<const T*>(s.x);
  for (int l = 0; l < s.layers; ++l) {
    // the last block writes `out`; earlier ones alternate so that none
    // overwrites the activation it reads
    T* next = static_cast<T*>((s.layers - 1 - l) % 2 == 0 ? s.out : s.buf);
    const T* t1 = static_cast<const T*>(s.t1) + (long long)l * et * t;
    const T* t2 = static_cast<const T*>(s.t2) + (long long)l * t * et;
    const T* w1f = static_cast<const T*>(s.w1f) + (long long)l * ec * d;
    const T* w2 = static_cast<const T*>(s.w2) + (long long)l * d * ec;
    GemmArgs p{};

    // (a) xn = LN1(x)
    ln_phase<T>(cur, s.ln1_w + (long long)l * d, s.ln1_b + (long long)l * d, xn, b * t, d,
                false);
    grid_sync(s.barrier, target);
    // (b) g1[b] = gelu(t1 . xn[b] + t1b): weights shared over the batch (stride 0)
    fill_common(p, t1, t, 0, xn, d, td, g1, d, etd, nullptr, 0, 0, s.t1b + (long long)l * et,
                1, 1, et, d, t, s.splits[0], s.k_per_split[0], s.partial);
    gemm_phase<T, false>(p, b, smem, s.barrier, target);
    // (c) r[b] = x[b] + (t2 . g1[b] + t2b)
    fill_common(p, t2, et, 0, g1, d, etd, r, d, td, cur, d, td, s.t2b + (long long)l * t, 1, 0,
                t, d, et, s.splits[1], s.k_per_split[1], s.partial);
    gemm_phase<T, false>(p, b, smem, s.barrier, target);
    // (d) xn = LN-hat(r)
    ln_phase<T>(r, nullptr, nullptr, xn, b * t, d, true);
    grid_sync(s.barrier, target);
    // (e) g3 = gelu(xn . w1f^T + b1f), batch folded into M = B*T rows
    fill_common(p, xn, d, 0, w1f, d, 0, g3, ec, 0, nullptr, 0, 0, s.b1f + (long long)l * ec, 2,
                1, b * t, ec, d, s.splits[2], s.k_per_split[2], s.partial);
    gemm_phase<T, true>(p, 1, smem, s.barrier, target);
    // (f) x' = r + (g3 . w2^T + b2)
    fill_common(p, g3, ec, 0, w2, ec, 0, next, d, 0, r, d, 0, s.b2 + (long long)l * d, 2, 0,
                b * t, d, ec, s.splits[3], s.k_per_split[3], s.partial);
    gemm_phase<T, true>(p, 1, smem, s.barrier, target);
    cur = next;
  }
}

template <typename T>
int blocks_per_sm(int* out) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, mixer_stream_kernel<T>, kThreads, 0));
}

// The returned code is also cleared from the runtime's last error, so that it
// is reported once, by this call.
template <typename T>
int launch_stream(StreamArgs& s, int grid, cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(s.barrier, 0, sizeof(unsigned int), st);
  if (e == cudaSuccess) {
    void* args[] = {&s};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&mixer_stream_kernel<T>),
                                    dim3(grid), dim3(kThreads), args, 0, st);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

// How many blocks of the kernel one SM holds at once (the grid is this times
// the SM count, so that every block is resident).
extern "C" int ffvc_mixer_stream_blocks_per_sm(int dtype, int* out) {
  return dtype == kBF16 ? blocks_per_sm<bf16>(out) : blocks_per_sm<float>(out);
}

// The L blocks over x in one cooperative launch of `grid` blocks. splits and
// k_per_split: the split-K plan of the four GEMMs in the order (b), (c), (e), (f).
extern "C" int ffvc_mixer_stream(const void* x, void* out, void* buf, void* r, void* xn,
                                 void* g1, void* g3, float* partial, unsigned int* barrier,
                                 const float* ln1_w, const float* ln1_b, const void* t1,
                                 const float* t1b, const void* t2, const float* t2b,
                                 const void* w1f, const float* b1f, const void* w2,
                                 const float* b2, int batch, int layers, int t, int d, int et,
                                 int ec, int s0, int k0, int s1, int k1, int s2, int k2, int s3,
                                 int k3, int grid, int dtype, void* stream) {
  StreamArgs s{x,   out, buf, r,   xn,  g1,  g3, partial, barrier, ln1_w, ln1_b, t1, t1b,
               t2,  t2b, w1f, b1f, w2,  b2,  batch, layers, t, d, et, ec, {s0, s1, s2, s3},
               {k0, k1, k2, k3}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == kBF16 ? launch_stream<bf16>(s, grid, st) : launch_stream<float>(s, grid, st);
}

// Kernels of one MLP-Mixer block: a LayerNorm over rows and one tiled GEMM with a
// fused epilogue. ops/kernels/mixer_block.py chains them into the inference block
//
//   xn = LN(x)                          ln_rows
//   g1 = gelu(t1 . xn + t1b[row])       gemm, batched over B      (Et, D)
//   r  = x + (t2 . g1 + t2b[row])       gemm, batched over B      (T, D)
//   rn = LN(r)                          ln_rows
//   g3 = gelu(rn . W1^T + b1[col])      gemm, batch folded in M   (B*T, Ec)
//   y  = r + (g3 . W2^T + b2[col])      gemm, batch folded in M   (B*T, D)
//
// and, through the train entry points (`ffvc_ln_rows_train`, `ffvc_gemm_train`),
// into the train block's forward (the same chain, also writing gelu' beside each
// GELU and the LN2 normalised rows and inverse std) and the GEMMs of its channel
// and token backward (csrc/mixer_train.cu holds that backward's row and reduction
// kernels). Over the stacked layout (K5, `mixer_block_stacked`) the same launches
// read one block's views of the (L, ...) weights, and rn is LN-hat(r), the LN2
// affine being folded into W1 and b1.
//
// Replaces feed_forward_vqgan_clip_tpu/ops/pallas/mixer_block.py `_block_kernel`
// (fused_mixer_block) and `_pipe_kernel` (its skewed schedule at B >= 16),
// `_block_kernel_stacked` (fused_mixer_block_stacked), and, as the train forward,
// `_block_res_kernel` and `_block_res_pipe_kernel` (the same block, also saving
// g1, gelu'(a1), rhat, inv2, g3, gelu'(a3)): the same functions. The device code
// (LN row, GEMM tile, epilogue, split-K sum) lives in mixer_tile.cuh, shared with
// the whole-depth kernel of csrc/mixer_stream.cu.
// The TPU kernel keeps one batch element's whole block in 128 MB of VMEM;
// an SM has 227 KB, so here each matmul is its own tiled kernel and the activations
// between them go through L2/HBM (one block's bf16 weights are 18 MB and stay in the
// 50 MB L2 across the batch).
//
// What bounds it on an H100: 2*T*D*(2*Et + 2*Ec) = 5.4 GFLOP per batch element per
// block at the flagship (T=256, D=1024, Et=1024, Ec=4096) against about 60 MB of
// bf16 activation traffic per element: compute-bound, so the bf16 GEMMs run on the
// tensor cores. Wherever TMA can read the operands (rows of multiples of 8 elements,
// 16-byte-aligned bases: every flagship shape) the wrapper sends them to the Hopper
// GEMM of wgmma_gemm.cuh (wgmma_gemm.cu's entry point: TMA ring, wgmma, persistent
// tiles, the same epilogues); the GEMM here is the WMMA tile (m16n16k16, f32
// accumulators) for the other bf16 shapes, and for the float32 route, used by the
// parity checks, a shared-memory FMA tile. At batch 1 the WMMA tile's output tiles
// of some GEMMs are fewer than the 132 SMs (16 for the second channel GEMM), so K
// is split across blocks there (split-K below). The train forward does the same
// 43 GFLOP at B=8 (0.044 ms at 989 TFLOP/s) and also writes about 70 MB of bf16
// residuals (0.021 ms at 3.35 TB/s): still compute-bound; it writes them from the
// GEMM epilogues, so no extra pass reads the activations. At B=256 (bulk generation)
// the exact-GELU epilogues, not the K sums, bounded the cooperative wgmma GEMMs: on an
// H100 SXM at 700 W, g1 ran at 22% of its byte bound and g3 at 36% of its FLOP bound,
// both warpgroups computing GELUs while the tensor cores idled. The GELU GEMMs g1 and
// g3, where their tiles are at least twice the SMs (from B=5), take the ping-pong walk
// of wgmma_gemm.cuh instead, where one warpgroup's epilogue runs under the other
// warpgroup's wgmma chain and the outputs are the same bits: at B=256 g1 then reads at
// 34% of its byte bound, g3 at 50% of its FLOP bound (1.25-1.54x the cooperative walk
// from B=4 to 256). g1 stays bound by L2 reads of xn (the batch-innermost walk reads
// each image's xn once per row block of t1), g3 by the single warpgroup's chain beside
// the other's epilogue. r (51% of its byte bound, HBM reads of g1) and out (56% of its
// FLOP bound) stay cooperative: ping-pong moved them 1-3%.

#include <algorithm>
#include <type_traits>

#include "mixer_tile.cuh"

using namespace ffvc;

namespace {

// LayerNorm rows, one warp per row (ln_row). kTrain adds the train options,
// compiled out of the inference kernel: `centered` picks the rounding order, and
// where given rhat and inv are written too. A null scale (with its bias) gives
// LN-hat, the channel LayerNorm of the stacked layout.
template <typename T, bool kTrain>
__global__ void __launch_bounds__(32 * kLnRowsPerBlock)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ out, T* __restrict__ rhat,
               float* __restrict__ inv_out, int rows, int d, int centered) {
  const int row = blockIdx.x * kLnRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warp leaves together
  const long long o = (long long)row * d;
  if constexpr (kTrain)
    ln_row<T>(x + o, scale, bias, out + o, rhat ? rhat + o : nullptr,
              inv_out ? inv_out + row : nullptr, d, centered != 0, lane);
  else
    ln_row<T>(x + o, scale, bias, out + o, nullptr, nullptr, d, false, lane);
}

// The train GEMMs' layouts: row-major A with a K- or N-major B, or an M-major A
// with an N-major B (no caller reads both operands transposed).
template <typename T>
int run_train_gemm(const GemmTrainArgs& p, int a_mmajor, int b_kmajor, int batch,
                   cudaStream_t s) {
  if (a_mmajor && b_kmajor) return static_cast<int>(cudaErrorInvalidValue);
  if (a_mmajor) return launch_gemm<T, GemmTrainArgs, true, false>(p, batch, s);
  if (b_kmajor) return launch_gemm<T, GemmTrainArgs, false, true>(p, batch, s);
  return launch_gemm<T, GemmTrainArgs, false, false>(p, batch, s);
}

template <typename T>
void launch_ln(const void* x, const float* scale, const float* bias, void* out, void* rhat,
               float* inv, int rows, int d, int centered, bool train, cudaStream_t s) {
  const int blocks = (rows + kLnRowsPerBlock - 1) / kLnRowsPerBlock;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (train)
    ln_rows_kernel<T, true><<<blocks, 32 * kLnRowsPerBlock, 0, s>>>(
        xt, scale, bias, ot, static_cast<T*>(rhat), inv, rows, d, centered);
  else
    ln_rows_kernel<T, false><<<blocks, 32 * kLnRowsPerBlock, 0, s>>>(
        xt, scale, bias, ot, nullptr, nullptr, rows, d, 0);
}

}  // namespace

// The inference LayerNorm: out = LN(x) * scale + bias.
extern "C" int ffvc_ln_rows(const void* x, const float* scale, const float* bias, void* out,
                            int rows, int d, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    launch_ln<bf16>(x, scale, bias, out, nullptr, nullptr, rows, d, 0, false, s);
  else
    launch_ln<float>(x, scale, bias, out, nullptr, nullptr, rows, d, 0, false, s);
  FFVC_RETURN_LAST_ERROR();
}

// The train LayerNorm: also rhat and inv where given, in the `centered` order; with
// a null scale and bias, LN-hat (the stacked layout's channel LayerNorm, centered).
extern "C" int ffvc_ln_rows_train(const void* x, const float* scale, const float* bias,
                                  void* out, void* rhat, float* inv, int rows, int d,
                                  int centered, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    launch_ln<bf16>(x, scale, bias, out, rhat, inv, rows, d, centered, true, s);
  else
    launch_ln<float>(x, scale, bias, out, rhat, inv, rows, d, centered, true, s);
  FFVC_RETURN_LAST_ERROR();
}

// The inference GEMM: row-major A, K- or N-major B, bias / GELU / residual.
extern "C" int ffvc_gemm(const void* a, long long lda, long long sa, const void* b,
                         long long ldb, long long sb, int b_kmajor, void* c, long long ldc,
                         long long sc, const void* res, long long ldr, long long sr,
                         const float* bias, int bias_mode, int gelu, int m, int n, int k,
                         int batch, int splits, int k_per_split, float* workspace, int dtype,
                         void* stream) {
  GemmArgs p{};
  fill_common(p, a, lda, sa, b, ldb, sb, c, ldc, sc, res, ldr, sr, bias, bias_mode, gelu, m,
              n, k, splits, k_per_split, workspace);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return b_kmajor ? launch_gemm<bf16, GemmArgs, false, true>(p, batch, s)
                    : launch_gemm<bf16, GemmArgs, false, false>(p, batch, s);
  return b_kmajor ? launch_gemm<float, GemmArgs, false, true>(p, batch, s)
                  : launch_gemm<float, GemmArgs, false, false>(p, batch, s);
}

// The train GEMM: also an M-major A, gelu' / multiply / f32 outputs, batch sums.
extern "C" int ffvc_gemm_train(const void* a, long long lda, long long sa, int a_mmajor,
                               const void* b, long long ldb, long long sb, int b_kmajor,
                               void* c, long long ldc, long long sc, int c_f32,
                               const void* res, long long ldr, long long sr,
                               const float* bias, int bias_mode, int gelu, void* gelu_grad,
                               const void* mul, float* out_f32, int m, int n, int k,
                               int batch, int batch_sum, int splits, int k_per_split,
                               float* workspace, int dtype, void* stream) {
  GemmTrainArgs p{};
  fill_common(p, a, lda, sa, b, ldb, sb, c, ldc, sc, res, ldr, sr, bias, bias_mode, gelu, m,
              n, k, splits, k_per_split, workspace);
  p.gelu_grad = gelu_grad;
  p.mul = mul;
  p.out_f32 = out_f32;
  p.c_f32 = c_f32;
  p.batch_sum = batch_sum;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return run_train_gemm<bf16>(p, a_mmajor, b_kmajor, batch, s);
  return run_train_gemm<float>(p, a_mmajor, b_kmajor, batch, s);
}

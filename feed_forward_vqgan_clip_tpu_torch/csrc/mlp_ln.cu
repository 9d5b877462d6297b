// K11: the pre-LN MLP sublayer of the CLIP ViT blocks, y = x + fc2(act(fc1(LN x))),
// forward and backward, for ops/kernels/mlp_ln.py, which chains
//
//   forward
//     xn  = LN(x) * scale + bias               ffvc_ln_rows_train, centered (mixer_block.cu)
//     g   = act(xn W1^T + b1), dg = act'(.)    fc1: the GEMM with the activation epilogue,
//                                              quick_gelu or GELU
//     out = x + (g W2^T + b2)                  fc2: the GEMM with the residual epilogue
//   backward
//     da  = round((dy W2) * dg)                dgh: the GEMM with the mul epilogue (+ f32 copy)
//     dxn = da W1                              dxn: the GEMM with an f32 output
//     dx  = dy + LN'(dxn)                      ffvc_ln_bwd_rows, statistics recomputed
//                                              from x; also dxn * xhat (mixer_train.cu)
//   and, where the parameter grads are asked for,
//     xn                                       ffvc_ln_rows_train, as in the forward
//     dW1 = da^T xn, dW2 = dy^T g              ffvc_gemm_train, M-major A (mixer_tile.cuh)
//     db1, db2, dscale, dbias                  ffvc_col_sum, fixed order (mixer_train.cu)
//
// Replaces feed_forward_vqgan_clip_tpu/ops/pallas/mlp_ln.py `_fwd_kernel` (`_fwd_res`:
// the sublayer, also saving act(h) and act'(h)) and `_bwd_kernel` (`_bwd`: dx and the
// six parameter grads): the same functions. The TPU kernel keeps both weights (9 MB in
// bf16 at ViT-B/32) resident in VMEM and walks row tiles in order, carrying the
// parameter grads from one to the next; here each matmul is a tiled kernel over all
// rows (the weights stay in the 50 MB L2), and every sum over the rows is a GEMM's K
// dimension or a two-pass column sum in a fixed order: no float atomics, so two runs of
// the same backward give the same bits. The frozen CLIP tower of the train loss needs dx
// only: then the backward is two GEMMs and one row kernel.
//
// What bounds it on an H100: at the train loss (rows = 64 crops x 50 tokens = 3200,
// D = 768, E = 3072, bf16) the forward is 2 x 2 x 3200 x 768 x 3072 = 30.2 GFLOP
// (0.031 ms at 989 TFLOP/s) against about 46 MB of inputs and outputs (0.014 ms at
// 3.35 TB/s): compute-bound. In bf16 the four path GEMMs (fc1, fc2, dgh, dxn) run on
// the Hopper GEMM of wgmma_gemm.cuh (TMA ring, wgmma, persistent tiles; the weights
// read in nn.Linear's layout, dgh's and dxn's MN-major through wgmma's transpose mode),
// through the entry point `ffvc_wgmma_gemm` of wgmma_gemm.cu that the Mixer kernels
// share (ops/kernels/wgmma.py); the tile width (128 or 192 columns) is chosen per GEMM
// by `wgmma_plan` against the wave count. The float32 route and the parameter-grad
// GEMMs stay on the WMMA tile of mixer_tile.cuh. The dx-only backward is the same 30.2 GFLOP; with the parameter
// grads, 60.4. The activation is exact here (expf, erff), not the TPU's polynomial.

#include "mixer_tile.cuh"

using namespace ffvc;

// float32 only: g = act(A B + bias[col]) and act' of the same pre-activation into
// gelu_grad: A (m x k) row-major, B a torch Linear weight (n x k, read K-major), one
// batch element, on the WMMA tile. act: Activation (common.cuh).
extern "C" int ffvc_mlp_gemm(const void* a, long long lda, const void* b, long long ldb, void* c,
                             long long ldc, const float* bias, int act, void* gelu_grad, int m,
                             int n, int k, int splits, int k_per_split, float* workspace,
                             int dtype, void* stream) {
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  GemmMlpArgs p{};
  fill_common(p, a, lda, 0, b, ldb, 0, c, ldc, 0, nullptr, 0, 0, bias, 2, 1, m, n, k, splits,
              k_per_split, workspace);
  p.gelu_grad = gelu_grad;
  p.act = act;
  return launch_gemm<float, GemmMlpArgs, false, true>(p, 1, static_cast<cudaStream_t>(stream));
}

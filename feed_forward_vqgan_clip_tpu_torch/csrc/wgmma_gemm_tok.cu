// The Hopper GEMM of wgmma_gemm.cuh in the two layouts only the Mixer's token backward
// (K8, ops/kernels/mixer_block.py `mixer_token_bwd`) takes:
//   da1 = (t2^T dr) * gelu'(a1)   A M-major (the weight t2 (T, Et) read as its transpose,
//                                  shared by the batch), B MN-major (dr (T, D)), kEpiMul
//                                  with the f32 copy that feeds dt1b;
//   dt2[b] = dr_b g1_b^T, dt1[b] = da1_b xn_b^T   both operands K-major (rows of D),
//                                  kEpiF32: each batch element's product as an f32
//                                  partial, which ffvc_batch_sum (csrc/mixer_train.cu)
//                                  adds in batch order.
// Launched through `ffvc_wgmma_gemm` (wgmma_gemm.cu).

#include "wgmma_gemm.cuh"

namespace ffvc {

int wgmma_launch_tok(const WgmmaParams& p, const WgmmaOperands& o, int a_m_major, int epi,
                     int bn, int grid, cudaStream_t s) {
  if (bn == 128) {
    if (a_m_major && epi == kEpiMul) return launch_wgmma_gemm<128, 1, 1, kEpiMul>(p, o, grid, s);
    if (!a_m_major && epi == kEpiF32) return launch_wgmma_gemm<128, 0, 0, kEpiF32>(p, o, grid, s);
  } else if (bn == 192) {
    if (a_m_major && epi == kEpiMul) return launch_wgmma_gemm<192, 1, 1, kEpiMul>(p, o, grid, s);
    if (!a_m_major && epi == kEpiF32) return launch_wgmma_gemm<192, 0, 0, kEpiF32>(p, o, grid, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ffvc

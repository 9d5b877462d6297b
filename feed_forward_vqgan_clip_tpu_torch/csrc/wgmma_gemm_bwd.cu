// The Hopper GEMM of wgmma_gemm.cuh with the backward's epilogues: B MN-major (a weight
// read as it lies, or an activation (rows, N)) with A K-major (K11's dgh and dxn, the
// Mixer channel backward's da3 = (dout W2) * gelu' and drn = da3 W1) or A M-major (the
// weight grads dW2 = dout^T g3 and dW1 = da3^T rn, K = B*T summed in one wgmma chain
// in K order: the same bits on every run; and the token backward's dxn = t1^T da1 of K8,
// batched with the weight shared). Launched through `ffvc_wgmma_gemm`
// (wgmma_gemm.cu).

#include "wgmma_gemm.cuh"

namespace ffvc {

int wgmma_launch_bwd(const WgmmaParams& p, const WgmmaOperands& o, int a_m_major, int epi,
                     int bn, int grid, cudaStream_t s) {
  if (bn == 128) {
    if (a_m_major) {
      if (epi == kEpiF32) return launch_wgmma_gemm<128, 1, 1, kEpiF32>(p, o, grid, s);
    } else {
      if (epi == kEpiMul) return launch_wgmma_gemm<128, 0, 1, kEpiMul>(p, o, grid, s);
      if (epi == kEpiF32) return launch_wgmma_gemm<128, 0, 1, kEpiF32>(p, o, grid, s);
    }
  } else if (bn == 192) {
    if (a_m_major) {
      if (epi == kEpiF32) return launch_wgmma_gemm<192, 1, 1, kEpiF32>(p, o, grid, s);
    } else {
      if (epi == kEpiMul) return launch_wgmma_gemm<192, 0, 1, kEpiMul>(p, o, grid, s);
      if (epi == kEpiF32) return launch_wgmma_gemm<192, 0, 1, kEpiF32>(p, o, grid, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ffvc

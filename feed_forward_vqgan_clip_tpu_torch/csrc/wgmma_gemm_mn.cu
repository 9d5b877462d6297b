// The Hopper GEMM of wgmma_gemm.cuh with A K-major and B MN-major and the forward's
// epilogues with a per-row bias: the Mixer's token GEMMs (K2, K5, K6: g1 = act(t1 . xn + t1b[row]) and
// r = x + (t2 . g1 + t2b[row]), batched over B with the weight shared), reading the
// activations (T, D) and (Et, D) as they lie. Launched through `ffvc_wgmma_gemm`
// (wgmma_gemm.cu).

#include "wgmma_gemm.cuh"

namespace ffvc {

int wgmma_launch_kmn(const WgmmaParams& p, const WgmmaOperands& o, int epi, int bn, int grid,
                     cudaStream_t s) {
  if (bn == 128) {
    if (epi == kEpiAct) return launch_wgmma_gemm<128, 0, 1, kEpiAct, true>(p, o, grid, s);
    if (epi == kEpiActOnly) return launch_wgmma_gemm<128, 0, 1, kEpiActOnly, true>(p, o, grid, s);
    if (epi == kEpiRes) return launch_wgmma_gemm<128, 0, 1, kEpiRes, true>(p, o, grid, s);
  } else if (bn == 192) {
    if (epi == kEpiAct) return launch_wgmma_gemm<192, 0, 1, kEpiAct, true>(p, o, grid, s);
    if (epi == kEpiActOnly) return launch_wgmma_gemm<192, 0, 1, kEpiActOnly, true>(p, o, grid, s);
    if (epi == kEpiRes) return launch_wgmma_gemm<192, 0, 1, kEpiRes, true>(p, o, grid, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ffvc

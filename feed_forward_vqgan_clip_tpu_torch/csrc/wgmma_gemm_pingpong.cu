// The Hopper GEMM of wgmma_gemm.cuh in its ping-pong schedule (`wgmma_pingpong_kernel`):
// each consumer warpgroup owns whole 128 x 128 output tiles and the two warpgroups'
// wgmma chains take turns, so that one warpgroup's GELU epilogue runs under the
// other's chain. Compiled for the inference forward's kEpiActOnly only, at the
// 128-wide tile: A K-major with B K-major and a column bias (the Mixer's g3) or B
// MN-major and a row bias (the Mixer's token g1). ops/kernels/wgmma.py `wgmma_plan`
// sends such a call here where the persistent CTAs get enough tiles each. Launched
// through `ffvc_wgmma_gemm` (wgmma_gemm.cu).

#include "wgmma_gemm.cuh"

namespace ffvc {

int wgmma_launch_pingpong(const WgmmaParams& p, const WgmmaOperands& o, int b_mn_major, int epi,
                          int grid, cudaStream_t s) {
  if (epi != kEpiActOnly) return static_cast<int>(cudaErrorInvalidValue);
  return b_mn_major ? launch_wgmma_gemm<128, 0, 1, kEpiActOnly, true, true>(p, o, grid, s)
                    : launch_wgmma_gemm<128, 0, 0, kEpiActOnly, false, true>(p, o, grid, s);
}

}  // namespace ffvc

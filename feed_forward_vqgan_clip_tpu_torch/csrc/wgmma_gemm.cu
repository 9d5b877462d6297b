// The entry point of the Hopper GEMM of wgmma_gemm.cuh, shared by K11 (the CLIP MLP
// sublayer: ops/kernels/mlp_ln.py) and the Mixer block (K2, K5, K6, K7, K8:
// ops/kernels/mixer_block.py), through ops/kernels/wgmma.py, and the family of its
// instantiations with both operands K-major: the forward's first and second channel
// GEMMs (K11's fc1 and fc2, the Mixer's g3 and out). wgmma_gemm_mn.cu,
// wgmma_gemm_bwd.cu, wgmma_gemm_tok.cu and wgmma_gemm_pingpong.cu (the forward's GELU
// GEMMs in the ping-pong schedule) hold the other families, so that five nvcc processes
// build them.
// What bounds each GEMM is written beside the kernel that launches it.

#include "wgmma_gemm.cuh"

namespace ffvc {

int wgmma_launch_kk(const WgmmaParams& p, const WgmmaOperands& o, int epi, int bn, int grid,
                    cudaStream_t s) {
  if (bn == 128) {
    if (epi == kEpiAct) return launch_wgmma_gemm<128, 0, 0, kEpiAct>(p, o, grid, s);
    if (epi == kEpiActOnly) return launch_wgmma_gemm<128, 0, 0, kEpiActOnly>(p, o, grid, s);
    if (epi == kEpiRes) return launch_wgmma_gemm<128, 0, 0, kEpiRes>(p, o, grid, s);
  } else if (bn == 192) {
    if (epi == kEpiAct) return launch_wgmma_gemm<192, 0, 0, kEpiAct>(p, o, grid, s);
    if (epi == kEpiActOnly) return launch_wgmma_gemm<192, 0, 0, kEpiActOnly>(p, o, grid, s);
    if (epi == kEpiRes) return launch_wgmma_gemm<192, 0, 0, kEpiRes>(p, o, grid, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ffvc

using namespace ffvc;

// bf16 C[z] (m x n) = A[z] . B[z] for z < batch, with epilogue `epi` (WgmmaEpilogue):
// A K-major ((m, k) row-major, a_m_major 0) or M-major ((k, m), 1), B K-major ((n, k),
// b_mn_major 0) or MN-major ((k, n), 1); sa, sb, sc the batch strides in elements
// (sa or sb 0: shared by the batch; sc that of C, res, mul and aux). bias f32, given
// for kEpiAct, kEpiActOnly and kEpiRes: per column with a K-major B, per row
// (bias_rows) with an MN-major one; res / mul (batch, m, n) bf16; aux (kEpiAct: act'
// bf16; kEpiMul: an optional f32 copy); act (Activation). bn: the tile width, 128 or
// 192; grid: the persistent CTAs; pingpong: the ping-pong schedule (kEpiActOnly at
// bn 128 only), else the cooperative one. Compiled pairs:
// wgmma_gemm.cuh, end. Row lengths multiples of 8 and every pointer 16-byte aligned
// (checked by the wrapper).
extern "C" int ffvc_wgmma_gemm(const void* a, long long sa, int a_m_major, const void* b,
                               long long sb, int b_mn_major, void* c, long long sc, int m, int n,
                               int k, int batch, int epi, const float* bias, int bias_rows,
                               const void* res, const void* mul, void* aux, int act, int bn,
                               int grid, int pingpong, void* stream) {
  WgmmaParams p{};
  p.m = m;
  p.n = n;
  p.k = k;
  p.batch = batch;
  p.sc = sc;
  p.bias = bias;
  p.res = static_cast<const bf16*>(res);
  p.mul = static_cast<const bf16*>(mul);
  p.aux_f32 = epi == kEpiMul ? static_cast<float*>(aux) : nullptr;
  p.act = act;
  const WgmmaOperands o{a, sa, b, sb, c, aux};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a_m_major || epi == kEpiMul || epi == kEpiF32) {  // no bias
    if (bias_rows || pingpong) return static_cast<int>(cudaErrorInvalidValue);
    // the token backward's: da1 (A M-major, mul) and the weight grads' partials (both
    // operands K-major, f32)
    if ((a_m_major && epi == kEpiMul) || (!a_m_major && !b_mn_major))
      return wgmma_launch_tok(p, o, a_m_major, epi, bn, grid, s);
    if (!b_mn_major) return static_cast<int>(cudaErrorInvalidValue);
    return wgmma_launch_bwd(p, o, a_m_major, epi, bn, grid, s);
  }
  // the forward's epilogues add a bias: per column with a K-major B, per row with an
  // MN-major one (the compiled families)
  if (!bias || bias_rows != b_mn_major) return static_cast<int>(cudaErrorInvalidValue);
  if (pingpong)
    return bn == 128 ? wgmma_launch_pingpong(p, o, b_mn_major, epi, grid, s)
                     : static_cast<int>(cudaErrorInvalidValue);
  return b_mn_major ? wgmma_launch_kmn(p, o, epi, bn, grid, s)
                    : wgmma_launch_kk(p, o, epi, bn, grid, s);
}

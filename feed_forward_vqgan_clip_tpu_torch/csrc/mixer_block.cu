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
// kernels).
//
// Replaces feed_forward_vqgan_clip_tpu/ops/pallas/mixer_block.py `_block_kernel`
// (fused_mixer_block) and `_pipe_kernel` (its skewed schedule at B >= 16), and, as
// the train forward, `_block_res_kernel` and `_block_res_pipe_kernel` (the same
// block, also saving g1, gelu'(a1), rhat, inv2, g3, gelu'(a3)): the same functions.
// The TPU kernel keeps one batch element's whole block in 128 MB of VMEM;
// an SM has 227 KB, so here each matmul is its own tiled kernel and the activations
// between them go through L2/HBM (one block's bf16 weights are 18 MB and stay in the
// 50 MB L2 across the batch).
//
// What bounds it on an H100: 2*T*D*(2*Et + 2*Ec) = 5.4 GFLOP per batch element per
// block at the flagship (T=256, D=1024, Et=1024, Ec=4096) against about 60 MB of
// bf16 activation traffic per element: compute-bound, so the bf16 GEMM runs on the
// tensor cores (WMMA m16n16k16, f32 accumulators). The float32 GEMM, used by the
// parity checks, is a shared-memory FMA tile. At batch 1 the output tiles of
// some GEMMs are fewer than the 132 SMs (16 for the second channel GEMM), so K
// is split across blocks there (split-K below). The train forward does the same
// 43 GFLOP at B=8 (0.044 ms at 989 TFLOP/s) and also writes about 70 MB of bf16
// residuals (0.021 ms at 3.35 TB/s): still compute-bound; it writes them from the
// GEMM epilogues, so no extra pass reads the activations. wgmma/TMA pipelines are
// later work.
//
// Numerics follow `_block_math`: f32 LN statistics with var = E[x^2] - E[x]^2
// clamped at 0 and eps 1e-5, f32 accumulation kept through bias and exact GELU
// (erff) and rounded to the working type once, the residual added in the working
// type after that rounding.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <mma.h>

#include "common.cuh"

using namespace ffvc;

namespace {

// ---------------------------------------------------------------- LayerNorm rows

constexpr int kLnRowsPerBlock = 8;  // one warp per row

// out = LN(x) * scale + bias in the working type. kTrain adds the train options,
// compiled out of the inference kernel: `centered` picks the rounding order (0 the
// forward's x*inv - mean*inv, `_kernel_layer_norm`; 1 the backward's
// (x - mean)*inv, `_ln_stats`), and where given, rhat (the normalised row, working
// type) and inv (f32 per row) are written too (`_block_res_kernel`).
template <typename T, bool kTrain>
__global__ void __launch_bounds__(32 * kLnRowsPerBlock)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ out, T* __restrict__ rhat,
               float* __restrict__ inv_out, int rows, int d, int centered) {
  const int row = blockIdx.x * kLnRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warp leaves together
  const T* xr = x + (long long)row * d;
  T* orow = out + (long long)row * d;
  float s = 0.f, ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f(xr[i]);
    s += v;
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float mean = s / d;
  const float var = fmaxf(ss / d - mean * mean, 0.f);
  const float inv = rsqrtf(var + 1e-5f);
  const float mean_inv = mean * inv;
  if constexpr (kTrain) {
    if (inv_out && lane == 0) inv_out[row] = inv;
  }
  for (int i = lane; i < d; i += 32) {
    float t = to_f(xr[i]) * inv - mean_inv;
    if constexpr (kTrain) {
      if (centered) t = (to_f(xr[i]) - mean) * inv;
      if (rhat) rhat[(long long)row * d + i] = from_f<T>(t);
    }
    orow[i] = from_f<T>(fmaf(t, scale[i], bias[i]));
  }
}

// ---------------------------------------------------------------- GEMM

// C[b] (M x N) = A[b] (M x K) . B[b] (K x N), then the epilogue. A is row-major
// (element (m, k) at m*lda + k) or, in the train GEMMs only, M-major (at
// k*lda + m: a matrix read as its transpose). B is K-major, element (k, n) at
// n*ldb + k (a torch Linear weight read as its transpose), or N-major, at
// k*ldb + n.
//
// Epilogue, in this order, on the f32 accumulator v:
//   v += bias[m] or bias[n];
//   gelu:      gelu_grad = gelu'(v) (train, where given, working type), v = gelu(v);
//   mul:       v *= mul (train; working type; da = dg * gelu' of the backward);
//   out_f32:   an f32 copy of v (train, where given);
//   res:       v = round(v) + res, in the working type;
//   C = v, in the working type or (train, c_f32) in float32.
// gelu_grad, mul and out_f32 have C's shape and strides.
//
// Split-K: where the output tiles alone would leave most SMs idle (the token
// GEMMs and the second channel GEMM at batch 1-4), K is cut into `splits`
// ranges; block z = b * splits + s sums its range into an f32 partial tile of
// `partial` (batch, splits, M, N), and splitk_epilogue_kernel adds the ranges
// in order and applies the epilogue. batch_sum (train) takes the same route and
// adds the whole batch's products into one C (a parameter gradient summed over
// the batch, in a fixed order: no atomics, so the sum is the same on every run).
//
// The inference GEMM takes GemmArgs and the train GEMMs GemmTrainArgs; each kernel
// is compiled once per argument struct, so the train branches cost the inference
// kernels nothing (compiled into one kernel, they cost the bf16 GEMM registers
// and spills: about 20% of the Mixer block at B=16 on an H100).
struct GemmArgs {
  const void* a;
  long long lda, sa;
  const void* b;
  long long ldb, sb;
  void* c;
  long long ldc, sc;
  const void* res;  // optional residual R[b] (M x N), working type
  long long ldr, sr;
  const float* bias;  // optional, f32
  int bias_mode;      // 0 none, 1 per row (bias[m]), 2 per column (bias[n])
  int gelu;           // exact GELU after the bias
  int m, n, k;
  int vec_a, vec_b;  // 16-byte loads allowed (aligned base, ld and batch stride % 8)
  int splits, k_per_split;  // split-K plan (splits == 1: none)
  float* partial;           // (batch, splits, M, N) f32 when splits > 1 or batch_sum
};

struct GemmTrainArgs : GemmArgs {
  void* gelu_grad;  // optional gelu'(pre-activation), working type
  const void* mul;  // optional multiplier, working type
  float* out_f32;   // optional f32 copy of the value before the residual
  int c_f32;        // C in float32 instead of the working type
  int batch_sum;    // one C: the sum over the batch of the products
};

template <typename Args>
constexpr bool kIsTrain = std::is_same<Args, GemmTrainArgs>::value;

// Where a block's K range starts and ends, and which batch element it serves.
struct BlockK {
  long long bz;
  int split, k_begin, k_end;
  __device__ explicit BlockK(const GemmArgs& p) {
    bz = blockIdx.z / p.splits;
    split = blockIdx.z % p.splits;
    k_begin = split * p.k_per_split;
    k_end = min(p.k, k_begin + p.k_per_split);
  }
};

__device__ __forceinline__ float gelu_f(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// d/dv gelu(v) = Phi(v) + v phi(v)
__device__ __forceinline__ float gelu_grad_f(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * expf(-0.5f * v * v) * 0.3989422804014327f;
}

// C and R are batch element bz's output and residual in the working type; the
// train outputs (gelu_grad, mul, out_f32, an f32 C) are indexed from p.
template <typename T, typename Args>
__device__ __forceinline__ void epilogue_store(const Args& p, long long bz, T* C, const T* R,
                                               float v, int gm, int gn) {
  if (p.bias_mode == 1)
    v += p.bias[gm];
  else if (p.bias_mode == 2)
    v += p.bias[gn];
  if (p.gelu) {
    if constexpr (kIsTrain<Args>) {
      if (p.gelu_grad)
        static_cast<T*>(p.gelu_grad)[bz * p.sc + gm * p.ldc + gn] = from_f<T>(gelu_grad_f(v));
    }
    v = gelu_f(v);
  }
  if constexpr (kIsTrain<Args>) {
    const long long o = bz * p.sc + gm * p.ldc + gn;
    if (p.mul) v *= to_f(static_cast<const T*>(p.mul)[o]);
    if (p.out_f32) p.out_f32[o] = v;
  }
  if (R) v = to_f(from_f<T>(v)) + to_f(R[gm * p.ldr + gn]);
  if constexpr (kIsTrain<Args>) {
    if (p.c_f32) {
      static_cast<float*>(p.c)[bz * p.sc + gm * p.ldc + gn] = v;
      return;
    }
  }
  C[gm * p.ldc + gn] = from_f<T>(v);
}

template <typename Args>
__device__ __forceinline__ bool to_partials(const Args& p) {
  if constexpr (kIsTrain<Args>)
    return p.splits > 1 || p.batch_sum;
  else
    return p.splits > 1;
}

// A finished accumulator: through the epilogue, or into the split-K partials.
template <typename T, typename Args>
__device__ __forceinline__ void finish(const Args& p, const BlockK& bk, T* C, const T* R,
                                       float v, int gm, int gn) {
  if (to_partials(p))
    p.partial[((bk.bz * p.splits + bk.split) * p.m + gm) * (long long)p.n + gn] = v;
  else
    epilogue_store<T>(p, bk.bz, C, R, v, gm, gn);
}

// Adds the partial tiles of each output in order: the splits of its batch
// element, or (batch_sum) every slab of the batch into the one output.
template <typename T, typename Args>
__global__ void __launch_bounds__(256) splitk_epilogue_kernel(Args p, int batch) {
  int outs = batch, per_out = p.splits;
  if constexpr (kIsTrain<Args>) {
    if (p.batch_sum) {
      outs = 1;
      per_out = batch * p.splits;
    }
  }
  const long long mn = (long long)p.m * p.n;
  const long long total = outs * mn;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total; i += gridDim.x * 256LL) {
    const long long bz = i / mn, e = i % mn;
    const float* slab = p.partial + bz * per_out * mn + e;
    float v = 0.f;
    for (int s = 0; s < per_out; ++s) v += slab[s * mn];
    T* C = static_cast<T*>(p.c) + bz * p.sc;
    const T* R = p.res ? static_cast<const T*>(p.res) + bz * p.sr : nullptr;
    epilogue_store<T>(p, bz, C, R, v, static_cast<int>(e / p.n), static_cast<int>(e % p.n));
  }
}

// float32: 64x64 tile, 16-deep, 256 threads with a 4x4 register tile each.
template <typename Args, bool kAMMajor, bool kBKMajor>
__global__ void __launch_bounds__(256) gemm_f32_kernel(Args p) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const BlockK kr(p);
  const long long bz = kr.bz;
  const float* A = static_cast<const float*>(p.a) + bz * p.sa;
  const float* B = static_cast<const float*>(p.b) + bz * p.sb;
  float* C = static_cast<float*>(p.c) + bz * p.sc;
  const float* R = p.res ? static_cast<const float*>(p.res) + bz * p.sr : nullptr;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4] = {};
  for (int k0 = kr.k_begin; k0 < kr.k_end; k0 += BK) {
    for (int e = tid; e < BM * BK; e += 256) {
      const int mm = kAMMajor ? e % BM : e / BK;
      const int kk = kAMMajor ? e / BM : e % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      float v = 0.f;
      if (gm < p.m && gk < kr.k_end) v = kAMMajor ? A[gk * p.lda + gm] : A[gm * p.lda + gk];
      As[kk][mm] = v;
    }
    for (int e = tid; e < BN * BK; e += 256) {
      const int nn = kBKMajor ? e / BK : e % BN;
      const int kk = kBKMajor ? e % BK : e / BN;
      const int gn = n0 + nn, gk = k0 + kk;
      float v = 0.f;
      if (gn < p.n && gk < kr.k_end) v = kBKMajor ? B[gn * p.ldb + gk] : B[gk * p.ldb + gn];
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty * 4 + i, gn = n0 + tx * 4 + j;
      if (gm < p.m && gn < p.n) finish<float>(p, kr, C, R, acc[i][j], gm, gn);
    }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// bfloat16: 128x128 tile, 32-deep, 8 warps as 2 (M) x 4 (N), each warp 64x32 as
// 4x2 WMMA m16n16k16 fragments with f32 accumulators. Two shared-memory stages:
// the next K tile is copied in with cp.async while the tensor cores work on the
// current one (tile edges and unaligned operands fall back to plain loads). An
// M-major A tile is kept [k][m] in shared memory and read as a column-major
// fragment. The epilogue passes each accumulator fragment through a per-warp
// 16x16 f32 scratch tile laid over the first A stage. Two blocks share an SM
// (2 x 41 KB of shared memory; 2 x 256 threads x 128 registers fill the register
// file): at 129 registers or more only one fits, and the GEMM loses 7-9% (ptxas
// chose 134 and 140 for two instantiations of this kernel before the bound).
template <typename Args, bool kAMMajor, bool kBKMajor>
__global__ void __launch_bounds__(256, 2) gemm_bf16_kernel(Args p) {
  namespace wmma = nvcuda::wmma;
  constexpr int BM = 128, BN = 128, BK = 32, PAD = 8;
  constexpr int LDA_S = kAMMajor ? BM + PAD : BK + PAD;   // 136 or 40
  constexpr int A_ELEMS = kAMMajor ? BK * LDA_S : BM * LDA_S;
  constexpr int LDB_S = kBKMajor ? BK + PAD : BN + PAD;   // 40 or 136
  constexpr int B_ELEMS = kBKMajor ? BN * LDB_S : BK * LDB_S;
  static_assert(A_ELEMS * 2 >= 8 * 16 * 16 * 4, "epilogue scratch must fit in an A stage");
  __shared__ __align__(32) bf16 As[2][A_ELEMS];
  __shared__ __align__(32) bf16 Bs[2][B_ELEMS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const BlockK kr(p);
  const long long bz = kr.bz;
  const bf16* A = static_cast<const bf16*>(p.a) + bz * p.sa;
  const bf16* B = static_cast<const bf16*>(p.b) + bz * p.sb;
  bf16* C = static_cast<bf16*>(p.c) + bz * p.sc;
  const bf16* R = p.res ? static_cast<const bf16*>(p.res) + bz * p.sr : nullptr;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_end = kr.k_end;
  const bf16 zero = __float2bfloat16(0.f);

  auto load_tiles = [&](int stage, int k0) {
    if constexpr (kAMMajor) {  // A tile stored [k][m], 32 x 128: vectors along M
      for (int v = tid; v < BK * BM / 8; v += 256) {
        const int kk = v / (BM / 8), mv = (v % (BM / 8)) * 8;
        const int gk = k0 + kk, gm = m0 + mv;
        bf16* dst = &As[stage][kk * LDA_S + mv];
        const bf16* src = A + gk * p.lda + gm;
        if (p.vec_a && gk < k_end && gm + 8 <= p.m) {
          cp_async16(dst, src);
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q) dst[q] = (gk < k_end && gm + q < p.m) ? src[q] : zero;
        }
      }
    } else {  // A tile stored [m][k], 128 x 32: vectors along K
      for (int v = tid; v < BM * BK / 8; v += 256) {
        const int row = v / (BK / 8), kv = (v % (BK / 8)) * 8;
        const int gm = m0 + row, gk = k0 + kv;
        bf16* dst = &As[stage][row * LDA_S + kv];
        const bf16* src = A + gm * p.lda + gk;
        if (p.vec_a && gm < p.m && gk + 8 <= k_end) {
          cp_async16(dst, src);
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q) dst[q] = (gm < p.m && gk + q < k_end) ? src[q] : zero;
        }
      }
    }
    if constexpr (kBKMajor) {  // B tile stored [n][k], 128 x 32: vectors along K
      for (int v = tid; v < BN * BK / 8; v += 256) {
        const int nn = v / (BK / 8), kv = (v % (BK / 8)) * 8;
        const int gn = n0 + nn, gk = k0 + kv;
        bf16* dst = &Bs[stage][nn * LDB_S + kv];
        const bf16* src = B + gn * p.ldb + gk;
        if (p.vec_b && gn < p.n && gk + 8 <= k_end) {
          cp_async16(dst, src);
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q) dst[q] = (gn < p.n && gk + q < k_end) ? src[q] : zero;
        }
      }
    } else {  // B tile stored [k][n], 32 x 128: vectors along N
      for (int v = tid; v < BK * BN / 8; v += 256) {
        const int kk = v / (BN / 8), nv = (v % (BN / 8)) * 8;
        const int gk = k0 + kk, gn = n0 + nv;
        bf16* dst = &Bs[stage][kk * LDB_S + nv];
        const bf16* src = B + gk * p.ldb + gn;
        if (p.vec_b && gk < k_end && gn + 8 <= p.n) {
          cp_async16(dst, src);
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q) dst[q] = (gk < k_end && gn + q < p.n) ? src[q] : zero;
        }
      }
    }
  };

  using ALayout = typename std::conditional<kAMMajor, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<kBKMajor, wmma::col_major, wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int n_tiles = (k_end - kr.k_begin + BK - 1) / BK;
  if (n_tiles > 0) load_tiles(0, kr.k_begin);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tiles((t + 1) & 1, kr.k_begin + (t + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed; tile t+1 may still be in flight
    __syncthreads();
    const bf16* as = As[t & 1];
    const bf16* bs = Bs[t & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * 64 + i * 16;
        if constexpr (kAMMajor)
          wmma::load_matrix_sync(fa[i], &as[kk * LDA_S + row], LDA_S);
        else
          wmma::load_matrix_sync(fa[i], &as[row * LDA_S + kk], LDA_S);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 32 + j * 16;
        if constexpr (kBKMajor)
          wmma::load_matrix_sync(fb[j], &bs[col * LDB_S + kk], LDB_S);
        else
          wmma::load_matrix_sync(fb[j], &bs[kk * LDB_S + col], LDB_S);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // every warp is done with stage t & 1 before it is refilled
  }
  cp_async_wait<0>();

  float* cs = reinterpret_cast<float*>(As[0]) + warp * 16 * 16;  // 8 KB of the stage
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int e = lane * 8 + q, r = e / 16, cc = e % 16;
        const int gm = m0 + wm * 64 + i * 16 + r, gn = n0 + wn * 32 + j * 16 + cc;
        if (gm < p.m && gn < p.n) finish<bf16>(p, kr, C, R, cs[e], gm, gn);
      }
      __syncwarp();
    }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

void fill_common(GemmArgs& p, const void* a, long long lda, long long sa, const void* b,
                 long long ldb, long long sb, void* c, long long ldc, long long sc,
                 const void* res, long long ldr, long long sr, const float* bias,
                 int bias_mode, int gelu, int m, int n, int k, int splits, int k_per_split,
                 float* workspace) {
  p.a = a;
  p.lda = lda;
  p.sa = sa;
  p.b = b;
  p.ldb = ldb;
  p.sb = sb;
  p.c = c;
  p.ldc = ldc;
  p.sc = sc;
  p.res = res;
  p.ldr = ldr;
  p.sr = sr;
  p.bias = bias;
  p.bias_mode = bias_mode;
  p.gelu = gelu;
  p.m = m;
  p.n = n;
  p.k = k;
  p.vec_a = aligned16(a) && lda % 8 == 0 && sa % 8 == 0;
  p.vec_b = aligned16(b) && ldb % 8 == 0 && sb % 8 == 0;
  p.splits = splits;
  p.k_per_split = k_per_split;
  p.partial = workspace;
}

template <typename T, typename Args, bool kAMMajor, bool kBKMajor>
int launch_gemm(const Args& p, int batch, cudaStream_t s) {
  constexpr int kTile = std::is_same<T, bf16>::value ? 128 : 64;
  const dim3 grid((p.n + kTile - 1) / kTile, (p.m + kTile - 1) / kTile, batch * p.splits);
  if constexpr (std::is_same<T, bf16>::value)
    gemm_bf16_kernel<Args, kAMMajor, kBKMajor><<<grid, 256, 0, s>>>(p);
  else
    gemm_f32_kernel<Args, kAMMajor, kBKMajor><<<grid, 256, 0, s>>>(p);
  bool partials = p.splits > 1;
  if constexpr (kIsTrain<Args>) partials = partials || p.batch_sum;
  if (partials) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    int outs = batch;
    if constexpr (kIsTrain<Args>) outs = p.batch_sum ? 1 : batch;
    const long long total = (long long)outs * p.m * p.n;
    const int blocks = static_cast<int>(std::min<long long>((total + 255) / 256, 4096));
    splitk_epilogue_kernel<T, Args><<<blocks, 256, 0, s>>>(p, batch);
  }
  return static_cast<int>(cudaGetLastError());
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

// The train LayerNorm: also rhat and inv where given, in the `centered` order.
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

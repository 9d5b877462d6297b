// The Mixer kernels' device code: one LayerNorm row, one GEMM output tile with its
// fused epilogue, and the in-order sum of split-K partial tiles. csrc/mixer_block.cu
// launches each as its own kernel (one tile per block: the float32 route, and the
// bf16 GEMMs of K2, K5, K6, K7, K8 at shapes TMA cannot read; at the others those run
// on csrc/wgmma_gemm.cuh), as does the CLIP MLP sublayer (K11) for its float32 route
// and its parameter-grad GEMMs (its bf16 path GEMMs run on csrc/wgmma_gemm.cuh);
// csrc/mixer_stream.cu runs the same functions inside one persistent kernel over the
// whole depth (K4 in float32 and at bf16 shapes TMA cannot read; the others take
// csrc/mixer_stream_wgmma.cu). They therefore compute every tile with the same code.
//
// Numerics follow `_block_math`: f32 LN statistics with var = E[x^2] - E[x]^2
// clamped at 0 and eps 1e-5, f32 accumulation kept through bias and exact GELU
// (erff) and rounded to the working type once, the residual added in the working
// type after that rounding.
//
// No pointer that a kernel reads here is declared __restrict__: in K4 the
// activations a tile reads were written earlier in the same launch, by other
// blocks, so they must not go through the read-only (non-coherent) cache.
#pragma once

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <mma.h>

#include "common.cuh"

namespace ffvc {

// ---------------------------------------------------------------- LayerNorm rows

constexpr int kLnRowsPerBlock = 8;  // one warp per row

// One row of LayerNorm by one warp. t = x*inv - mean*inv (the forward's order,
// `_kernel_layer_norm`) or, `centered`, (x - mean)*inv (`_ln_stats` of the
// backward and `_kernel_ln_hat`); out = t*scale + bias in the working type, or t
// itself where scale is null (LN-hat: the stacked layout folds the affine into the
// next matmul). Where given, rhat (t in the working type) and inv (f32) are
// written too (`_block_res_kernel`).
template <typename T>
__device__ __forceinline__ void ln_row(const T* xr, const float* scale, const float* bias,
                                       T* orow, T* rhat_row, float* inv_out, int d,
                                       bool centered, int lane) {
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
  if (inv_out && lane == 0) *inv_out = inv;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f(xr[i]);
    const float t = centered ? (v - mean) * inv : v * inv - mean_inv;
    if (rhat_row) rhat_row[i] = from_f<T>(t);
    orow[i] = from_f<T>(scale ? fmaf(t, scale[i], bias[i]) : t);
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
// ranges; tile z = b * splits + s sums its range into an f32 partial tile of
// `partial` (batch, splits, M, N), and splitk_reduce adds the ranges in order
// and applies the epilogue. batch_sum (train) takes the same route and adds the
// whole batch's products into one C (a parameter gradient summed over the batch,
// in a fixed order: no atomics, so the sum is the same on every run).
//
// The inference GEMM takes GemmArgs, the train GEMMs GemmTrainArgs and the MLP
// sublayer's activation GEMM GemmMlpArgs; each kernel is compiled once per argument
// struct, so the train branches cost the inference kernels nothing (compiled into
// one kernel, they cost the bf16 GEMM registers and spills: about 20% of the Mixer
// block at B=16 on an H100), and the activation choice costs the Mixer's kernels
// nothing.
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

// The train epilogue with a choice of activation (Activation, common.cuh; the MLP
// sublayer's first GEMM in float32).
// A type of its own, so the Mixer kernels' instantiations do not carry the choice.
struct GemmMlpArgs : GemmTrainArgs {
  int act;  // Activation, where gelu is set
};

template <typename Args>
constexpr bool kIsTrain = std::is_base_of<GemmTrainArgs, Args>::value;
template <typename Args>
constexpr bool kIsMlp = std::is_same<Args, GemmMlpArgs>::value;

// Where a tile's K range starts and ends, and which batch element it serves:
// z = batch element * splits + split.
struct BlockK {
  long long bz;
  int split, k_begin, k_end;
  __device__ BlockK(const GemmArgs& p, int z) {
    bz = z / p.splits;
    split = z % p.splits;
    k_begin = split * p.k_per_split;
    k_end = min(p.k, k_begin + p.k_per_split);
  }
};

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
    // quick_gelu: s = sigmoid(1.702 v), value v s, derivative s + 1.702 (v s) (1 - s)
    // (`_quick_gelu_val_grad`); a constant false outside GemmMlpArgs
    bool quick = false;
    if constexpr (kIsMlp<Args>) quick = p.act == kActQuickGelu;
    float s = 0.f;
    if (quick) s = 1.f / (1.f + expf(-1.702f * v));
    if constexpr (kIsTrain<Args>) {
      if (p.gelu_grad)
        static_cast<T*>(p.gelu_grad)[bz * p.sc + gm * p.ldc + gn] =
            from_f<T>(quick ? s + 1.702f * (v * s) * (1.f - s) : gelu_grad_f(v));
    }
    v = quick ? v * s : gelu_f(v);
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

// Adds the partial tiles of each output in order (the splits of its batch
// element, or with batch_sum every slab of the batch into the one output) and
// applies the epilogue; thread `first` takes outputs first, first + stride, ...
template <typename T, typename Args>
__device__ __forceinline__ void splitk_reduce(const Args& p, int batch, long long first,
                                              long long stride) {
  int outs = batch, per_out = p.splits;
  if constexpr (kIsTrain<Args>) {
    if (p.batch_sum) {
      outs = 1;
      per_out = batch * p.splits;
    }
  }
  const long long mn = (long long)p.m * p.n;
  const long long total = outs * mn;
  for (long long i = first; i < total; i += stride) {
    const long long bz = i / mn, e = i % mn;
    const float* slab = p.partial + bz * per_out * mn + e;
    float v = 0.f;
    for (int s = 0; s < per_out; ++s) v += slab[s * mn];
    T* C = static_cast<T*>(p.c) + bz * p.sc;
    const T* R = p.res ? static_cast<const T*>(p.res) + bz * p.sr : nullptr;
    epilogue_store<T>(p, bz, C, R, v, static_cast<int>(e / p.n), static_cast<int>(e % p.n));
  }
}

// Tile sizes and shared memory of the GEMM tile of each working type and operand
// layout. float32: 64x64 tile, 16-deep, 256 threads with a 4x4 register tile
// each, one stage. bfloat16: 128x128 tile, 32-deep, two stages of A and B; an
// M-major A is kept [k][m], a K-major B [n][k]; rows padded by 8.
template <typename T, bool kAMMajor, bool kBKMajor>
struct GemmTile {
  static constexpr int BM = 64, BN = 64, BK = 16, PAD = 4;
  static constexpr int kSmemBytes = 2 * BK * (BM + PAD) * 4;
};

template <bool kAMMajor, bool kBKMajor>
struct GemmTile<bf16, kAMMajor, kBKMajor> {
  static constexpr int BM = 128, BN = 128, BK = 32, PAD = 8;
  static constexpr int LDA_S = kAMMajor ? BM + PAD : BK + PAD;  // 136 or 40
  static constexpr int A_ELEMS = kAMMajor ? BK * LDA_S : BM * LDA_S;
  static constexpr int LDB_S = kBKMajor ? BK + PAD : BN + PAD;  // 40 or 136
  static constexpr int B_ELEMS = kBKMajor ? BN * LDB_S : BK * LDB_S;
  static constexpr int kSmemBytes = 2 * (A_ELEMS + B_ELEMS) * 2;
};

// One 64x64 float32 output tile (tile_n, tile_m) of batch/split z. smem:
// GemmTile<float, ...>::kSmemBytes, 16-byte aligned.
template <typename Args, bool kAMMajor, bool kBKMajor>
__device__ __forceinline__ void gemm_f32_tile(const Args& p, int tile_n, int tile_m, int z,
                                              unsigned char* smem) {
  using G = GemmTile<float, kAMMajor, kBKMajor>;
  constexpr int BM = G::BM, BN = G::BN, BK = G::BK;
  float(*As)[BM + G::PAD] = reinterpret_cast<float(*)[BM + G::PAD]>(smem);
  float(*Bs)[BN + G::PAD] = reinterpret_cast<float(*)[BN + G::PAD]>(smem + BK * (BM + G::PAD) * 4);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const BlockK kr(p, z);
  const long long bz = kr.bz;
  const float* A = static_cast<const float*>(p.a) + bz * p.sa;
  const float* B = static_cast<const float*>(p.b) + bz * p.sb;
  float* C = static_cast<float*>(p.c) + bz * p.sc;
  const float* R = p.res ? static_cast<const float*>(p.res) + bz * p.sr : nullptr;
  const int m0 = tile_m * BM, n0 = tile_n * BN;

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

// One 128x128 bfloat16 output tile (tile_n, tile_m) of batch/split z: 8 warps as
// 2 (M) x 4 (N), each warp 64x32 as 4x2 WMMA m16n16k16 fragments with f32
// accumulators. Two shared-memory stages: the next K tile is copied in with
// cp.async while the tensor cores work on the current one (tile edges and
// unaligned operands fall back to plain loads). An M-major A tile is kept [k][m]
// in shared memory and read as a column-major fragment. The epilogue passes each
// accumulator fragment through a per-warp 16x16 f32 scratch tile laid over the
// first A stage. smem: GemmTile<bf16, ...>::kSmemBytes, 32-byte aligned.
template <typename Args, bool kAMMajor, bool kBKMajor>
__device__ __forceinline__ void gemm_bf16_tile(const Args& p, int tile_n, int tile_m, int z,
                                               unsigned char* smem) {
  namespace wmma = nvcuda::wmma;
  using G = GemmTile<bf16, kAMMajor, kBKMajor>;
  constexpr int BM = G::BM, BN = G::BN, BK = G::BK;
  constexpr int LDA_S = G::LDA_S;
  constexpr int A_ELEMS = G::A_ELEMS;
  constexpr int LDB_S = G::LDB_S;
  constexpr int B_ELEMS = G::B_ELEMS;
  static_assert(A_ELEMS * 2 >= 8 * 16 * 16 * 4, "epilogue scratch must fit in an A stage");
  bf16* As[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem) + A_ELEMS};
  bf16* Bs[2] = {reinterpret_cast<bf16*>(smem) + 2 * A_ELEMS,
                 reinterpret_cast<bf16*>(smem) + 2 * A_ELEMS + B_ELEMS};

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const BlockK kr(p, z);
  const long long bz = kr.bz;
  const bf16* A = static_cast<const bf16*>(p.a) + bz * p.sa;
  const bf16* B = static_cast<const bf16*>(p.b) + bz * p.sb;
  bf16* C = static_cast<bf16*>(p.c) + bz * p.sc;
  const bf16* R = p.res ? static_cast<const bf16*>(p.res) + bz * p.sr : nullptr;
  const int m0 = tile_m * BM, n0 = tile_n * BN;
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

// The tile of the working type T.
template <typename T, typename Args, bool kAMMajor, bool kBKMajor>
__device__ __forceinline__ void gemm_tile(const Args& p, int tile_n, int tile_m, int z,
                                          unsigned char* smem) {
  if constexpr (std::is_same<T, bf16>::value)
    gemm_bf16_tile<Args, kAMMajor, kBKMajor>(p, tile_n, tile_m, z, smem);
  else
    gemm_f32_tile<Args, kAMMajor, kBKMajor>(p, tile_n, tile_m, z, smem);
}

__host__ __device__ inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

__host__ __device__ inline void fill_common(GemmArgs& p, const void* a, long long lda,
                                            long long sa, const void* b, long long ldb,
                                            long long sb, void* c, long long ldc, long long sc,
                                            const void* res, long long ldr, long long sr,
                                            const float* bias, int bias_mode, int gelu, int m,
                                            int n, int k, int splits, int k_per_split,
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

// ---------------------------------------------------------------- one tile per block

// The kernels that run one output tile per block, launched by csrc/mixer_block.cu and
// csrc/mlp_ln.cu; each file compiles the instantiations it launches. (Templates of
// namespace ffvc, not of an anonymous namespace: nvcc's registration stubs fail to
// compile for a file that includes kernels from two anonymous namespaces.)

// The split-K partial tiles of a launch, added in order (splitk_reduce).
template <typename T, typename Args>
__global__ void __launch_bounds__(256) splitk_epilogue_kernel(Args p, int batch) {
  splitk_reduce<T>(p, batch, blockIdx.x * 256LL + threadIdx.x, gridDim.x * 256LL);
}

// One output tile per block: tile (blockIdx.x, blockIdx.y) of batch/split
// blockIdx.z. The bf16 GEMM is held to two blocks per SM (2 x 41 KB of shared
// memory; 2 x 256 threads x 128 registers fill the register file): at 129
// registers or more only one fits, and the GEMM loses 7-9% (ptxas chose 134 and
// 140 for two instantiations of this kernel before the bound).
template <typename Args, bool kAMMajor, bool kBKMajor>
__global__ void __launch_bounds__(256) gemm_f32_kernel(Args p) {
  __shared__ __align__(16) unsigned char smem[GemmTile<float, kAMMajor, kBKMajor>::kSmemBytes];
  gemm_f32_tile<Args, kAMMajor, kBKMajor>(p, blockIdx.x, blockIdx.y, blockIdx.z, smem);
}

template <typename Args, bool kAMMajor, bool kBKMajor>
__global__ void __launch_bounds__(256, 2) gemm_bf16_kernel(Args p) {
  __shared__ __align__(128) unsigned char smem[GemmTile<bf16, kAMMajor, kBKMajor>::kSmemBytes];
  gemm_bf16_tile<Args, kAMMajor, kBKMajor>(p, blockIdx.x, blockIdx.y, blockIdx.z, smem);
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

}  // namespace ffvc

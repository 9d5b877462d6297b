// Nearest-codebook search (K1): idx[n] = first-match argmin_k (|c_k|^2 - 2 x_n . c_k), on
// Hopper's tensor cores to float32 accuracy.
//
// Replaces feed_forward_vqgan_clip_tpu/ops/pallas/vq_lookup.py `_vq_kernel`
// (`nearest_codebook_indices_pallas`). x (N, C) float32, codebook (K, C) float32, |c|^2
// (K,) float32 computed by the wrapper; out int32 (N,). N, K and C any.
//
// What bounds it on an H100: the scores are an (N, K, C) product, 2 N K C flops (8.59
// GFLOP at N=1024, K=16384, C=256). In float32 on the CUDA cores that is 0.128 ms at 67
// TFLOP/s; run as below on the bf16 tensor cores it is six products, 6 x 8.59 GFLOP at 989
// TFLOP/s: 0.052 ms. The bytes (x, the codebook, |c|^2, the indices: 17 MB) take 0.005 ms.
// No (N, K) score matrix is written anywhere.
//
// Precision: split operands (bf16x3), the scheme of XLA's HIGHEST precision on the TPU's
// MXU (ops/pallas/warp_adjoint.py: a float32 product as six bf16 passes). Each float32 v of
// x and of the codebook is three bf16 pieces
//     h = bf16(v),  m = bf16(v - h),  l = bf16(v - h - m),
// v = h + m + l exactly wherever the pieces stay in bf16's normal range (h is taken
// towards zero where rounding would carry a finite v to infinity). Of the nine piece
// products of x.c the six kept go into one f32 wgmma chain per output tile, small first:
//     m.m, l.h, h.l, m.h, h.m, h.h;
// the three dropped (m.l, l.m, l.l) are each below about 2^-24 |x||c|. Chosen over 3xTF32
// (wgmma .tf32, k = 8): the same tensor-core time, 2^-21 instead of 2^-24, and a second
// operand type for the ring; the bf16 ring, TMA maps and descriptors of wgmma_gemm.cuh
// serve as they are.
//
// Three launches:
//   * vq_split_kernel writes the pieces of x and of the codebook, (3, N, Cp) and (3, K,
//     Cp) bf16, channels zero-padded to Cp, a multiple of 64 (exact zeros in every product;
//     TMA reads 128-byte rows whatever C is);
//   * vq_argmin_kernel: a CTA owns a 128-token row block and one contiguous codebook range
//     (a split: column tiles [s T / S, (s + 1) T / S) of T = ceil(K / 128)), and walks that
//     range's 128-code column tiles. wgmma_gemm.cuh's pieces: a producer warpgroup that
//     gives up its registers and whose first thread issues the TMA loads into a ring of
//     6 stages, two consumer warpgroups of 64 rows each issuing m64n128k16 wgmma. One K
//     step is one product's 64 channels: the producer loads that product's pair of pieces
//     (the piece is the batch coordinate of the rank-3 maps), so no six-fold copy exists.
//     No C tile is stored: each fragment element becomes s = |c_k|^2 - 2 acc and a
//     running lexicographic (score, index) minimum per row stays in registers (2 rows a
//     thread); at the range's end the 4 lanes of a quad meet by shuffles and one
//     (min, arg) pair per row and split is written. CTA i holds split i / RB and row
//     block i % RB, so the row blocks reading one codebook range run side by side and
//     meet in L2. The plan (ops/kernels/vq_lookup.py `vq_plan`) picks the splits;
//   * vq_combine_kernel folds the splits in split order.
// Ties keep the LOWEST index everywhere: every comparison, within a thread, across a
// quad and across splits, is the lexicographic (score, index) minimum, the first-match
// argmin of the TPU kernel. NaN scores never compare; a row whose scores are all NaN gets
// index 0. Ragged N and K: TMA reads zeros past the edges, codes >= K are skipped and rows
// >= N are not written.

#include <math.h>
#include <math_constants.h>

#include <climits>

#include "wgmma_gemm.cuh"

namespace ffvc {
namespace vq {

constexpr int kBN = 128;       // codes of a column tile
constexpr int kProducts = 6;   // piece products a tile's chain runs over
constexpr int kPieces = 3;

// The (x piece, codebook piece) of product p, small first: m.m, l.h, h.l, m.h, h.m, h.h
// (piece 0 = h, 1 = m, 2 = l), as nibbles from p = 0 up.
__device__ __forceinline__ int piece_x(int p) { return (0x001021 >> (4 * p)) & 0xF; }
__device__ __forceinline__ int piece_c(int p) { return (0x010201 >> (4 * p)) & 0xF; }

// The search's shared memory, in the layout WgSmem reads: the ring's stages of one x box
// (128 rows x 64 channels) and one codebook box (128 codes x 64), no output buffers.
struct VqTile {
  static constexpr int kABytes = kWgBM * kWgBK * 2;  // 16 KB
  static constexpr int kBBytes = kBN * kWgBK * 2;    // 16 KB
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kEpiBytes = 0;
  static constexpr int kStages = 6;
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};
static_assert(VqTile::kSmemBytes <= 232448, "the ring must fit one SM's shared memory");

struct VqParams {
  CUtensorMap map_x;  // x's pieces (3, N, Cp): 128-row boxes, the piece the batch coordinate
  CUtensorMap map_c;  // the codebook's pieces (3, K, Cp): 128-row boxes
  const float* c2;    // (K,)
  float* part_min;    // (splits, N)
  int* part_arg;      // (splits, N)
  int n, k;
  int kc;  // Cp / 64: the K steps of one product
  int row_blocks, col_tiles, splits;
};

__device__ __forceinline__ bool better(float v, int i, float best_v, int best_i) {
  return v < best_v || (v == best_v && i < best_i);
}

__device__ __forceinline__ void split3(float v, bf16& h, bf16& m, bf16& l) {
  h = __float2bfloat16(v);
  if (isinf(__bfloat162float(h)) && isfinite(v)) h = __float2bfloat16_rz(v);
  const float r = __fsub_rn(v, __bfloat162float(h));
  m = __float2bfloat16(r);
  l = __float2bfloat16(__fsub_rn(r, __bfloat162float(m)));
}

// One thread per 4 channels of a row of x (rows 0 .. N-1) or of the codebook (N ..
// N+K-1), over the padded width; the pieces go to planes 0 (h), 1 (m), 2 (l).
__global__ void __launch_bounds__(256)
vq_split_kernel(const float* __restrict__ x, const float* __restrict__ cb, bf16* __restrict__ xp,
                bf16* __restrict__ cp, int n, int k, int c, int channels) {
  const int groups = channels / 4;
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= static_cast<long long>(n + k) * groups) return;
  const int row = static_cast<int>(i / groups), c0 = static_cast<int>(i % groups) * 4;
  const bool is_x = row < n;
  const int r = is_x ? row : row - n;
  const float* src = (is_x ? x : cb) + static_cast<long long>(r) * c;
  const long long plane = static_cast<long long>(is_x ? n : k) * channels;
  bf16* dst = (is_x ? xp : cp) + static_cast<long long>(r) * channels + c0;
  alignas(8) bf16 piece[kPieces][4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split3(c0 + e < c ? src[c0 + e] : 0.f, piece[0][e], piece[1][e], piece[2][e]);
#pragma unroll
  for (int q = 0; q < kPieces; ++q)
    *reinterpret_cast<uint2*>(dst + q * plane) = *reinterpret_cast<const uint2*>(piece[q]);
}

// The producer (one thread): per column tile of the split, per product, per 64 channels,
// wait for the stage to be free, arm its full barrier, load the two boxes.
__device__ __forceinline__ void vq_produce(const VqParams& p, const WgSmem<VqTile>& sm,
                                           int rb, int t_begin, int t_end) {
  WgRing ring;
  const int steps = kProducts * p.kc;
  for (int t = t_begin; t < t_end; ++t) {
    for (int kt = 0; kt < steps; ++kt) {
      const int prod = kt / p.kc, c0 = kt % p.kc * kWgBK;
      mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
      mbar_expect_tx(&sm.full[ring.stage], VqTile::kStageBytes);
      tma_load_3d(sm.sa + ring.stage * VqTile::kABytes, &p.map_x, &sm.full[ring.stage], c0,
                  rb * kWgBM, piece_x(prod));
      tma_load_3d(sm.sb + ring.stage * VqTile::kBBytes, &p.map_c, &sm.full[ring.stage], c0,
                  t * kBN, piece_c(prod));
      ring.advance(VqTile::kStages);
    }
  }
}

// A consumer warpgroup (rows 64 c .. of the row block): the chain of each column tile,
// then the argmin epilogue on the fragment; at the end one (min, arg) per row.
__device__ __forceinline__ void vq_consume(const VqParams& p, const WgSmem<VqTile>& sm, int rb,
                                           int split, int t_begin, int t_end) {
  const int c = threadIdx.x / 128 - 1, lt = threadIdx.x % 128, warp = lt / 32, lane = lt % 32;
  const int steps = kProducts * p.kc;
  WgRing ring;
  float best_v[2] = {CUDART_INF_F, CUDART_INF_F};
  int best_i[2] = {INT_MAX, INT_MAX};
  float d[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) d[i] = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * kBN;
    // |c|^2 at the fragment's columns, read while the chain runs
    float c2v[kBN / 4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + j * 8 + lane % 4 * 2 + e;
        c2v[2 * j + e] = col < p.k ? p.c2[col] : 0.f;
      }
    int prev = 0;
    for (int kt = 0; kt < steps; ++kt) {
      mbar_wait(&sm.full[ring.stage], ring.phase);
      wgmma_fence();
      // this consumer's 64 rows: the second half of the 128-row box, 8 KB in
      const unsigned char* a = sm.sa + ring.stage * VqTile::kABytes + c * kWgBox;
      const unsigned char* b = sm.sb + ring.stage * VqTile::kBBytes;
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk)
        wgmma_k16<kBN, 0, 0>(d, wgmma_desc(a + kk * 32, 16, 1024),
                             wgmma_desc(b + kk * 32, 16, 1024), (kt | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's group has retired: release that stage
      if (kt > 0 && lane == 0) mbar_arrive(&sm.empty[prev]);
      prev = ring.stage;
      ring.advance(VqTile::kStages);
    }
    wgmma_wait<0>();
    fence_regs<kBN / 2>(d);
    if (lane == 0) mbar_arrive(&sm.empty[prev]);
    // thread (warp w, lane l) holds rows 16w + l/4 (+ 8) at columns 8j + 2(l % 4) (+ 1),
    // visited in increasing column order
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + j * 8 + lane % 4 * 2 + e;
        if (col < p.k) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float s = c2v[2 * j + e] - 2.f * d[4 * j + 2 * half + e];
            if (better(s, col, best_v[half], best_i[half])) {
              best_v[half] = s;
              best_i[half] = col;
            }
          }
        }
      }
  }
  // the 4 lanes of a quad share their rows
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v = best_v[half];
    int bi = best_i[half];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, v, bi)) {
        v = ov;
        bi = oi;
      }
    }
    const int row = rb * kWgBM + c * 64 + warp * 16 + lane / 4 + half * 8;
    if (lane % 4 == 0 && row < p.n) {
      p.part_min[static_cast<long long>(split) * p.n + row] = v;
      p.part_arg[static_cast<long long>(split) * p.n + row] = bi;
    }
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
vq_argmin_kernel(const __grid_constant__ VqParams p) {
  extern __shared__ unsigned char vq_smem_raw[];
  const WgSmem<VqTile> sm(vq_smem_raw);
  if (threadIdx.x == 0) sm.init();
  __syncthreads();
  // a split's row blocks are neighbours in the launch order
  const int split = blockIdx.x / p.row_blocks, rb = blockIdx.x % p.row_blocks;
  const int t_begin = static_cast<int>(static_cast<long long>(split) * p.col_tiles / p.splits);
  const int t_end = static_cast<int>(static_cast<long long>(split + 1) * p.col_tiles / p.splits);
  if (threadIdx.x / 128 == 0) {  // producer: registers to the consumers, one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) vq_produce(p, sm, rb, t_begin, t_end);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    vq_consume(p, sm, rb, split, t_begin, t_end);
  }
}

__global__ void vq_combine_kernel(const float* __restrict__ part_min,
                                  const int* __restrict__ part_arg, int* __restrict__ out,
                                  int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float bv = part_min[i];
  int bi = part_arg[i];
  for (int s = 1; s < splits; ++s) {
    const float v = part_min[static_cast<long long>(s) * n + i];
    const int a = part_arg[static_cast<long long>(s) * n + i];
    if (better(v, a, bv, bi)) {
      bv = v;
      bi = a;
    }
  }
  // all-NaN scores never compare: index 0, as argmin's first-NaN rule gives
  out[i] = bi == INT_MAX ? 0 : bi;
}

}  // namespace vq
}  // namespace ffvc

using namespace ffvc;

// x (n, c), codebook (k, c) float32 -> their pieces xp (3, n, channels), cp (3, k,
// channels) bf16; channels a multiple of 64, at least c.
extern "C" int ffvc_vq_split(const float* x, const float* codebook, void* xp, void* cp, int n,
                             int k, int c, int channels, void* stream) {
  if (channels % kWgBK || channels < c) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(n + k) * (channels / 4);
  vq::vq_split_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, codebook, static_cast<bf16*>(xp), static_cast<bf16*>(cp), n, k, c, channels);
  FFVC_RETURN_LAST_ERROR();
}

// The search over the pieces (ffvc_vq_split) with |c|^2 (k,): ceil(n / 128) row blocks x
// splits CTAs, split s over column tiles [s T / splits, (s + 1) T / splits) of the T =
// ceil(k / 128) tiles of 128 codes, splits <= T; per-split pairs in part_min, part_arg
// (splits, n), then out (n,) int32.
extern "C" int ffvc_vq_argmin(const void* xp, const void* cp, const float* c2, float* part_min,
                              int* part_arg, int* out, int n, int k, int channels, int splits,
                              void* stream) {
  const int row_blocks = (n + kWgBM - 1) / kWgBM, col_tiles = (k + vq::kBN - 1) / vq::kBN;
  if (channels % kWgBK || splits < 1 || splits > col_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  vq::VqParams p{};
  if (!make_tensor_map(&p.map_x, xp, n, channels, vq::kPieces,
                       static_cast<long long>(n) * channels, kWgBM) ||
      !make_tensor_map(&p.map_c, cp, k, channels, vq::kPieces,
                       static_cast<long long>(k) * channels, vq::kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  p.c2 = c2;
  p.part_min = part_min;
  p.part_arg = part_arg;
  p.n = n;
  p.k = k;
  p.kc = channels / kWgBK;
  p.row_blocks = row_blocks;
  p.col_tiles = col_tiles;
  p.splits = splits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        vq::vq_argmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, vq::VqTile::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attribute_set = true;
  }
  vq::vq_argmin_kernel<<<row_blocks * splits, kWgThreads, vq::VqTile::kSmemBytes, s>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  vq::vq_combine_kernel<<<(n + 255) / 256, 256, 0, s>>>(part_min, part_arg, out, n, splits);
  FFVC_RETURN_LAST_ERROR();
}

extern "C" const char* ffvc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

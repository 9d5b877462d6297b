// A Hopper GEMM for bf16 operands with f32 accumulation: TMA loads into a ring of
// 128-byte-swizzled shared-memory stages, one producer warp, two consumer warpgroups
// issuing wgmma.mma_async, a persistent tile loop, and TMA stores. It carries the CLIP
// MLP sublayer's four GEMMs (K11, csrc/mlp_ln.cu) and the Mixer block's (K2, K5, K6,
// K7, K8; ops/kernels/mixer_block.py) with their epilogues, through one entry point,
// `ffvc_wgmma_gemm` (csrc/wgmma_gemm.cu), and, through its tile walk, the Mixer stack
// (K4, csrc/mixer_stream_wgmma.cu):
//
//   C[z] (M x N) = A[z] (M x K) . B[z],  z = 0 .. batch - 1,
//   A K-major: stored (M, K), element (m, k) at m*K + k, or M-major: stored (K, M), at
//              k*M + m (a matrix read as its transpose: the weight grads' activations),
//   B K-major: stored (N, K), element (k, n) at n*K + k (an nn.Linear weight read as
//              its transpose), or MN-major: stored (K, N), at k*N + n (a weight read
//              as it lies),
// the transposed layouts through wgmma's transpose modes for 16-bit types, with no
// transposed copy. A batched operand steps by its batch stride; one with stride 0
// (a weight shared by the batch, the token GEMMs' t1 and t2) is read at every z.
//
// Block: 3 warpgroups (384 threads). Warpgroup 0 gives up registers (setmaxnreg) and
// its first thread issues every TMA load; warpgroups 1 and 2 take 64 rows each of a
// 128 x BN output tile. Per K step of 64: A's box (128 x 64 K-major, or two boxes of
// 64 x 64 M-major, one per consumer) and B's (BN x 64 K-major, or BN/64 boxes of
// 64 x 64 MN-major) land in one of kStages stages; the producer arms the stage's
// `full` barrier with the bytes it expects, the consumers wait on it, issue four
// m64nBNk16 wgmma (K 16 each), keep one group in flight, and arrive on the stage's
// `empty` barrier (one arrival per consumer warp) once the group that read it has
// retired, so that the producer may refill it. The CTAs walk the output tiles tile =
// blockIdx.x, + gridDim.x, ... (grid = min(tiles, SMs); batch innermost, so that
// neighbouring CTAs read the same tile of a shared weight while it sits in L2, then
// columns, then row blocks), the same sequence in the producer and the consumers, so
// the loads of the next tile overlap a tile's epilogue. The walk over one GEMM's tiles
// is a pair of device functions, `wg_produce` and `wg_consume`, over a `WgmmaPhase`
// (tensor maps by pointer, sizes, epilogue operands) and a ring whose stage and parity
// (`WgRing`) carry over from one call to the next: `wgmma_gemm_kernel` calls them once,
// the persistent Mixer stack (K4, csrc/mixer_stream_wgmma.cu) once per GEMM phase of
// every block, with a split-K walk (kSplitK) whose tiles store f32 partials.
//
// Epilogue: each consumer warpgroup takes its 64 x BN accumulator through the
// per-element arithmetic in registers (res or mul and a per-row bias, read at the
// start of the tile so that the loads overlap the K loop), writes the outputs into
// its own buffer in the layout of 128-byte-swizzled TMA boxes (64 rows x 128 bytes:
// conflict-free for the fragment's writes), and one thread stores the boxes with TMA
// and goes on: the stores drain during the next tile's K loop; the buffer is reused
// only once they have read it. Ragged M and N edges are zero-filled by the loads and
// clipped by the stores. Numerics: each output's K sum is one chain of wgmma in K
// order, the same on every run (no split-K, no atomics); the epilogues keep the
// rounding points of the WMMA tile's (csrc/mixer_tile.cuh, `epilogue_store`), with
// bias[m] (kRowBias, a template argument: each instantiation has one bias mode, so the
// epilogue tests none per element) or bias[n]:
//   kEpiAct      v += bias; dg = round(act'(v)) into aux, C = round(act(v))  (fc1, g1, g3)
//   kEpiActOnly  v += bias; C = round(act(v)): one output plane, so the stage
//                ring takes the bytes of the derivative's buffer      (K2, K5: g1, g3)
//   kEpiRes      v += bias; C = round(round(v) + res)                   (fc2, r, out)
//   kEpiMul      v *= mul; aux (f32, where given) = v; C = round(v)     (dgh, da3)
//   kEpiF32      C = v in float32                             (dxn, drn, dW1, dW2)
//
// The accumulator fragment of m64nNk16: thread t of a warpgroup (warp w = t / 32,
// lane l) holds, for each 8-column group j, d[4j], d[4j + 1] at row 16w + l/4,
// columns 8j + 2(l % 4) and + 1, and d[4j + 2], d[4j + 3] eight rows below.
//
// Two schedules walk a call's tiles. Cooperative (`wg_consume`, above): both consumer
// warpgroups on one 128 x BN tile, 64 rows each, its K loop together and then its
// epilogue together, so the tensor cores idle while the epilogue runs. Ping-pong
// (`wg_consume_pingpong`, `wgmma_pingpong_kernel`; BN 128, kEpiActOnly):
// each warpgroup owns whole tiles, the CTA's even ones and its odd ones, as two
// m64n128 chains; a pair of named barriers makes the two warpgroups' chains take
// turns, so one warpgroup's epilogue runs while the other's chain runs. The producer
// (`wg_produce`) and the ring are the same: the tiles' K steps in order. The caller
// picks the schedule (ops/kernels/wgmma.py `wgmma_plan`): ping-pong where every
// persistent CTA gets at least two tiles (tiles >= 2 x SMs; with one tile a CTA there
// is nothing to overlap; on an H100 ping-pong ran the Mixer's GELU GEMMs 1.25-1.54x
// faster from 1.9 to 124 tiles a CTA) and the epilogue is the one the walk is compiled
// for, else cooperative. Both give the same bits: each output is the same chain of
// m64n128k16 wgmma in K order under either, and the epilogues do the same operations
// with the same rounding points, so which schedule ran cannot show in the output.
// `pingpong_write` repeats `epilogue`'s kEpiActOnly arithmetic rather than sharing it,
// so that the cooperative walk's code (K4's and K1's too) stays as it was; the GPU
// tests hold the two schedules' outputs equal bit for bit.
//
// Requirements, checked by the caller (ops/kernels/wgmma.py `tma_ok`): every operand's
// row length (K or M for A, K or N for B, N for C) a multiple of 8, batch strides
// multiples of 8 elements, 16-byte-aligned bases (TMA's strides and addresses).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include <cstdint>

#include "common.cuh"

namespace ffvc {

constexpr int kWgBM = 128;  // output rows of a tile: two consumer warpgroups x 64
constexpr int kWgBK = 64;   // K per stage: one 128-byte swizzle row of bf16
constexpr int kWgThreads = 384;
constexpr int kWgBox = 64 * 64 * 2;  // one 64 x 64 bf16 box: 8 KB

enum WgmmaEpilogue : int { kEpiAct = 0, kEpiRes = 1, kEpiMul = 2, kEpiF32 = 3, kEpiActOnly = 4 };

struct WgmmaParams {
  CUtensorMap map_a;    // A (batch, M, K): box 128 x 64; or (batch, K, M): box 64 x 64
  CUtensorMap map_b;    // B (batch, N, K): box BN x 64; or (batch, K, N): box 64 x 64
  CUtensorMap map_c;    // C (batch, M, N): boxes of 64 rows x 128 bytes
  CUtensorMap map_aux;  // kEpiAct: act' (batch, M, N) bf16, as C
  int m, n, k, batch;
  int a_batched, b_batched;  // 0: the operand is shared by the batch (stride 0)
  long long sc;              // batch stride (elements) of C, res, mul, aux_f32
  const float* bias;         // (N,) or, kRowBias, (M,) float32: kEpiAct*, kEpiRes
  const bf16* res;  // (batch, M, N): kEpiRes
  const bf16* mul;  // (batch, M, N): kEpiMul
  float* aux_f32;   // kEpiMul: an optional f32 copy of v (batch, M, N), stored directly
  int act;          // kEpiAct*: Activation
};

// One GEMM as the tile walk reads it: WgmmaParams with the tensor maps by pointer (they
// stay in the kernel's parameter space: TMA reads a map from there), the batch
// coordinate of a shared operand (0; K4: the layer of a stacked weight), and K4's
// split-K plan.
struct WgmmaPhase {
  const CUtensorMap* map_a;
  const CUtensorMap* map_b;
  const CUtensorMap* map_c;
  const CUtensorMap* map_aux;
  int m, n, k, batch;
  int a_batched, b_batched;
  int za, zb;  // the batch coordinate of A / B where it is shared by the batch
  long long sc;
  const float* bias;
  const bf16* res;
  const bf16* mul;
  float* aux_f32;
  int act;
  // kSplitK: K cut into `splits` ranges of k_split K steps; with splits > 1 a tile
  // stores its f32 sum into partial (splits, batch, M, N) and no epilogue runs
  int splits, k_split;
  float* partial;
};

__device__ __forceinline__ WgmmaPhase phase_of(const WgmmaParams& p) {
  return WgmmaPhase{&p.map_a, &p.map_b, &p.map_c, &p.map_aux, p.m, p.n, p.k, p.batch,
                    p.a_batched, p.b_batched, 0, 0, p.sc, p.bias, p.res, p.mul, p.aux_f32,
                    p.act, 1, 0, nullptr};
}

// The operands' addresses and batch strides (elements; 0: shared by the batch).
struct WgmmaOperands {
  const void* a;
  long long sa;
  const void* b;
  long long sb;
  void* c;
  void* aux;
};

// C's element type and the columns of one 128-byte store box.
template <int kEpi>
struct EpiOut {
  static constexpr int kBytes = kEpi == kEpiF32 ? 4 : 2;
  static constexpr int kBoxCols = 128 / kBytes;
  static constexpr int kPlanes = kEpi == kEpiAct ? 2 : 1;  // C, and act' for kEpiAct
};

template <int BN, int kEpi>
struct WgmmaTile {
  static constexpr int kABytes = kWgBM * kWgBK * 2;  // 16 KB
  static constexpr int kBBytes = BN * kWgBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // each consumer warpgroup's output buffer: its planes of 64 rows x BN
  static constexpr int kPlaneBytes = 64 * BN * EpiOut<kEpi>::kBytes;
  static constexpr int kEpiBytes = EpiOut<kEpi>::kPlanes * kPlaneBytes;
  static constexpr int kFree = 232448 - 1024 - 2 * kEpiBytes - 2 * 6 * 8;
  static constexpr int kStages = kFree / kStageBytes < 6 ? kFree / kStageBytes : 6;
  static_assert(kStages >= 3, "the ring needs at least three stages");
  // stages, output buffers, the stages' full and empty barriers, and slack to align
  // the base to 1024 bytes
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kEpiBytes + 2 * kStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of the rank-3 `map` at coordinates (c0 innermost, c1, batch c2) into shared
// memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box from shared memory to `map` at (c0, c1, c2), in this thread's bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The stores issued so far have read their shared memory (kRead) or are complete.
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Synchronises the 128 threads of one consumer warpgroup (named barrier `id`).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// The wgmma shared-memory descriptor of a 128-byte-swizzled tile at `p` (1024-byte
// aligned swizzle atoms): start address, leading and stride byte offsets, all in
// 16-byte units, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>((sbo_bytes & 0x3FFFF) >> 4) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Ties the accumulator registers to this point: no read of them moves above a wait.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16) . B (16 x 128), bf16 from shared memory; A
// K-major (kTransA 0) or M-major (1), B K-major (kTransB 0) or MN-major (1); scale_d
// 0 drops d's old value.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// d (64 x 192, f32) += A (64 x 16) . B (16 x 192), as wgmma_m64n128k16.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n192k16(float* d, uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, %99, %100;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

template <int BN, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_k16(float* d, uint64_t desc_a, uint64_t desc_b,
                                          int scale_d) {
  if constexpr (BN == 128)
    wgmma_m64n128k16<kTransA, kTransB>(d, desc_a, desc_b, scale_d);
  else
    wgmma_m64n192k16<kTransA, kTransB>(d, desc_a, desc_b, scale_d);
}

// Output tile `t` of the walk: batch innermost, then column blocks, then row blocks;
// with kSplitK the K range (split) outside the batch, inside the columns.
template <bool kSplitK>
struct WgTile {
  int m0, n0, z, split;
  __device__ WgTile(int t, int tiles_n, int batch, int bn, int splits) {
    int mn;
    if constexpr (kSplitK) {
      const int zs = t % (batch * splits);
      z = zs % batch;
      split = zs / batch;
      mn = t / (batch * splits);
    } else {
      z = t % batch;
      split = 0;
      mn = t / batch;
    }
    m0 = mn / tiles_n * kWgBM;
    n0 = mn % tiles_n * bn;
  }
};

// The ring's next stage to fill (producer) or read (consumers) and its parity; carried
// from one phase to the next, since both sides walk the same stages in the same order.
struct WgRing {
  int stage = 0, phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The shared memory of a tile walk: kStages ring stages of A and B boxes, one output
// buffer per consumer warpgroup, the stages' full and empty barriers; the base aligned
// to 1024 bytes (the 128-byte swizzle's atom).
template <class Tile>
struct WgSmem {
  unsigned char* sa;
  unsigned char* sb;
  unsigned char* out;
  uint64_t* full;
  uint64_t* empty;
  __device__ explicit WgSmem(unsigned char* raw) {
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    sa = base;
    sb = base + Tile::kStages * Tile::kABytes;
    out = sb + Tile::kStages * Tile::kBBytes;
    full = reinterpret_cast<uint64_t*>(out + 2 * Tile::kEpiBytes);
    empty = full + Tile::kStages;
  }
  // by one thread, before a __syncthreads
  __device__ void init() const {
    for (int s = 0; s < Tile::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// Byte offset of (row r, column lc) of a plane of 64 x BN elements of `bytes` each,
// laid out as 128-byte-swizzled TMA boxes of 64 rows x 128 bytes, box after box.
__device__ __forceinline__ int swizzled(int r, int lc, int bytes) {
  const int box_cols = 128 / bytes, cc = lc % box_cols;
  const int chunk = cc * bytes / 16;
  return lc / box_cols * 8192 + r * 128 + ((chunk ^ (r % 8)) << 4) + cc * bytes % 16;
}

// What the epilogue reads besides the accumulator, at the fragment's places, read at
// the start of the tile: e[2j + half] holds res (kEpiRes) or mul (kEpiMul) at columns
// (8j + 2(l % 4), + 1) of row 16w + l/4 + 8 half, rb[half] that row's bias (kRowBias).
template <int BN, int kEpi, bool kRowBias>
__device__ __forceinline__ void epilogue_prefetch(const WgmmaPhase& p, __nv_bfloat162* e,
                                                  float* rb, int m0, int n0, int z) {
  const int lt = threadIdx.x % 128, warp = lt / 32, lane = lt % 32;
  if constexpr (kRowBias) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + warp * 16 + lane / 4 + half * 8;
      rb[half] = row < p.m ? p.bias[row] : 0.f;
    }
  }
  if constexpr (kEpi == kEpiRes || kEpi == kEpiMul) {
    const bf16* src = (kEpi == kEpiRes ? p.res : p.mul) + z * p.sc;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + warp * 16 + lane / 4 + half * 8, col = n0 + j * 8 + (lane % 4) * 2;
        e[2 * j + half] = row < p.m && col < p.n
                              ? *reinterpret_cast<const __nv_bfloat162*>(
                                    src + static_cast<long long>(row) * p.n + col)
                              : __floats2bfloat162_rn(0.f, 0.f);
      }
  }
}

// One consumer warpgroup's epilogue of its 64 x BN accumulator (rows m0 .., columns
// n0 .. of batch element z) into `buf` and out through TMA stores issued by its first
// thread.
template <int BN, int kEpi, bool kRowBias>
__device__ __forceinline__ void epilogue(const WgmmaPhase& p, const float* d,
                                         const __nv_bfloat162* e, const float* rb,
                                         unsigned char* buf, int m0, int n0, int z, int bar_id) {
  using Out = EpiOut<kEpi>;
  constexpr int kPlane = 64 * BN * Out::kBytes;
  constexpr bool kAct = kEpi == kEpiAct || kEpi == kEpiActOnly;
  const int lt = threadIdx.x % 128, warp = lt / 32, lane = lt % 32;
  if (lt == 0) bulk_wait<true>();  // the previous tile's stores have read the buffer
  warpgroup_sync(bar_id);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int lc = j * 8 + (lane % 4) * 2, col = n0 + lc;
    float b0 = 0.f, b1 = 0.f;
    if constexpr ((kAct || kEpi == kEpiRes) && !kRowBias) {
      if (col < p.n) {
        b0 = p.bias[col];
        b1 = p.bias[col + 1];
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + lane / 4 + half * 8;
      float v0 = d[4 * j + 2 * half], v1 = d[4 * j + 2 * half + 1];
      if constexpr (kAct || kEpi == kEpiRes) {
        v0 += kRowBias ? rb[half] : b0;
        v1 += kRowBias ? rb[half] : b1;
      }
      const int o = swizzled(r, lc, Out::kBytes);
      if constexpr (kAct) {
        // quick_gelu: s = sigmoid(1.702 v), value v s, derivative s + 1.702 (v s) (1 - s);
        // or exact GELU. Kept as one loop over the pair: fc1, bound by this epilogue, ran
        // slower with a helper called once per element.
        float g[2] = {v0, v1};
        [[maybe_unused]] float dg[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float v = g[i];
          if (p.act == kActQuickGelu) {
            // the correctly rounded reciprocal: 1.f / x to the bit, without a division
            const float s = __frcp_rn(1.f + expf(-1.702f * v));
            if constexpr (kEpi == kEpiAct) dg[i] = s + 1.702f * (v * s) * (1.f - s);
            g[i] = v * s;
          } else {
            if constexpr (kEpi == kEpiAct) dg[i] = gelu_grad_f(v);
            g[i] = gelu_f(v);
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(buf + o) = __floats2bfloat162_rn(g[0], g[1]);
        if constexpr (kEpi == kEpiAct)
          *reinterpret_cast<__nv_bfloat162*>(buf + kPlane + o) =
              __floats2bfloat162_rn(dg[0], dg[1]);
      } else if constexpr (kEpi == kEpiRes) {
        const __nv_bfloat162 r2 = e[2 * j + half];
        v0 = to_f(from_f<bf16>(v0)) + __low2float(r2);
        v1 = to_f(from_f<bf16>(v1)) + __high2float(r2);
        *reinterpret_cast<__nv_bfloat162*>(buf + o) = __floats2bfloat162_rn(v0, v1);
      } else if constexpr (kEpi == kEpiMul) {
        const __nv_bfloat162 m2 = e[2 * j + half];
        v0 *= __low2float(m2);
        v1 *= __high2float(m2);
        const int row = m0 + r;
        if (p.aux_f32 && row < p.m && col < p.n)
          *reinterpret_cast<float2*>(p.aux_f32 + z * p.sc + static_cast<long long>(row) * p.n +
                                     col) = make_float2(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(buf + o) = __floats2bfloat162_rn(v0, v1);
      } else {
        *reinterpret_cast<float2*>(buf + o) = make_float2(v0, v1);
      }
    }
  }
  // the generic-proxy writes, visible to the TMA (async proxy), then one thread stores
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(bar_id);
  if (lt == 0) {
#pragma unroll
    for (int plane = 0; plane < Out::kPlanes; ++plane)
#pragma unroll
      for (int bx = 0; bx < BN / Out::kBoxCols; ++bx)
        if (n0 + bx * Out::kBoxCols < p.n)
          tma_store_3d(plane ? p.map_aux : p.map_c, buf + plane * kPlane + bx * 8192,
                       n0 + bx * Out::kBoxCols, m0, z);
    bulk_commit();
  }
}

// A split tile's 64 x BN accumulator (rows m0 .., columns n0 .. of batch element z,
// K range `split`) into the f32 partials, straight from the fragment.
template <int BN>
__device__ __forceinline__ void store_partial(const WgmmaPhase& p, const float* d, int m0,
                                              int n0, int z, int split) {
  const int lt = threadIdx.x % 128, warp = lt / 32, lane = lt % 32;
  float* dst = p.partial + (static_cast<long long>(split) * p.batch + z) * p.m * p.n;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + warp * 16 + lane / 4 + half * 8, col = n0 + j * 8 + (lane % 4) * 2;
      if (row < p.m && col < p.n)
        *reinterpret_cast<float2*>(dst + static_cast<long long>(row) * p.n + col) =
            make_float2(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
    }
}

// The K steps of tile `at`: [kb, ke).
template <bool kSplitK>
__device__ __forceinline__ void k_range(const WgmmaPhase& p, int split, int& kb, int& ke) {
  const int k_tiles = (p.k + kWgBK - 1) / kWgBK;
  if constexpr (kSplitK) {
    if (p.splits > 1) {
      kb = split * p.k_split;
      ke = min(k_tiles, kb + p.k_split);
      return;
    }
  }
  kb = 0;
  ke = k_tiles;
}

// The producer's walk over one phase's tiles (one thread): per K step, wait for the
// stage to be free, arm its full barrier with the bytes it expects, issue the loads.
template <class Tile, int BN, int kTransA, int kTransB, bool kSplitK>
__device__ __forceinline__ void wg_produce(const WgmmaPhase& p, const WgSmem<Tile>& sm,
                                           WgRing& ring) {
  const int splits = kSplitK ? p.splits : 1;
  const int tiles_n = (p.n + BN - 1) / BN;
  const int tiles = (p.m + kWgBM - 1) / kWgBM * tiles_n * p.batch * splits;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const WgTile<kSplitK> at(t, tiles_n, p.batch, BN, splits);
    const int za = p.a_batched ? at.z : p.za, zb = p.b_batched ? at.z : p.zb;
    // an M-major (MN-major) box wholly below M (right of N) is not loaded: its rows
    // (columns) are never stored
    const int a_boxes = kTransA ? min(2, (p.m - at.m0 + 63) / 64) : 1;
    const int b_boxes = kTransB ? min(BN / 64, (p.n - at.n0 + 63) / 64) : 1;
    const unsigned bytes = (kTransA ? a_boxes * kWgBox : Tile::kABytes) +
                           (kTransB ? b_boxes * kWgBox : Tile::kBBytes);
    int kb, ke;
    k_range<kSplitK>(p, at.split, kb, ke);
    for (int kt = kb; kt < ke; ++kt) {
      mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
      mbar_expect_tx(&sm.full[ring.stage], bytes);
      unsigned char* a = sm.sa + ring.stage * Tile::kABytes;
      if constexpr (kTransA) {
        for (int j = 0; j < a_boxes; ++j)
          tma_load_3d(a + j * kWgBox, p.map_a, &sm.full[ring.stage], at.m0 + 64 * j, kt * kWgBK,
                      za);
      } else {
        tma_load_3d(a, p.map_a, &sm.full[ring.stage], kt * kWgBK, at.m0, za);
      }
      unsigned char* b = sm.sb + ring.stage * Tile::kBBytes;
      if constexpr (kTransB) {
        for (int j = 0; j < b_boxes; ++j)
          tma_load_3d(b + j * kWgBox, p.map_b, &sm.full[ring.stage], at.n0 + 64 * j, kt * kWgBK,
                      zb);
      } else {
        tma_load_3d(b, p.map_b, &sm.full[ring.stage], kt * kWgBK, at.n0, zb);
      }
      ring.advance(Tile::kStages);
    }
  }
}

// A consumer warpgroup's walk over the same tiles: rows 64 c .. of each, c = 0, 1 (the
// warpgroup after the producer's). Its TMA stores may still be in flight on return.
template <class Tile, int BN, int kTransA, int kTransB, int kEpi, bool kRowBias, bool kSplitK>
__device__ __forceinline__ void wg_consume(const WgmmaPhase& p, const WgSmem<Tile>& sm,
                                           WgRing& ring) {
  const int splits = kSplitK ? p.splits : 1;
  const int tiles_n = (p.n + BN - 1) / BN;
  const int tiles = (p.m + kWgBM - 1) / kWgBM * tiles_n * p.batch * splits;
  const int c = threadIdx.x / 128 - 1, lane = threadIdx.x % 32;
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  __nv_bfloat162 e[BN / 4];  // res or mul at the fragment's places
  float rb[2] = {0.f, 0.f};  // the rows' biases (kRowBias)
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const WgTile<kSplitK> at(t, tiles_n, p.batch, BN, splits);
    const int m0 = at.m0 + c * 64;
    const bool to_partial = kSplitK && splits > 1;
    if (!to_partial) epilogue_prefetch<BN, kEpi, kRowBias>(p, e, rb, m0, at.n0, at.z);
    int kb, ke;
    k_range<kSplitK>(p, at.split, kb, ke);
    int prev = 0;
    for (int kt = kb; kt < ke; ++kt) {
      mbar_wait(&sm.full[ring.stage], ring.phase);
      wgmma_fence();
      // this consumer's 64 rows of A: the second half of a K-major box (64 rows of
      // 128 bytes) or the second M-major box, 8 KB in either layout
      const unsigned char* a = sm.sa + ring.stage * Tile::kABytes + c * kWgBox;
      const unsigned char* b = sm.sb + ring.stage * Tile::kBBytes;
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        // K-major: 128-byte rows, 8-row groups 1024 bytes apart; K steps of 16 = 32
        // bytes. M- or MN-major: 64-wide M (N) chunks 8 KB apart (LBO), 8-deep K groups
        // 1024 bytes apart (SBO), K steps of 16 rows = 2048 bytes.
        const uint64_t da = kTransA ? wgmma_desc(a + kk * 2048, kWgBox, 1024)
                                    : wgmma_desc(a + kk * 32, 16, 1024);
        const uint64_t db = kTransB ? wgmma_desc(b + kk * 2048, kWgBox, 1024)
                                    : wgmma_desc(b + kk * 32, 16, 1024);
        wgmma_k16<BN, kTransA, kTransB>(d, da, db, ((kt - kb) | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's group has retired: release that stage
      if (kt > kb && lane == 0) mbar_arrive(&sm.empty[prev]);
      prev = ring.stage;
      ring.advance(Tile::kStages);
    }
    wgmma_wait<0>();
    fence_regs<BN / 2>(d);
    if (lane == 0) mbar_arrive(&sm.empty[prev]);
    if (to_partial)
      store_partial<BN>(p, d, m0, at.n0, at.z, at.split);
    else
      epilogue<BN, kEpi, kRowBias>(p, d, e, rb, sm.out + c * Tile::kEpiBytes, m0, at.n0, at.z,
                                   1 + c);
  }
}

template <int BN, int kTransA, int kTransB, int kEpi, bool kRowBias>
__global__ void __launch_bounds__(kWgThreads, 1)
    wgmma_gemm_kernel(const __grid_constant__ WgmmaParams p) {
  using Tile = WgmmaTile<BN, kEpi>;
  extern __shared__ unsigned char wg_smem_raw[];
  const WgSmem<Tile> sm(wg_smem_raw);
  if (threadIdx.x == 0) sm.init();
  __syncthreads();
  const WgmmaPhase ph = phase_of(p);
  WgRing ring;
  if (threadIdx.x / 128 == 0) {  // producer: registers to the consumers, one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) wg_produce<Tile, BN, kTransA, kTransB, false>(ph, sm, ring);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    wg_consume<Tile, BN, kTransA, kTransB, kEpi, kRowBias, false>(ph, sm, ring);
    if (threadIdx.x % 128 == 0) bulk_wait<false>();  // the last stores are complete
  }
}

// ---------------------------------------------------------------- the ping-pong walk

// The ping-pong walk's shared memory: the ring's stages as WgmmaTile's and, per
// consumer warpgroup, an output buffer of two 64-row slots (the two halves of its
// tile). Compiled for the inference forward's kEpiActOnly: one bf16 plane.
template <int BN>
struct WgmmaPingTile {
  static constexpr int kABytes = kWgBM * kWgBK * 2;
  static constexpr int kBBytes = BN * kWgBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSlotBytes = 64 * BN * 2;
  static constexpr int kEpiBytes = 2 * kSlotBytes;
  static constexpr int kFree = 232448 - 1024 - 2 * kEpiBytes - 2 * 6 * 8;
  static constexpr int kStages = kFree / kStageBytes < 6 ? kFree / kStageBytes : 6;
  static_assert(kStages >= 3, "the ring needs at least three stages");
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kEpiBytes + 2 * kStages * 8 + 1024;
};

// The turns of the two consumer warpgroups' wgmma chains: warpgroup c waits on named
// barrier kTurnBar + c, which the other warpgroup's arrival completes (128 + 128
// threads) once it has issued the chain of the CTA's tile before.
constexpr int kTurnBar = 3;  // 0: __syncthreads; 1, 2: the warpgroups' epilogues

__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(kTurnBar + c) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(kTurnBar + 1 - c) : "memory");
}

// One 64 x BN half of a ping-pong tile through kEpiActOnly into `buf`, in the layout
// of the store boxes: the operations of `epilogue`, in its order and with its rounding
// points, with the activation a template argument (kActFn), so that the unrolled
// element loop holds no branch and the compiler interleaves the elements (with the
// test of p.act in the loop the ping-pong epilogue ran 1.7x longer). A copy apart
// from `epilogue`, so that the cooperative walk (K4's too) compiles as it did. d and
// rb as `epilogue` reads them.
template <int BN, bool kRowBias, int kActFn>
__device__ __forceinline__ void pingpong_write(const WgmmaPhase& p, const float* d,
                                               const float* rb, unsigned char* buf, int n0) {
  const int lt = threadIdx.x % 128, warp = lt / 32, lane = lt % 32;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int lc = j * 8 + (lane % 4) * 2, col = n0 + lc;
    float b0 = 0.f, b1 = 0.f;
    if constexpr (!kRowBias) {
      if (col < p.n) {
        b0 = p.bias[col];
        b1 = p.bias[col + 1];
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + lane / 4 + half * 8;
      float g[2] = {d[4 * j + 2 * half] + (kRowBias ? rb[half] : b0),
                    d[4 * j + 2 * half + 1] + (kRowBias ? rb[half] : b1)};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v = g[i];
        if constexpr (kActFn == kActQuickGelu) {
          const float s = __frcp_rn(1.f + expf(-1.702f * v));
          g[i] = v * s;
        } else {
          g[i] = gelu_f(v);
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(buf + swizzled(r, lc, 2)) =
          __floats2bfloat162_rn(g[0], g[1]);
    }
  }
}

// One warpgroup's epilogue of its 128 x BN tile (rows m0 .., columns n0 .. of batch
// element z) into its two slots, once their previous stores have read them, then one
// thread stores both: d holds rows 0-63 then rows 64-127, rb the row biases of the
// first half, read at the tile's start (those of the second are read after the first
// half). The halves run through one copy of the code, the second half moved into the
// registers the first one read: with the two halves unrolled, an epilogue of twice the
// instructions beside the other warpgroup's chain ran 2.5x longer.
template <class Tile, int BN, bool kRowBias>
__device__ __forceinline__ void epilogue_pingpong(const WgmmaPhase& p, float* d, float* rb,
                                                  unsigned char* buf, int m0, int n0, int z,
                                                  int bar_id) {
  const int lt = threadIdx.x % 128;
  if (lt == 0) bulk_wait<true>();  // the previous tile's stores have read the slots
  warpgroup_sync(bar_id);
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    unsigned char* slot = buf + h * Tile::kSlotBytes;
    if (p.act == kActQuickGelu)
      pingpong_write<BN, kRowBias, kActQuickGelu>(p, d, rb, slot, n0);
    else
      pingpong_write<BN, kRowBias, kActGelu>(p, d, rb, slot, n0);
    // rows 64-127 into the registers the code above reads
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = d[i + BN / 2];
    if (h == 0) epilogue_prefetch<BN, kEpiActOnly, kRowBias>(p, nullptr, rb, m0 + 64, n0, z);
  }
  // the generic-proxy writes, visible to the TMA (async proxy), then one thread stores
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(bar_id);
  if (lt == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int bx = 0; bx < BN / 64; ++bx)
        if (n0 + bx * 64 < p.n)
          tma_store_3d(p.map_c, buf + h * Tile::kSlotBytes + bx * 8192, n0 + bx * 64,
                       m0 + 64 * h, z);
    bulk_commit();
  }
}

// A consumer warpgroup's walk in the ping-pong schedule: warpgroup c (0, 1) owns the
// CTA's tiles i = c, c + 2, ... whole, 128 x BN as two m64nBN wgmma chains (rows 0-63,
// 64-127) over the same B. The chains of the two warpgroups take turns (turn_wait /
// turn_pass), so one warpgroup's epilogue runs while the other's chain runs. The ring
// is wg_produce's: tile i's K steps sit at positions i * k_tiles .., which the
// warpgroup reads from their stage and parity; it reaches a position only after every
// earlier one has been read (the turns order them), so a parity wait cannot pass a
// lap early. Its TMA stores may still be in flight on return.
template <class Tile, int BN, int kTransA, int kTransB, bool kRowBias>
__device__ __forceinline__ void wg_consume_pingpong(const WgmmaPhase& p, const WgSmem<Tile>& sm) {
  const int tiles_n = (p.n + BN - 1) / BN;
  const int tiles = (p.m + kWgBM - 1) / kWgBM * tiles_n * p.batch;
  const int k_tiles = (p.k + kWgBK - 1) / kWgBK;
  const int c = threadIdx.x / 128 - 1, lane = threadIdx.x % 32;
  float d[BN];
  float rb[2] = {0.f, 0.f};  // the row biases (kRowBias) of rows 0-63
  unsigned char* buf = sm.out + c * Tile::kEpiBytes;
  for (int i = c, t = blockIdx.x + c * gridDim.x; t < tiles; i += 2, t += 2 * gridDim.x) {
    const WgTile<false> at(t, tiles_n, p.batch, BN, 1);
    // read while the other warpgroup's chain and this one's run
    epilogue_prefetch<BN, kEpiActOnly, kRowBias>(p, nullptr, rb, at.m0, at.n0, at.z);
    if (i > 0) turn_wait(c);
    int prev = 0;
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int q = i * k_tiles + kt, stage = q % Tile::kStages;
      mbar_wait(&sm.full[stage], (q / Tile::kStages) & 1);
      wgmma_fence();
      const unsigned char* a = sm.sa + stage * Tile::kABytes;
      const unsigned char* b = sm.sb + stage * Tile::kBBytes;
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        // descriptors as wg_consume's; rows 64-127 of A start one 8-KB box further
        const uint64_t db = kTransB ? wgmma_desc(b + kk * 2048, kWgBox, 1024)
                                    : wgmma_desc(b + kk * 32, 16, 1024);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned char* ah = a + h * kWgBox;
          const uint64_t da = kTransA ? wgmma_desc(ah + kk * 2048, kWgBox, 1024)
                                      : wgmma_desc(ah + kk * 32, 16, 1024);
          wgmma_k16<BN, kTransA, kTransB>(d + h * (BN / 2), da, db, (kt | kk) != 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's group has retired: release that stage
      if (kt > 0 && lane == 0) mbar_arrive(&sm.empty[prev]);
      prev = stage;
    }
    if (t + gridDim.x < tiles) turn_pass(c);  // the CTA's next tile is the other's
    wgmma_wait<0>();
    fence_regs<BN>(d);
    if (lane == 0) mbar_arrive(&sm.empty[prev]);
    epilogue_pingpong<Tile, BN, kRowBias>(p, d, rb, buf, at.m0, at.n0, at.z, 1 + c);
  }
}

template <int BN, int kTransA, int kTransB, int kEpi, bool kRowBias>
__global__ void __launch_bounds__(kWgThreads, 1)
    wgmma_pingpong_kernel(const __grid_constant__ WgmmaParams p) {
  static_assert(kEpi == kEpiActOnly, "the ping-pong walk's epilogue");
  using Tile = WgmmaPingTile<BN>;
  extern __shared__ unsigned char wg_smem_raw[];
  const WgSmem<Tile> sm(wg_smem_raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < Tile::kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4);  // one arrival per warp of the warpgroup that read it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const WgmmaPhase ph = phase_of(p);
  if (threadIdx.x / 128 == 0) {  // producer: registers to the consumers, one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    WgRing ring;
    if (threadIdx.x == 0) wg_produce<Tile, BN, kTransA, kTransB, false>(ph, sm, ring);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    wg_consume_pingpong<Tile, BN, kTransA, kTransB, kRowBias>(ph, sm);
    if (threadIdx.x % 128 == 0) bulk_wait<false>();  // the last stores are complete
  }
}

// ---------------------------------------------------------------- host side

// libcuda's cuTensorMapEncodeTiled, through the runtime's entry-point lookup (no
// -lcuda at link).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// The TMA map of `batch` row-major (rows, cols) matrices of bf16 (f32: float32),
// `batch_stride` elements apart (0: one matrix, read at every batch coordinate),
// boxes of box_rows x 128 bytes, 128-byte swizzle, zeros outside. False where the
// encoder refuses it.
inline bool make_tensor_map(CUtensorMap* map, const void* base, long long rows, long long cols,
                            int batch, long long batch_stride, int box_rows, bool f32 = false) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return false;
  const int bytes = f32 ? 4 : 2;
  const bool batched = batch_stride != 0 && batch > 1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batched ? batch : 1)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * bytes,
      static_cast<cuuint64_t>(batched ? batch_stride : rows * cols) * bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / bytes),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elems[3] = {1, 1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elems,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Fills the maps of A (K-major (m, k), or M-major (k, m)), B (K-major (n, k), or
// MN-major (k, n)), C (m, n) and, for kEpiAct, aux (m, n), each of p.batch matrices,
// and launches `grid` persistent CTAs of the BN-wide tile, cooperative or (kPingPong)
// ping-pong. Returns a cudaError_t as int.
template <int BN, int kTransA, int kTransB, int kEpi, bool kRowBias = false,
          bool kPingPong = false>
int launch_wgmma_gemm(WgmmaParams p, const WgmmaOperands& o, int grid, cudaStream_t s) {
  p.a_batched = o.sa != 0 && p.batch > 1;
  p.b_batched = o.sb != 0 && p.batch > 1;
  const bool ok =
      (kTransA ? make_tensor_map(&p.map_a, o.a, p.k, p.m, p.batch, o.sa, 64)
               : make_tensor_map(&p.map_a, o.a, p.m, p.k, p.batch, o.sa, kWgBM)) &&
      (kTransB ? make_tensor_map(&p.map_b, o.b, p.k, p.n, p.batch, o.sb, 64)
               : make_tensor_map(&p.map_b, o.b, p.n, p.k, p.batch, o.sb, BN)) &&
      make_tensor_map(&p.map_c, o.c, p.m, p.n, p.batch, p.sc, 64, kEpi == kEpiF32) &&
      (kEpi != kEpiAct || make_tensor_map(&p.map_aux, o.aux, p.m, p.n, p.batch, p.sc, 64));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(WgmmaParams);
  int smem;
  if constexpr (kPingPong) {
    kernel = wgmma_pingpong_kernel<BN, kTransA, kTransB, kEpi, kRowBias>;
    smem = WgmmaPingTile<BN>::kSmemBytes;
  } else {
    kernel = wgmma_gemm_kernel<BN, kTransA, kTransB, kEpi, kRowBias>;
    smem = WgmmaTile<BN, kEpi>::kSmemBytes;
  }
  static bool attribute_set = false;  // once per instantiation (and process)
  if (!attribute_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attribute_set = true;
  }
  kernel<<<grid, kWgThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The compiled (layout, epilogue) pairs, one family per source so that nvcc builds
// them in parallel; each returns cudaErrorInvalidValue for a pair it does not hold.
//   wgmma_gemm.cu     A K-major, B K-major: kEpiAct, kEpiActOnly, kEpiRes with a
//                     column bias (fc1, fc2; the channel forward g3, out)
//   wgmma_gemm_mn.cu  A K-major, B MN-major: kEpiAct, kEpiActOnly, kEpiRes with a
//                     row bias (the token forward g1, r)
//   wgmma_gemm_bwd.cu A K-major, B MN-major: kEpiMul, kEpiF32 (dgh, dxn, da3, drn);
//                     A M-major, B MN-major: kEpiF32 (dW2, dW1; the token dxn)
//   wgmma_gemm_tok.cu A M-major, B MN-major: kEpiMul (the token da1); A K-major, B
//                     K-major: kEpiF32 (the token weight grads' per-element partials)
//   wgmma_gemm_pingpong.cu  the ping-pong walk at BN 128: A K-major, B K-major (column
//                     bias) or MN-major (row bias), with kEpiActOnly
int wgmma_launch_pingpong(const WgmmaParams& p, const WgmmaOperands& o, int b_mn_major, int epi,
                          int grid, cudaStream_t s);
int wgmma_launch_kk(const WgmmaParams& p, const WgmmaOperands& o, int epi, int bn, int grid,
                    cudaStream_t s);
int wgmma_launch_kmn(const WgmmaParams& p, const WgmmaOperands& o, int epi, int bn, int grid,
                     cudaStream_t s);
int wgmma_launch_bwd(const WgmmaParams& p, const WgmmaOperands& o, int a_m_major, int epi,
                     int bn, int grid, cudaStream_t s);
int wgmma_launch_tok(const WgmmaParams& p, const WgmmaOperands& o, int a_m_major, int epi,
                     int bn, int grid, cudaStream_t s);

}  // namespace ffvc

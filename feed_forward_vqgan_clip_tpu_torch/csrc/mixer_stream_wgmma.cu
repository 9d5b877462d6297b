// The whole MLP-Mixer block stack in one persistent launch on the Hopper GEMM's tile
// walk (K4 in bf16 wherever TMA can read the operands; csrc/mixer_stream.cu keeps the
// float32 route and the bf16 shapes TMA cannot read). Over the stacked layout of
// ops/kernels/mixer_block.py `stack_mixer_params`, per block l, with the channel
// LayerNorm's affine folded into w1f and b1f:
//
//   (a) xn = LN1(x)                          rows,  one warp per row
//   (b) g1 = gelu(t1[l] . xn + t1b[l])       GEMM, batched over B        (Et, D)
//   (c) r  = x + (t2[l] . g1 + t2b[l])       GEMM, batched over B        (T, D)
//   (d) xn = LN-hat(r)                       rows, no affine, centered
//   (e) g3 = gelu(xn . w1f[l]^T + b1f[l])    GEMM, batch folded into M   (B*T, Ec)
//   (f) x' = r + (g3 . w2[l]^T + b2[l])      GEMM, batch folded into M   (B*T, D)
//
// Replaces feed_forward_vqgan_clip_tpu/ops/pallas/mixer_block.py `_stream_kernel`
// (fused_mixer_stream -> _fused_mixer_stream_impl): the same function. The TPU kernel
// walks the depth in order and streams block l+1's weights into VMEM while block l
// computes. Here one CTA per SM (384 threads: a producer warpgroup whose first thread
// issues every TMA load, two consumer warpgroups issuing wgmma; the dynamic shared
// memory of wgmma_gemm.cuh's 128-wide ring) runs l = 0..L-1 through the six phases in
// one cooperative launch. Each GEMM phase is `wg_produce` / `wg_consume` of
// wgmma_gemm.cuh over that GEMM's output tiles, with the ring's stage and parity
// carried from phase to phase, tensor maps of rank 3 for the stacked weights (the
// layer is the batch coordinate) and for the activation buffers, all in this kernel's
// __grid_constant__ parameter. The row phases (LN1, LN-hat, the split-K sums) run on
// the consumer warpgroups; the producer warpgroup, which gave up its registers, only
// meets them at the grid barriers. Nothing asks L2 for the next block's weights ahead
// (the TPU kernel's streaming): on an H100 that made the launch slower (PERF.md).
//
// A GEMM whose output tiles leave most SMs idle (at B=1: r and out have 16 tiles of
// 128 x 128 on 132 SMs) cuts K into the plan's `splits` ranges (ops/kernels/
// mixer_stream.py `stream_plan`): each tile stores its f32 sum, straight from the
// accumulator, into a (splits, batch, M, N) partial, and the splits are added in order
// with the GEMM's epilogue (bias, GELU or the residual, with the tile epilogue's
// rounding points) after the barrier: for g1 and g3 in a phase of their own, for r and
// out inside the row phase that reads them next (LN-hat, the next block's LN1), which
// saves those sums their barriers. Sums are taken in a fixed order, so two launches on
// the same inputs give the same bits.
//
// Ordering across phases (one grid barrier after each phase, 6 to 8 per block): a
// consumer's TMA stores are complete (cp.async.bulk.wait_group 0) and every thread's
// generic writes are fenced against the async proxy (fence.proxy.async.global) before
// it arrives; thread 0 of each CTA arrives with a device-scope fence on one monotonic
// counter and spins with acquire loads; the producer fences the async proxy again
// before its next loads. Activations the row phases and the epilogues read were
// written in the same launch by other CTAs, so they are read L2-coherent (ld.cg) or
// through TMA.
//
// What bounds it on an H100: per block 17.8 MB of weights (5.3 us at 3.35 TB/s) and
// 2*T*D*(2*Et + 2*Ec) = 5.4 GFLOP per batch element (5.4 us at 989 TFLOP/s): at B=1
// both are level, above it the tensor cores bound it. What the launch adds against
// 32 x K2 is its grid barriers; what it removes is 32 x 6 launches and their gaps.

#include "wgmma_gemm.cuh"

namespace ffvc {

constexpr int kStreamBN = 128;
constexpr int kStreamGemms = 4;  // g1, r, g3, out
using StreamTile = WgmmaTile<kStreamBN, kEpiActOnly>;
static_assert(WgmmaTile<kStreamBN, kEpiRes>::kSmemBytes == StreamTile::kSmemBytes &&
                  WgmmaTile<kStreamBN, kEpiRes>::kStages == StreamTile::kStages,
              "the four GEMM phases share one ring");

struct StreamWgArgs {
  // the stacked weights, (L, rows, cols) with the layer the batch coordinate
  CUtensorMap t1;   // (L, Et, T): g1's A, 128-row boxes
  CUtensorMap t2;   // (L, T, Et): r's A
  CUtensorMap w1f;  // (L, Ec, D): g3's B (K-major), 128-row boxes
  CUtensorMap w2;   // (L, D, Ec): out's B
  // the activation buffers
  CUtensorMap xn_b;    // xn (B, T, D): g1's B (MN-major), 64 x 64 boxes
  CUtensorMap xn_a;    // xn (B*T, D): g3's A, 128-row boxes
  CUtensorMap g1;      // g1 (B, Et, D): g1's C and r's B, 64-row boxes both
  CUtensorMap r;       // r (B, T, D): r's C
  CUtensorMap g3_c;    // g3 (B*T, Ec): g3's C
  CUtensorMap g3_a;    // g3 (B*T, Ec): out's A
  CUtensorMap act[2];  // out, buf (B*T, D): out's C, the blocks alternating
  const bf16* x;
  bf16* act_ptr[2];  // out, buf
  bf16* r_ptr;
  bf16* xn_ptr;
  bf16* g1_ptr;
  bf16* g3_ptr;
  float* partial;  // split-K partials, f32
  unsigned int* barrier;  // zeroed before the launch
  const float* ln1_w;  // (L, D)
  const float* ln1_b;  // (L, D)
  const float* t1b;    // (L, Et)
  const float* t2b;    // (L, T)
  const float* b1f;    // (L, Ec)
  const float* b2;     // (L, D)
  int batch, layers, t, d, et, ec;
  int splits[kStreamGemms], k_split[kStreamGemms];
};

__device__ __forceinline__ unsigned int ld_acquire_gpu(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// All 384 threads of the CTA, from the producer's and the consumers' code alike (a
// named barrier without .aligned: the producer warp's lanes may arrive apart).
__device__ __forceinline__ void cta_sync() { asm volatile("barrier.sync 3, 384;\n" ::: "memory"); }

// Grid-wide barrier on one monotonic counter: the k-th barrier of the launch waits
// until every CTA has arrived k times. Thread 0 arrives with a release
// (fence.acq_rel.gpu and a relaxed add: the CTA's writes, ordered by the CTA barrier
// before it, are made visible first) and polls with acquire loads, so what other CTAs
// wrote before arriving is seen after (the pattern of CUTLASS's GenericBarrier).
__device__ __forceinline__ void grid_sync(const StreamWgArgs& s, unsigned int& passed) {
  ++passed;
  cta_sync();
  if (threadIdx.x == 0) {
    asm volatile(
        "fence.acq_rel.gpu;\n"
        "red.relaxed.gpu.global.add.u32 [%0], 1;\n" ::"l"(s.barrier)
        : "memory");
    while (ld_acquire_gpu(s.barrier) < passed * gridDim.x) {
    }
  }
  cta_sync();
}

// Eight adjacent outputs of a split GEMM, at flat index e of its (batch, M, N) output
// (row `row` of M, columns col .. col + 7; N a multiple of 8): the partials added in
// split order, then the tile epilogue's arithmetic, v += bias (per row, the token
// GEMMs, or per column); C = round(gelu(v)) (kEpiActOnly) or round(round(v) + res)
// (kEpiRes, res as C).
template <int kEpi, bool kRowBias>
__device__ __forceinline__ uint4 split_sum8(const WgmmaPhase& p, long long e, int row, int col) {
  const long long total = static_cast<long long>(p.m) * p.n * p.batch;
  float v[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 w = __ldcg(reinterpret_cast<const float4*>(p.partial + e) + h);
    v[4 * h] = w.x;
    v[4 * h + 1] = w.y;
    v[4 * h + 2] = w.z;
    v[4 * h + 3] = w.w;
  }
  for (int sp = 1; sp < p.splits; ++sp)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 w = __ldcg(reinterpret_cast<const float4*>(p.partial + sp * total + e) + h);
      v[4 * h] += w.x;
      v[4 * h + 1] += w.y;
      v[4 * h + 2] += w.z;
      v[4 * h + 3] += w.w;
    }
  [[maybe_unused]] uint4 r8;
  if constexpr (kEpi == kEpiRes) r8 = __ldcg(reinterpret_cast<const uint4*>(p.res + e));
  uint4 o;
  bf16* ov = reinterpret_cast<bf16*>(&o);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float x = v[j] + (kRowBias ? p.bias[row] : p.bias[col + j]);
    if constexpr (kEpi == kEpiActOnly)
      ov[j] = from_f<bf16>(gelu_f(x));
    else
      ov[j] = from_f<bf16>(to_f(from_f<bf16>(x)) + to_f(reinterpret_cast<const bf16*>(&r8)[j]));
  }
  return o;
}

// The split-K sum of one GEMM phase into C (batch, M, N) on the consumer threads, 8
// adjacent outputs a thread (split_sum8).
template <int kEpi, bool kRowBias>
__device__ __forceinline__ void reduce_partials(const WgmmaPhase& p, bf16* c) {
  const long long mn = static_cast<long long>(p.m) * p.n, groups = mn * p.batch / 8;
  for (long long q = blockIdx.x * 256LL + (threadIdx.x - 128); q < groups;
       q += gridDim.x * 256LL) {
    const long long e = q * 8, rem = e % mn;
    *reinterpret_cast<uint4*>(c + e) = split_sum8<kEpi, kRowBias>(
        p, e, static_cast<int>(rem / p.n), static_cast<int>(rem % p.n));
  }
}

// Component j (a constant after unrolling) of v.
__device__ __forceinline__ float lane4(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The 256 consumer threads of the CTA (a named barrier the producer does not join).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("barrier.sync 4, 256;\n" ::: "memory");
}

// LayerNorm of `rows` rows of d (a multiple of 8) on the consumer warps, 16-byte loads
// and stores: t = x*inv - mean*inv and out = t*scale + bias (LN1, the forward's order),
// or, `centered` without scale, t = (x - mean)*inv (LN-hat, `_kernel_ln_hat`); f32
// statistics, var = E[x^2] - E[x]^2 clamped at 0, eps 1e-5. A row takes wpr warps of
// one CTA, as many (a power of two up to 8) as the grid's consumer warps allow (4 for
// the 256 rows of B=1), each a stripe of its 8-column chunks; their sums are added
// through shared memory in warp order, so the statistics are the same on every run.
// With `summed`, `sum` is the split residual GEMM that made x (r, per-row bias, or out,
// per-column): each chunk of x is first made from its partials (split_sum8) and
// written, then normalised: the GEMM's ordered sum without a phase and a grid barrier
// of its own.
template <bool kRowBias>
__device__ __forceinline__ void ln_rows(bf16* x, const float* scale, const float* bias,
                                        bf16* out, int rows, int d, bool centered,
                                        const WgmmaPhase& sum, bool summed) {
  __shared__ float red[16];
  const int warp = (threadIdx.x - 128) / 32, lane = threadIdx.x % 32;
  const int chunks = d / 8;
  int wpr = 1;
  while (wpr < 8 && rows * wpr * 2 <= static_cast<int>(gridDim.x) * 8) wpr *= 2;
  const int groups = 8 / wpr, part = warp % wpr;
  const int first = part * 32 + lane, stride = 32 * wpr;
  for (int rb = blockIdx.x; rb < (rows + groups - 1) / groups; rb += gridDim.x) {
    const int row = rb * groups + warp / wpr;
    const bool active = row < rows;
    uint4* xr = reinterpret_cast<uint4*>(x + static_cast<long long>(row) * d);
    float s = 0.f, ss = 0.f;
    for (int c = first; active && c < chunks; c += stride) {
      uint4 u;
      if (summed) {  // this lane's own chunks: its reads below see its writes
        u = split_sum8<kEpiRes, kRowBias>(sum, static_cast<long long>(row) * d + 8 * c,
                                          row % sum.m, 8 * c);
        xr[c] = u;
      } else {
        u = __ldcg(xr + c);
      }
      const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float f = to_f(v[j]);
        s += f;
        ss = fmaf(f, f, ss);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    if (lane == 0) {
      red[2 * warp] = s;
      red[2 * warp + 1] = ss;
    }
    consumer_sync();
    s = 0.f;
    ss = 0.f;
    for (int w = warp - part; w < warp - part + wpr; ++w) {
      s += red[2 * w];
      ss += red[2 * w + 1];
    }
    consumer_sync();  // every warp has read `red` before the next rows write it
    const float mean = s / d;
    const float inv = rsqrtf(fmaxf(ss / d - mean * mean, 0.f) + 1e-5f);
    const float mean_inv = mean * inv;
    uint4* orow = reinterpret_cast<uint4*>(out + static_cast<long long>(row) * d);
    for (int c = first; active && c < chunks; c += stride) {
      const uint4 u = __ldcg(xr + c);
      const bf16* v = reinterpret_cast<const bf16*>(&u);
      float4 sc[2] = {}, bi[2] = {};
      if (scale) {
        sc[0] = reinterpret_cast<const float4*>(scale + 8 * c)[0];
        sc[1] = reinterpret_cast<const float4*>(scale + 8 * c)[1];
        bi[0] = reinterpret_cast<const float4*>(bias + 8 * c)[0];
        bi[1] = reinterpret_cast<const float4*>(bias + 8 * c)[1];
      }
      uint4 o;
      bf16* ov = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float f = to_f(v[j]);
        const float t = centered ? (f - mean) * inv : f * inv - mean_inv;
        ov[j] = from_f<bf16>(scale ? fmaf(t, lane4(sc[j / 4], j % 4), lane4(bi[j / 4], j % 4)) : t);
      }
      orow[c] = o;
    }
  }
}

// GEMM phase G of block l: 0 g1, 1 r (residual cur), 2 g3, 3 out (into act[nx]).
__device__ __forceinline__ WgmmaPhase stream_phase(const StreamWgArgs& s, int g, int l,
                                                   const bf16* cur, int nx) {
  WgmmaPhase p{};  // zeroed: no aux plane, res, mul or shared-operand coordinate
  const int b = s.batch;
  p.act = kActGelu;
  p.splits = s.splits[g];
  p.k_split = s.k_split[g];
  p.partial = s.partial;
  if (g < 2) {  // the token GEMMs: batched over B, the stacked weight shared at layer l
    p.batch = b;
    p.a_batched = 0;
    p.b_batched = b > 1;
    p.za = l;
    p.n = s.d;
    if (g == 0) {
      p.map_a = &s.t1;
      p.map_b = &s.xn_b;
      p.map_c = &s.g1;
      p.m = s.et;
      p.k = s.t;
      p.bias = s.t1b + static_cast<long long>(l) * s.et;
    } else {
      p.map_a = &s.t2;
      p.map_b = &s.g1;
      p.map_c = &s.r;
      p.m = s.t;
      p.k = s.et;
      p.bias = s.t2b + static_cast<long long>(l) * s.t;
      p.res = cur;
    }
    p.sc = static_cast<long long>(p.m) * p.n;
  } else {  // the channel GEMMs: the batch folded into M = B*T rows
    p.batch = 1;
    p.zb = l;
    p.m = b * s.t;
    if (g == 2) {
      p.map_a = &s.xn_a;
      p.map_b = &s.w1f;
      p.map_c = &s.g3_c;
      p.n = s.ec;
      p.k = s.d;
      p.bias = s.b1f + static_cast<long long>(l) * s.ec;
    } else {
      p.map_a = &s.g3_a;
      p.map_b = &s.w2;
      p.map_c = &s.act[nx];
      p.n = s.d;
      p.k = s.ec;
      p.bias = s.b2 + static_cast<long long>(l) * s.d;
      p.res = s.r_ptr;
    }
  }
  return p;
}

// One GEMM phase (template G as stream_phase's g) from the producer's or the
// consumers' side, then the barrier and, where an activation GEMM (g1, g3) split K,
// the ordered sum into `c` and another barrier. A split residual GEMM (r, out) leaves
// its partials to the next row phase (ln_rows' `sum`).
template <int G, bool kProducer>
__device__ __forceinline__ void stream_gemm(const StreamWgArgs& s, const WgSmem<StreamTile>& sm,
                                            WgRing& ring, unsigned int& passed, int l,
                                            const bf16* cur, int nx, bf16* c) {
  constexpr int kTransB = G < 2;  // the token GEMMs read xn and g1 MN-major
  constexpr int kEpi = G % 2 == 0 ? kEpiActOnly : kEpiRes;
  constexpr bool kRowBias = G < 2;
  const WgmmaPhase p = stream_phase(s, G, l, cur, nx);
  if constexpr (kProducer) {
    if (threadIdx.x == 0) {
      fence_proxy_async_global();  // the last phase's generic writes, before these loads
      wg_produce<StreamTile, kStreamBN, 0, kTransB, true>(p, sm, ring);
    }
  } else {
    wg_consume<StreamTile, kStreamBN, 0, kTransB, kEpi, kRowBias, true>(p, sm, ring);
    if (threadIdx.x % 128 == 0) {  // this warpgroup's stores, complete
      bulk_wait<false>();
      fence_proxy_async_global();
    }
  }
  grid_sync(s, passed);
  if (kEpi == kEpiActOnly && p.splits > 1) {
    if constexpr (!kProducer) {
      reduce_partials<kEpi, kRowBias>(p, c);
      fence_proxy_async_global();
    }
    grid_sync(s, passed);
  }
}

// The whole stack from one side: the producer warpgroup (kProducer) or the consumers.
// Both sides pass the same grid barriers in the same order.
template <bool kProducer>
__device__ __forceinline__ void run_stack(const StreamWgArgs& s, const WgSmem<StreamTile>& sm) {
  WgRing ring;
  unsigned int passed = 0;  // grid barriers passed
  const int rows = s.batch * s.t;
  int prev = 0;  // the activation buffer the previous block wrote
  for (int l = 0; l < s.layers; ++l) {
    // the last block writes `out`; earlier ones alternate so that none overwrites the
    // activation it reads
    const int nx = (s.layers - 1 - l) % 2 == 0 ? 0 : 1;
    const bf16* cur = l == 0 ? s.x : s.act_ptr[prev];
    // (a) xn = LN1(cur), cur first summed from the previous block's split out
    if constexpr (!kProducer) {
      const float* ln1_w = s.ln1_w + static_cast<long long>(l) * s.d;
      const float* ln1_b = s.ln1_b + static_cast<long long>(l) * s.d;
      // block 0 reads x; a later one the previous block's output, summed first
      // where that block's out split
      const WgmmaPhase out = stream_phase(s, 3, l > 0 ? l - 1 : 0, nullptr, prev);
      ln_rows<false>(l == 0 ? const_cast<bf16*>(s.x) : s.act_ptr[prev], ln1_w, ln1_b,
                     s.xn_ptr, rows, s.d, false, out, l > 0 && out.splits > 1);
      fence_proxy_async_global();
    }
    grid_sync(s, passed);
    stream_gemm<0, kProducer>(s, sm, ring, passed, l, cur, nx, s.g1_ptr);  // (b)
    stream_gemm<1, kProducer>(s, sm, ring, passed, l, cur, nx, s.r_ptr);   // (c)
    // (d) xn = LN-hat(r), r first summed where it split
    if constexpr (!kProducer) {
      const WgmmaPhase r = stream_phase(s, 1, l, cur, nx);
      ln_rows<true>(s.r_ptr, nullptr, nullptr, s.xn_ptr, rows, s.d, true, r, r.splits > 1);
      fence_proxy_async_global();
    }
    grid_sync(s, passed);
    stream_gemm<2, kProducer>(s, sm, ring, passed, l, cur, nx, s.g3_ptr);  // (e)
    stream_gemm<3, kProducer>(s, sm, ring, passed, l, cur, nx, nullptr);   // (f)
    prev = nx;
  }
  // the last block's split out, summed into `out` (the launch's end orders it)
  if constexpr (!kProducer) {
    const WgmmaPhase out = stream_phase(s, 3, s.layers - 1, nullptr, prev);
    if (out.splits > 1) reduce_partials<kEpiRes, false>(out, s.act_ptr[prev]);
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
    mixer_stream_wgmma_kernel(const __grid_constant__ StreamWgArgs s) {
  extern __shared__ unsigned char stream_smem_raw[];
  const WgSmem<StreamTile> sm(stream_smem_raw);
  if (threadIdx.x == 0) sm.init();
  __syncthreads();
  if (threadIdx.x < 128) {  // producer: registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    run_stack<true>(s, sm);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    run_stack<false>(s, sm);
  }
}

static int set_smem_attribute() {
  static bool done = false;  // once per process
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(
        mixer_stream_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        StreamTile::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    done = true;
  }
  return 0;
}

}  // namespace ffvc

using namespace ffvc;

// How many CTAs of the kernel one SM holds at once (the grid is this times the SM
// count, so that every CTA is resident).
extern "C" int ffvc_mixer_stream_wgmma_blocks_per_sm(int* out) {
  const int e = set_smem_attribute();
  if (e) return e;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, mixer_stream_wgmma_kernel, kWgThreads, StreamTile::kSmemBytes));
}

// The L blocks over x (B, T, D) bf16 in one cooperative launch of `grid` CTAs. out,
// buf, r, xn (B, T, D), g1 (B, Et, D), g3 (B, T, Ec) bf16 workspaces; partial f32,
// large enough for every split GEMM's (splits, batch, M, N); barrier: one counter (the
// launch zeroes it); splits and k_split: the plan of g1, r, g3, out (k_split in K steps
// of 64). Row lengths multiples of 8 and 16-byte-aligned bases (checked by the caller).
extern "C" int ffvc_mixer_stream_wgmma(const void* x, void* out, void* buf, void* r, void* xn,
                                       void* g1, void* g3, float* partial,
                                       unsigned int* barrier, const float* ln1_w,
                                       const float* ln1_b, const void* t1, const float* t1b,
                                       const void* t2, const float* t2b, const void* w1f,
                                       const float* b1f, const void* w2, const float* b2,
                                       int batch, int layers, int t, int d, int et, int ec,
                                       const int* splits, const int* k_split, int grid,
                                       void* stream) {
  StreamWgArgs s{};
  const long long bt = static_cast<long long>(batch) * t;
  const bool ok =
      make_tensor_map(&s.t1, t1, et, t, layers, static_cast<long long>(et) * t, kWgBM) &&
      make_tensor_map(&s.t2, t2, t, et, layers, static_cast<long long>(t) * et, kWgBM) &&
      make_tensor_map(&s.w1f, w1f, ec, d, layers, static_cast<long long>(ec) * d, kStreamBN) &&
      make_tensor_map(&s.w2, w2, d, ec, layers, static_cast<long long>(d) * ec, kStreamBN) &&
      make_tensor_map(&s.xn_b, xn, t, d, batch, static_cast<long long>(t) * d, 64) &&
      make_tensor_map(&s.xn_a, xn, bt, d, 1, 0, kWgBM) &&
      make_tensor_map(&s.g1, g1, et, d, batch, static_cast<long long>(et) * d, 64) &&
      make_tensor_map(&s.r, r, t, d, batch, static_cast<long long>(t) * d, 64) &&
      make_tensor_map(&s.g3_c, g3, bt, ec, 1, 0, 64) &&
      make_tensor_map(&s.g3_a, g3, bt, ec, 1, 0, kWgBM) &&
      make_tensor_map(&s.act[0], out, bt, d, 1, 0, 64) &&
      make_tensor_map(&s.act[1], buf, bt, d, 1, 0, 64);
  if (!ok || batch < 1 || layers < 1) return static_cast<int>(cudaErrorInvalidValue);
  s.x = static_cast<const bf16*>(x);
  s.act_ptr[0] = static_cast<bf16*>(out);
  s.act_ptr[1] = static_cast<bf16*>(buf);
  s.r_ptr = static_cast<bf16*>(r);
  s.xn_ptr = static_cast<bf16*>(xn);
  s.g1_ptr = static_cast<bf16*>(g1);
  s.g3_ptr = static_cast<bf16*>(g3);
  s.partial = partial;
  s.barrier = barrier;
  s.ln1_w = ln1_w;
  s.ln1_b = ln1_b;
  s.t1b = t1b;
  s.t2b = t2b;
  s.b1f = b1f;
  s.b2 = b2;
  s.batch = batch;
  s.layers = layers;
  s.t = t;
  s.d = d;
  s.et = et;
  s.ec = ec;
  for (int g = 0; g < kStreamGemms; ++g) {
    s.splits[g] = splits[g];
    s.k_split[g] = k_split[g];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = static_cast<cudaError_t>(set_smem_attribute());
  if (e == cudaSuccess)
    e = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
  if (e == cudaSuccess) {
    void* args[] = {&s};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&mixer_stream_wgmma_kernel),
                                    dim3(grid), dim3(kWgThreads), args,
                                    StreamTile::kSmemBytes, st);
  }
  const cudaError_t last = cudaGetLastError();  // reported once, by this call
  return static_cast<int>(e != cudaSuccess ? e : last);
}

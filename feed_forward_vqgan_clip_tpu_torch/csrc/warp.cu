// Bilinear projective warp of NHWC images: the forward (K9) and its exact image
// gradient (K10).
//
// Replaces feed_forward_vqgan_clip_tpu/ops/pallas/warp_forward.py `_kernel` and
// `_kernel_pipe` (the same function on a skewed TPU schedule), and
// ops/pallas/warp_adjoint.py `_kernel`. m (B, 3, 3) float32 maps OUTPUT pixels to
// INPUT pixels (row-major, 9 floats per image). The input frame is (h, w), the
// output frame (ho, wo): equal for Af, Pe and Ro, different for the crops
// (`_crop_resize` maps a box of the input onto a cut_size x cut_size output).
// Images and gradients are float32 or bf16: img and grad (B, h, w, C), out and g
// (B, ho, wo, C), C any.
//
//   forward   out[b, q, c]  = sum_taps w(s(q), p) img[b, p, c],  s(q) = m_b(q)
//   adjoint   grad[b, p, c] = sum_q    w(s(q), p) g[b, q, c]
//
// with q over the output frame, p over the input frame, and the 4 bilinear taps of
// grid_sample (zeros padding: a tap outside the input frame reads 0; border
// padding: the sample point is clamped into the input frame, which is
// grid_sample's border padding, so only the edge pixel gets weight there).
//
// `sample_taps` computes s(q) and the tap weights for both kernels, so the adjoint
// is the transpose of the forward as computed. Each product and sum in it rounds on
// its own (__fmul_rn / __fadd_rn are never contracted into an FMA), so the sample
// points are the plain PyTorch version's bit for bit and floor(s) cannot flip
// against it at integer coordinates.
//
// What bounds them on an H100: at the train step's shape (64 crops of 224x224x3
// bf16) each kernel must read one image and write one, 19.3 MB each: 0.0115 ms at
// 3.35 TB/s (with an unpooled 256-px input, 25.2 MB + 19.3 MB: 0.0133 ms). One
// crop is 301 KB, so the taps' reads hit L2.
//   * K9 is a direct gather: one thread per output pixel, all C channels, the 4
//     taps read in bf16/f32 and interpolated in float32 in grid_sample's order
//     (top = v00 (1-wx) + v01 wx, bot likewise, out = top (1-wy) + bot wy). A block
//     holds one output row, so a thread finds its pixel with no division, and it
//     issues a pass's tap loads before their arithmetic. It is not bound by bytes:
//     bf16 and f32 take about the same time. Staging a 32 x 32 output tile's input
//     box in shared memory with 16-byte loads and storing the outputs as 16-byte
//     words was slower on an H100, the box's unpacking and the barriers costing
//     more than the gathers and 2-byte stores they replace (PERF.md §6).
//   * K10 is a gather too, so it needs no atomics and is deterministic: each INPUT
//     pixel p (all C channels) sums w(s(q), p) g[q] over the output pixels q whose
//     sample can reach p, in row-major order of q, in float32, and writes once.
//     Those q are the preimage of p's support box (px-1, px+1) x (py-1, py+1). Along
//     one output row a projective map is monotone in qx wherever its denominator
//     keeps its sign, so per row the q in the preimage form one interval: four
//     linear inequalities in qx, computed in double from m (`BoundRoot`), widened
//     by 1 px (a float sample can disagree with the double one at the ends; an extra
//     q's weight test inside the loop makes it add exactly 0). Where the
//     denominator changes sign along a row, or comes near zero, the whole row is
//     visited.
//   * Interior pixels run in tile blocks of 16 x 16 input pixels. A block computes
//     the taps (x0, y0, wx, wy) of every output pixel its tile's preimage box holds,
//     with their C values of g, once into shared memory, up to kTileCap of them at a
//     time in row-major order, and each thread walks its own rows' intervals there:
//     two divisions a q per block instead of a thread.
//   * Border mode: a sample clamped onto the input frame's edge reaches only the
//     edge pixels, so an edge pixel's support is unbounded on its outer side (sx <
//     1 for px = 0, ...). The edge pixels run in blocks of their own after the
//     tiles, one thread each, over the rows of their support's preimage (bounded by
//     the hull of the output frame's samples, `frame_hull`, where valid; else the
//     whole frame) and per row the exact interval of the clamped strip, computing
//     each visited q's taps themselves. In zeros mode every pixel is a tile pixel.
// For finite g this sums the same q with nonzero weight in the same order, with the
// same arithmetic, as a walk of each pixel's whole preimage bounding box (the design
// before), so the result is the same bits.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4;          // channels accumulated per pass in K10
constexpr float kDenEps = 1e-8f;   // the Pallas kernels' denominator guard
constexpr float kCoordClip = 1e6f; // and their coordinate clip

using ffvc::bf16;
using ffvc::from_f;
using ffvc::to_f;

struct Taps {
  int x0, y0;    // the top-left tap; the others are x0 + 1 and y0 + 1
  float wx, wy;  // the weights of the x0 + 1 and y0 + 1 taps
};

// The sample point s(q) of output pixel (qx, qy) under m, with the TPU kernels'
// guards (|den| < 1e-8 -> +-1e-8, s clipped to +-1e6 so that the float -> int
// conversion is defined; NaN goes to the clip bound), clamped into the frame in
// border mode, and its taps; (h, w) is the input frame.
__device__ __forceinline__ Taps sample_taps(const float* __restrict__ m, int qx, int qy,
                                            int h, int w, bool border) {
  const float fx = static_cast<float>(qx), fy = static_cast<float>(qy);
  float den = __fadd_rn(__fadd_rn(__fmul_rn(m[6], fx), __fmul_rn(m[7], fy)), m[8]);
  if (fabsf(den) < kDenEps) den = den < 0.f ? -kDenEps : kDenEps;
  float sx = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], fx), __fmul_rn(m[1], fy)), m[2]),
                       den);
  float sy = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[3], fx), __fmul_rn(m[4], fy)), m[5]),
                       den);
  sx = fminf(fmaxf(sx, -kCoordClip), kCoordClip);
  sy = fminf(fmaxf(sy, -kCoordClip), kCoordClip);
  if (border) {
    sx = fminf(fmaxf(sx, 0.f), static_cast<float>(w - 1));
    sy = fminf(fmaxf(sy, 0.f), static_cast<float>(h - 1));
  }
  const float x0 = floorf(sx), y0 = floorf(sy);
  return {static_cast<int>(x0), static_cast<int>(y0), __fsub_rn(sx, x0), __fsub_rn(sy, y0)};
}

// K9: block bi * ho + qy holds output row qy of image bi, a thread a pixel (blockDim a
// multiple of 32 that covers the row, at most kThreads, looping past it). kC: the
// channels at compile time (3, the images), or 0 to read c.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
warp_forward_kernel(const T* __restrict__ img, const float* __restrict__ mats,
                    T* __restrict__ out, int h, int w, int ho, int wo, int c, bool border) {
  const int nc = kC ? kC : c;
  const int bi = blockIdx.x / ho, qy = blockIdx.x % ho;
  const float* m = mats + bi * 9;
  const T* base = img + static_cast<long long>(bi) * h * w * nc;
  T* row = out + (static_cast<long long>(bi) * ho + qy) * wo * nc;
  for (int qx = threadIdx.x; qx < wo; qx += blockDim.x) {
    const Taps t = sample_taps(m, qx, qy, h, w, border);
    int x1 = t.x0 + 1, y1 = t.y0 + 1;
    // zeros mode: a tap outside the frame reads 0; border mode: the taps are in the
    // frame but x0 + 1 (y0 + 1) may be one past the edge, at weight 0
    const bool in_x0 = border || (t.x0 >= 0 && t.x0 < w);
    const bool in_x1 = border || (x1 >= 0 && x1 < w);
    const bool in_y0 = border || (t.y0 >= 0 && t.y0 < h);
    const bool in_y1 = border || (y1 >= 0 && y1 < h);
    x1 = min(x1, w - 1);
    y1 = min(y1, h - 1);
    auto tap = [&](bool inside, int x, int y, int ch) -> float {
      return inside ? to_f(base[(y * w + x) * nc + ch]) : 0.f;  // an image < 2^31 elements
    };
    const float ux = __fsub_rn(1.f, t.wx), uy = __fsub_rn(1.f, t.wy);
    T* o = row + qx * nc;
    // a pass of channels: every tap's loads first, then the arithmetic
    constexpr int kPass = kC ? kC : 4;
    for (int c0 = 0; c0 < nc; c0 += kPass) {
      float v[4][kPass];
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the top row's taps, then the bottom row's
        const bool in_y = r ? in_y1 : in_y0;
        const int y = r ? y1 : t.y0;
#pragma unroll
        for (int k = 0; k < kPass; ++k) {
          const bool ok = kC || c0 + k < nc;
          v[2 * r][k] = tap(ok && in_y && in_x0, t.x0, y, c0 + k);
          v[2 * r + 1][k] = tap(ok && in_y && in_x1, x1, y, c0 + k);
        }
      }
#pragma unroll
      for (int k = 0; k < kPass; ++k) {
        if (!kC && c0 + k >= nc) break;
        const float top = __fadd_rn(__fmul_rn(v[0][k], ux), __fmul_rn(v[1][k], t.wx));
        const float bot = __fadd_rn(__fmul_rn(v[2][k], ux), __fmul_rn(v[3][k], t.wx));
        o[c0 + k] = from_f<T>(__fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, t.wy)));
      }
    }
  }
}

// The bounding box of the samples of the whole output frame (ho, wo): the convex
// hull of its corners' images, valid when m's denominator keeps one sign over the frame
// (with margin: rounding cannot flip it, and the 1e-8 guard never acts) and no
// corner maps beyond 1e5 px (so the 1e6 clip never acts). Returns false otherwise.
__device__ bool frame_hull(const float* __restrict__ m, int ho, int wo, double* lo_x,
                           double* hi_x, double* lo_y, double* hi_y) {
  const double cx[4] = {0.0, wo - 1.0, 0.0, wo - 1.0};
  const double cy[4] = {0.0, 0.0, ho - 1.0, ho - 1.0};
  const double scale = fabs((double)m[6]) * (wo - 1) + fabs((double)m[7]) * (ho - 1) +
                       fabs((double)m[8]);
  double den[4];
  for (int k = 0; k < 4; ++k) {
    den[k] = (double)m[6] * cx[k] + (double)m[7] * cy[k] + (double)m[8];
    if (fabs(den[k]) < fmax(1e-4 * scale, 1e-6)) return false;
  }
  for (int k = 1; k < 4; ++k)
    if ((den[k] > 0.0) != (den[0] > 0.0)) return false;
  *lo_x = *lo_y = INFINITY;
  *hi_x = *hi_y = -INFINITY;
  for (int k = 0; k < 4; ++k) {
    const double sx = ((double)m[0] * cx[k] + (double)m[1] * cy[k] + (double)m[2]) / den[k];
    const double sy = ((double)m[3] * cx[k] + (double)m[4] * cy[k] + (double)m[5]) / den[k];
    if (!(fabs(sx) <= 1e5 && fabs(sy) <= 1e5)) return false;
    *lo_x = fmin(*lo_x, sx);
    *hi_x = fmax(*hi_x, sx);
    *lo_y = fmin(*lo_y, sy);
    *hi_y = fmax(*hi_y, sy);
  }
  return true;
}

// The output pixels whose samples can lie in the input box [x0, x1] x [y0, y1]:
// the bounding box of the corners' images under m^-1 (the adjugate: the scale
// drops out of a projective map), widened by 1 px and clipped to the output frame
// (ho, wo), in [*qx0, *qx1] x [*qy0, *qy1] (empty when *qx0 > *qx1). Returns false where
// m^-1's denominator does not keep one strict sign over the corners: the horizon
// crosses the box, and the caller visits the whole frame.
__device__ bool preimage_box(const float* __restrict__ mf, double x0, double x1, double y0,
                             double y1, int ho, int wo, int* qx0, int* qx1, int* qy0,
                             int* qy1) {
  double m[9];
  for (int k = 0; k < 9; ++k) m[k] = mf[k];
  const double a[9] = {
      m[4] * m[8] - m[5] * m[7], m[2] * m[7] - m[1] * m[8], m[1] * m[5] - m[2] * m[4],
      m[5] * m[6] - m[3] * m[8], m[0] * m[8] - m[2] * m[6], m[2] * m[3] - m[0] * m[5],
      m[3] * m[7] - m[4] * m[6], m[1] * m[6] - m[0] * m[7], m[0] * m[4] - m[1] * m[3]};
  const double sx[4] = {x0, x1, x0, x1};
  const double sy[4] = {y0, y0, y1, y1};
  double lo_x = INFINITY, hi_x = -INFINITY, lo_y = INFINITY, hi_y = -INFINITY;
  bool pos = false, neg = false;
  for (int k = 0; k < 4; ++k) {
    const double den = a[6] * sx[k] + a[7] * sy[k] + a[8];
    pos = pos || den > 0.0;
    neg = neg || den < 0.0;
    if (!(den > 0.0 || den < 0.0)) return false;  // zero or NaN
    const double qx = (a[0] * sx[k] + a[1] * sy[k] + a[2]) / den;
    const double qy = (a[3] * sx[k] + a[4] * sy[k] + a[5]) / den;
    if (!(isfinite(qx) && isfinite(qy))) return false;
    lo_x = fmin(lo_x, qx);
    hi_x = fmax(hi_x, qx);
    lo_y = fmin(lo_y, qy);
    hi_y = fmax(hi_y, qy);
  }
  if (pos && neg) return false;
  *qx0 = static_cast<int>(fmin(fmax(floor(lo_x) - 1.0, 0.0), (double)wo));
  *qx1 = static_cast<int>(fmin(fmax(ceil(hi_x) + 1.0, -1.0), wo - 1.0));
  *qy0 = static_cast<int>(fmin(fmax(floor(lo_y) - 1.0, 0.0), (double)ho));
  *qy1 = static_cast<int>(fmin(fmax(ceil(hi_y) + 1.0, -1.0), ho - 1.0));
  return true;
}

// The preimage of an input box lo_x < sx < hi_x, lo_y < sy < hi_y under m, row by
// row. Each bound b of sx = (m0 qx + m1 qy + m2) / D, D = m6 qx + m7 qy + m8, is a
// linear inequality in qx once multiplied by D's sign s on the row: s (k qx + w(qy))
// > 0 (a lower bound on sx) or < 0 (an upper one), k = m0 - b m6, w(qy) = (m1 - b
// m7) qy + m2 - b m8; likewise for sy with m3, m4, m5. Where k != 0 its root r(qy) =
// -w(qy) / k = u + v qy bounds qx: from below where s k > 0 for a lower bound (s k <
// 0 for an upper one), else from above. Where k == 0, w(qy)'s sign alone keeps or
// drops the row. A bound may be infinite: the clamped side of a border edge pixel.
struct BoundRoot {
  double u, v;  // the root's coefficients; where k == 0, w's (w0, w1)
  int kind;     // sign of k; 0 where k == 0; 2 for an infinite bound (no constraint)
};

// Bound b on axis 0 (sx) or 1 (sy).
__device__ BoundRoot bound_root(const float* __restrict__ m, int axis, double b) {
  if (!isfinite(b)) return {0.0, 0.0, 2};
  const int r = axis ? 3 : 0;  // the numerator's row of m
  const double k = m[r] - b * m[6], w1 = m[r + 1] - b * m[7], w0 = m[r + 2] - b * m[8];
  if (k == 0.0) return {w0, w1, 0};
  return {-w0 / k, -w1 / k, k > 0.0 ? 1 : -1};
}

// D's margin from zero, as frame_hull's: rounding cannot flip its sign there, and the
// 1e-8 guard never acts; m not finite: no row passes it.
__device__ double denominator_margin(const float* __restrict__ m, int ho, int wo) {
  for (int i = 0; i < 9; ++i)
    if (!isfinite(m[i])) return INFINITY;
  return fmax(1e-4 * (fabs((double)m[6]) * (wo - 1) + fabs((double)m[7]) * (ho - 1) +
                      fabs((double)m[8])),
              1e-6);
}

// D's sign along row qy over [c0, c1], or 0 where it changes or comes within the
// margin of zero there (the row is then walked whole).
__device__ int row_sign(const float* __restrict__ m, double margin, int qy, int c0, int c1) {
  const double e = (double)m[7] * qy + (double)m[8];
  const double dl = (double)m[6] * c0 + e, dr = (double)m[6] * c1 + e;
  if (!(fabs(dl) >= margin && fabs(dr) >= margin && (dl > 0.0) == (dr > 0.0))) return 0;
  return dl > 0.0 ? 1 : -1;
}

// The qx in [c0, c1] of a row of D's sign s (nonzero) whose sample lies between a
// lower and an upper bound on one axis, widened by 1 px on each side (a float sample
// can disagree with the double one at the ends): [*q0, *q1], empty when *q0 > *q1.
__device__ void axis_interval(const BoundRoot& lower, const BoundRoot& upper, int s, int qy,
                              int c0, int c1, int* q0, int* q1) {
  double lo = -INFINITY, hi = INFINITY;
  bool none = false;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const BoundRoot& br = side ? upper : lower;
    const double v = br.u + br.v * qy;
    if (br.kind == 1 || br.kind == -1) {
      if ((br.kind * s > 0) != (side == 1))
        lo = fmax(lo, v);
      else
        hi = fmin(hi, v);
    } else if (br.kind == 0) {
      none = none || !(side ? s * v < 0.0 : s * v > 0.0);
    }
  }
  *q0 = c0;
  *q1 = c1;
  // qx > lo -> qx >= floor(lo) + 1, widened: floor(lo); qx < hi -> qx <= ceil(hi)
  if (lo > c0) *q0 = static_cast<int>(fmin(floor(lo), c1 + 1.0));
  if (hi < c1) *q1 = static_cast<int>(fmax(ceil(hi), c0 - 1.0));
  if (none) *q0 = c0 + 1, *q1 = c0;
}

// Adds sample q's share of g to p's sums: the taps that are p are x0 at weight 1 -
// wx, x0 + 1 at wx (in border mode clamped onto the edge, where its weight is 0),
// the same in y. gq: q's C values from channel c0 on, nc of them.
template <typename G>
__device__ __forceinline__ void add_sample(const Taps& t, int px, int py, int h, int w,
                                           bool border, const G& gq, int nc, float* acc) {
  const int tx1 = border ? min(t.x0 + 1, w - 1) : t.x0 + 1;
  const int ty1 = border ? min(t.y0 + 1, h - 1) : t.y0 + 1;
  if ((t.x0 != px && tx1 != px) || (t.y0 != py && ty1 != py)) return;
  float ax = 0.f, ay = 0.f;
  if (t.x0 == px) ax = __fsub_rn(1.f, t.wx);
  if (tx1 == px) ax = __fadd_rn(ax, t.wx);
  if (t.y0 == py) ay = __fsub_rn(1.f, t.wy);
  if (ty1 == py) ay = __fadd_rn(ay, t.wy);
  const float wgt = __fmul_rn(ay, ax);
#pragma unroll
  for (int k = 0; k < kChunk; ++k)
    if (k < nc) acc[k] = fmaf(wgt, gq(k), acc[k]);
}

constexpr int kTile = 16;       // a tile block's input pixels a side (kThreads of them)
constexpr int kTileCap = 1152;  // output pixels whose taps a tile block holds at once
constexpr int kRowCap = 64;     // output rows of a batch: the interval table's height

// One tile block: the tile's input pixels (in border mode not those on the frame's
// edge) as one thread each. The block's output box is the preimage box of the tile's
// support; its taps and g values are staged in batches of whole rows (of parts of one
// row where a row exceeds kTileCap), in row-major order. The per-row intervals are
// shared too: pixel (px, py)'s interval in row qy is the intersection of the x bounds'
// interval, the same for every pixel of column px, and the y bounds', the same for
// every pixel of row py, so the block computes 2 x 16 of them a row into a table
// (from the 2 x 18 bounds' roots, once a tile) and each thread reads its two.
template <typename T>
__device__ void adjoint_tile(const T* __restrict__ g, const float* __restrict__ mats,
                             T* __restrict__ grad, int h, int w, int ho, int wo, int c,
                             bool border, int tile) {
  __shared__ int2 s_xy[kTileCap];
  __shared__ float2 s_w[kTileCap];
  __shared__ float4 s_g[kTileCap];
  __shared__ short s_lo[2][kRowCap][kTile], s_hi[2][kRowCap][kTile];  // [axis][row][pixel]
  __shared__ BoundRoot s_root[2][kTile + 2];  // [axis][bound b = t0 - 1 + j]
  __shared__ double s_margin;
  __shared__ int s_box[4];
  const int tiles_x = (w + kTile - 1) / kTile, tiles_y = (h + kTile - 1) / kTile;
  const int bi = tile / (tiles_x * tiles_y), r = tile % (tiles_x * tiles_y);
  const int tx0 = r % tiles_x * kTile, ty0 = r / tiles_x * kTile;
  const int ix = threadIdx.x % kTile, iy = threadIdx.x / kTile;
  const int px = tx0 + ix, py = ty0 + iy;
  const bool edge = px == 0 || px == w - 1 || py == 0 || py == h - 1;
  const bool active = px < w && py < h && !(border && edge);
  const float* m = mats + bi * 9;
  if (threadIdx.x == 0) {
    int b[4] = {0, wo - 1, 0, ho - 1};  // the whole output frame where the horizon crosses
    if (!preimage_box(m, tx0 - 1.0, min(tx0 + kTile, w) + 0.0, ty0 - 1.0,
                      min(ty0 + kTile, h) + 0.0, ho, wo, &b[0], &b[1], &b[2], &b[3])) {
      b[0] = 0, b[1] = wo - 1, b[2] = 0, b[3] = ho - 1;
    }
    for (int i = 0; i < 4; ++i) s_box[i] = b[i];
    s_margin = denominator_margin(m, ho, wo);
  } else if (threadIdx.x <= 2 * (kTile + 2)) {
    // bound j of an axis: b = t0 - 1 + j (pixel t0 + i has bounds j = i and i + 2)
    const int axis = (threadIdx.x - 1) / (kTile + 2), j = (threadIdx.x - 1) % (kTile + 2);
    s_root[axis][j] = bound_root(m, axis, (axis ? ty0 : tx0) - 1.0 + j);
  }
  __syncthreads();
  const int qx0 = s_box[0], qx1 = s_box[1], qy0 = s_box[2];
  const int bw = max(qx1 - qx0 + 1, 0);
  const int total = bw * max(s_box[3] - qy0 + 1, 0);
  // a batch: whole rows while a row fits, at most kRowCap of them
  const int batch = bw <= kTileCap ? min(kTileCap / max(bw, 1), kRowCap) * bw : kTileCap;
  const T* gb = g + static_cast<long long>(bi) * ho * wo * c;
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    const int nc = min(kChunk, c - c0);
    float acc[kChunk] = {0.f, 0.f, 0.f, 0.f};
    for (int start = 0; start < total; start += batch) {
      const int n = min(batch, total - start);
      const int row0 = start / bw, rows = (start + n - 1) / bw - row0 + 1;
      __syncthreads();  // every thread is done with the previous batch
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int qy = qy0 + (start + i) / bw, qx = qx0 + (start + i) % bw;
        const Taps t = sample_taps(m, qx, qy, h, w, border);
        s_xy[i] = make_int2(t.x0, t.y0);
        s_w[i] = make_float2(t.wx, t.wy);
        const T* gq = gb + (static_cast<long long>(qy) * wo + qx) * c + c0;
        float v[kChunk] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          if (k < nc) v[k] = to_f(gq[k]);
        s_g[i] = make_float4(v[0], v[1], v[2], v[3]);
      }
      // the interval table: per row of the batch, axis and pixel offset, the qx whose
      // samples can lie between the pixel's two bounds on that axis, within [qx0, qx1]
      for (int i = threadIdx.x; i < rows * 2 * kTile; i += kThreads) {
        const int rr = i / (2 * kTile), axis = i % (2 * kTile) / kTile, o = i % kTile;
        const int qy = qy0 + row0 + rr, s = row_sign(m, s_margin, qy, qx0, qx1);
        int lo_q = qx0, hi_q = qx1;
        if (s)
          axis_interval(s_root[axis][o], s_root[axis][o + 2], s, qy, qx0, qx1, &lo_q, &hi_q);
        s_lo[axis][rr][o] = static_cast<short>(lo_q);
        s_hi[axis][rr][o] = static_cast<short>(hi_q);
      }
      __syncthreads();
      if (!active) continue;
      for (int rr = 0; rr < rows; ++rr) {
        const int row = row0 + rr;
        // this pixel's interval of the row, and the batch's part of the row
        const int a = max(max(s_lo[0][rr][ix], s_lo[1][rr][iy]),
                          qx0 + max(start - row * bw, 0));
        const int z = min(min(s_hi[0][rr][ix], s_hi[1][rr][iy]),
                          qx0 + min(start + n - 1 - row * bw, bw - 1));
        for (int qx = a; qx <= z; ++qx) {
          const int i = row * bw + qx - qx0 - start;
          const int2 xy = s_xy[i];
          const float2 wt = s_w[i];
          const float4 gv = s_g[i];
          add_sample(Taps{xy.x, xy.y, wt.x, wt.y}, px, py, h, w, border,
                     [&](int k) { return k == 0 ? gv.x : k == 1 ? gv.y : k == 2 ? gv.z : gv.w; },
                     nc, acc);
        }
      }
    }
    if (active) {
      T* out = grad + ((static_cast<long long>(bi) * h + py) * w + px) * c;
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (k < nc) out[c0 + k] = from_f<T>(acc[k]);
    }
  }
}

// One edge pixel of the input frame in border mode: e = 0 .. h w - (h-2)(w-2) - 1 of
// image bi (top row, bottom row, then the left and right ends of the rows between).
// Its support is unbounded on the frame's outer side(s); the rows to walk are those of
// the preimage box of its support cut at the hull of the output frame's samples.
template <typename T>
__device__ void adjoint_edge_pixel(const T* __restrict__ g, const float* __restrict__ mats,
                                   T* __restrict__ grad, int h, int w, int ho, int wo, int c,
                                   int bi, int e) {
  int px, py;
  if (e < w) {
    py = 0;
    px = e;
  } else if (e < 2 * w) {
    py = h - 1;
    px = e - w;
  } else {
    py = 1 + (e - 2 * w) / 2;
    px = (e - 2 * w) % 2 ? w - 1 : 0;
  }
  const float* m = mats + bi * 9;
  const double lo_x = px == 0 ? -INFINITY : px - 1.0, hi_x = px == w - 1 ? INFINITY : px + 1.0;
  const double lo_y = py == 0 ? -INFINITY : py - 1.0, hi_y = py == h - 1 ? INFINITY : py + 1.0;
  int qx0 = 0, qx1 = wo - 1, qy0 = 0, qy1 = ho - 1;
  double hx0, hx1, hy0, hy1;
  if (frame_hull(m, ho, wo, &hx0, &hx1, &hy0, &hy1) &&
      !preimage_box(m, fmax(lo_x, hx0 - 1.0), fmin(hi_x, hx1 + 1.0), fmax(lo_y, hy0 - 1.0),
                    fmin(hi_y, hy1 + 1.0), ho, wo, &qx0, &qx1, &qy0, &qy1)) {
    qx0 = 0, qx1 = wo - 1, qy0 = 0, qy1 = ho - 1;
  }
  const BoundRoot bx0 = bound_root(m, 0, lo_x), bx1 = bound_root(m, 0, hi_x);
  const BoundRoot by0 = bound_root(m, 1, lo_y), by1 = bound_root(m, 1, hi_y);
  const double margin = denominator_margin(m, ho, wo);
  const T* gb = g + static_cast<long long>(bi) * ho * wo * c;
  T* out = grad + (static_cast<long long>(bi) * h * w + static_cast<long long>(py) * w + px) * c;
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    const int nc = min(kChunk, c - c0);
    float acc[kChunk] = {0.f, 0.f, 0.f, 0.f};
    for (int qy = qy0; qy <= qy1; ++qy) {
      int a = qx0, z = qx1;
      const int s = row_sign(m, margin, qy, qx0, qx1);
      if (s) {
        int ay, zy;
        axis_interval(bx0, bx1, s, qy, qx0, qx1, &a, &z);
        axis_interval(by0, by1, s, qy, qx0, qx1, &ay, &zy);
        a = max(a, ay), z = min(z, zy);
      }
      for (int qx = a; qx <= z; ++qx) {
        const T* gq = gb + (static_cast<long long>(qy) * wo + qx) * c + c0;
        add_sample(sample_taps(m, qx, qy, h, w, true), px, py, h, w, true,
                   [&](int k) { return to_f(gq[k]); }, nc, acc);
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (k < nc) out[c0 + k] = from_f<T>(acc[k]);
  }
}

// Blocks [0, b * tiles) are tile blocks; in border mode the blocks after them hold
// the edge pixels, kThreads a block, image by image.
template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_adjoint_kernel(const T* __restrict__ g, const float* __restrict__ mats,
                    T* __restrict__ grad, int b, int h, int w, int ho, int wo, int c,
                    bool border) {
  const int tiles = b * ((w + kTile - 1) / kTile) * ((h + kTile - 1) / kTile);
  if (static_cast<int>(blockIdx.x) < tiles) {
    adjoint_tile(g, mats, grad, h, w, ho, wo, c, border, blockIdx.x);
    return;
  }
  const long long n_edge = static_cast<long long>(h) * w - max(h - 2, 0) * max(w - 2, 0);
  const long long i = (blockIdx.x - tiles) * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= b * n_edge) return;
  adjoint_edge_pixel(g, mats, grad, h, w, ho, wo, c, static_cast<int>(i / n_edge),
                     static_cast<int>(i % n_edge));
}

template <typename T>
int launch(bool adjoint, const void* src, const float* mats, void* dst, int b, int h, int w,
           int ho, int wo, int c, bool border, cudaStream_t s) {
  if (adjoint) {
    // the tile blocks, then (border mode) a thread per edge pixel
    const long long tiles =
        static_cast<long long>(b) * ((w + kTile - 1) / kTile) * ((h + kTile - 1) / kTile);
    const long long n_edge =
        border ? static_cast<long long>(b) * (h * w - max(h - 2, 0) * max(w - 2, 0)) : 0;
    const unsigned blocks = static_cast<unsigned>(tiles + (n_edge + kThreads - 1) / kThreads);
    warp_adjoint_kernel<T><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(src), mats, static_cast<T*>(dst), b, h, w, ho, wo, c, border);
    FFVC_RETURN_LAST_ERROR();
  }
  // a block an output row
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(b) * ho);
  const int threads = min(kThreads, (wo + 31) / 32 * 32);
  const T* img = static_cast<const T*>(src);
  T* out = static_cast<T*>(dst);
  if (c == 3)
    warp_forward_kernel<T, 3><<<blocks, threads, 0, s>>>(img, mats, out, h, w, ho, wo, c, border);
  else
    warp_forward_kernel<T, 0><<<blocks, threads, 0, s>>>(img, mats, out, h, w, ho, wo, c, border);
  FFVC_RETURN_LAST_ERROR();
}

int dispatch(bool adjoint, const void* src, const float* mats, void* dst, int b, int h, int w,
             int ho, int wo, int c, int border, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // K9 indexes one image of either frame with 32-bit offsets
  if (!adjoint && (static_cast<long long>(h) * w * c >= (1LL << 31) ||
                   static_cast<long long>(ho) * wo * c >= (1LL << 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == ffvc::kBF16)
    return launch<bf16>(adjoint, src, mats, dst, b, h, w, ho, wo, c, border != 0, s);
  return launch<float>(adjoint, src, mats, dst, b, h, w, ho, wo, c, border != 0, s);
}

}  // namespace

// img (B, h, w, C), mats (B, 9) float32 -> out (B, ho, wo, C); border 0 = zeros padding.
extern "C" int ffvc_warp_forward(const void* img, const float* mats, void* out, int b, int h,
                                 int w, int ho, int wo, int c, int border, int dtype,
                                 void* stream) {
  return dispatch(false, img, mats, out, b, h, w, ho, wo, c, border, dtype, stream);
}

// g (B, ho, wo, C), mats (B, 9) float32 -> grad (B, h, w, C), the image gradient.
extern "C" int ffvc_warp_adjoint(const void* g, const float* mats, void* grad, int b, int h,
                                 int w, int ho, int wo, int c, int border, int dtype,
                                 void* stream) {
  return dispatch(true, g, mats, grad, b, h, w, ho, wo, c, border, dtype, stream);
}

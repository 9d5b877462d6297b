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
//     (top = v00 (1-wx) + v01 wx, bot likewise, out = top (1-wy) + bot wy).
//   * K10 is a gather too, so it needs no atomics and is deterministic: one thread
//     per INPUT pixel p (all C channels) sums w(s(q), p) g[q] over the output
//     pixels q whose sample can reach p, in row-major order of q, in float32,
//     and writes once. Those q are the preimage under m^-1 of p's support box
//     (px-1, px+1) x (py-1, py+1). Where m^-1's denominator keeps one strict sign
//     over the box's corners, the preimage is the convex hull of the corners'
//     images; the thread visits their bounding box widened by 1 px (a q just
//     outside has a sample within rounding of the box edge, where its hat weight
//     is ~0) and clipped to the output frame: about 5x5 pixels for Af and Pe
//     draws, up to ~9x9 for a crop magnified 3.2x (Re at scale 0.1). Where the
//     sign changes (the horizon of m^-1 crosses the box) the thread visits the
//     whole output frame.
//   * Border mode: a sample clamped onto the input frame's edge reaches only the
//     edge pixels, so an edge pixel's box extends outward to the bounding box of
//     all the output frame's samples (the image of the output frame's corners,
//     when m's denominator keeps one sign over the output frame and no sample
//     exceeds 1e5 px; else the whole output frame is visited). Edge pixels are
//     ordered after the interior pixels, so their longer loops share warps with
//     each other.
// What bounds K10 in practice is that per-q work: ~20-80 visits per pixel, each
// recomputing s(q). Tiles staged in shared memory are later work.

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_forward_kernel(const T* __restrict__ img, const float* __restrict__ mats,
                    T* __restrict__ out, int b, int h, int w, int ho, int wo, int c,
                    bool border) {
  // one thread per output pixel q = (qx, qy) of the (ho, wo) frame
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= static_cast<long long>(b) * ho * wo) return;
  const int bi = static_cast<int>(i / (static_cast<long long>(ho) * wo));
  const int r = static_cast<int>(i % (static_cast<long long>(ho) * wo));
  const int qy = r / wo, qx = r % wo;
  const Taps t = sample_taps(mats + bi * 9, qx, qy, h, w, border);
  int x1 = t.x0 + 1, y1 = t.y0 + 1;
  // zeros mode: a tap outside the frame reads 0; border mode: the taps are in the
  // frame but x0 + 1 (y0 + 1) may be one past the edge, at weight 0
  const bool in_x0 = border || (t.x0 >= 0 && t.x0 < w);
  const bool in_x1 = border || (x1 >= 0 && x1 < w);
  const bool in_y0 = border || (t.y0 >= 0 && t.y0 < h);
  const bool in_y1 = border || (y1 >= 0 && y1 < h);
  x1 = min(x1, w - 1);
  y1 = min(y1, h - 1);
  const T* base = img + static_cast<long long>(bi) * h * w * c;
  auto tap = [&](bool inside, int x, int y, int ch) -> float {
    return inside ? to_f(base[(static_cast<long long>(y) * w + x) * c + ch]) : 0.f;
  };
  const float ux = __fsub_rn(1.f, t.wx), uy = __fsub_rn(1.f, t.wy);
  T* o = out + i * c;
  for (int ch = 0; ch < c; ++ch) {
    const float v00 = tap(in_x0 && in_y0, t.x0, t.y0, ch);
    const float v01 = tap(in_x1 && in_y0, x1, t.y0, ch);
    const float v10 = tap(in_x0 && in_y1, t.x0, y1, ch);
    const float v11 = tap(in_x1 && in_y1, x1, y1, ch);
    const float top = __fadd_rn(__fmul_rn(v00, ux), __fmul_rn(v01, t.wx));
    const float bot = __fadd_rn(__fmul_rn(v10, ux), __fmul_rn(v11, t.wx));
    o[ch] = from_f<T>(__fadd_rn(__fmul_rn(top, uy), __fmul_rn(bot, t.wy)));
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_adjoint_kernel(const T* __restrict__ g, const float* __restrict__ mats,
                    T* __restrict__ grad, int b, int h, int w, int ho, int wo, int c,
                    bool border) {
  // one thread per input pixel p = (px, py) of the (h, w) frame, in this order:
  // every image's interior pixels, then every image's edge pixels (top row,
  // bottom row, then the left and right ends of the rows between)
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= static_cast<long long>(b) * h * w) return;
  const int iw = max(w - 2, 0), ih = max(h - 2, 0);
  const long long n_in = static_cast<long long>(b) * ih * iw;
  int bi, px, py;
  if (i < n_in) {
    bi = static_cast<int>(i / (static_cast<long long>(ih) * iw));
    const int r = static_cast<int>(i % (static_cast<long long>(ih) * iw));
    py = 1 + r / iw;
    px = 1 + r % iw;
  } else {
    const int n_edge = h * w - ih * iw;
    bi = static_cast<int>((i - n_in) / n_edge);
    const int e = static_cast<int>((i - n_in) % n_edge);
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
  }
  const float* m = mats + bi * 9;
  // the input box whose samples reach p with nonzero weight (an edge pixel of the
  // input frame, in border mode, also gets the samples clamped onto it)
  double x0 = px - 1.0, x1 = px + 1.0, y0 = py - 1.0, y1 = py + 1.0;
  bool full = false;
  if (border && (px == 0 || px == w - 1 || py == 0 || py == h - 1)) {
    double lo_x, hi_x, lo_y, hi_y;
    if (frame_hull(m, ho, wo, &lo_x, &hi_x, &lo_y, &hi_y)) {
      if (px == 0) x0 = fmin(x0, lo_x - 1.0);
      if (px == w - 1) x1 = fmax(x1, hi_x + 1.0);
      if (py == 0) y0 = fmin(y0, lo_y - 1.0);
      if (py == h - 1) y1 = fmax(y1, hi_y + 1.0);
    } else {
      full = true;
    }
  }
  // the output pixels q to visit: the box's preimage, or the whole output frame
  int qx0 = 0, qx1 = wo - 1, qy0 = 0, qy1 = ho - 1;
  if (!full && !preimage_box(m, x0, x1, y0, y1, ho, wo, &qx0, &qx1, &qy0, &qy1)) {
    qx0 = 0, qx1 = wo - 1, qy0 = 0, qy1 = ho - 1;
  }
  const T* gb = g + static_cast<long long>(bi) * ho * wo * c;
  T* out = grad + (static_cast<long long>(bi) * h * w + static_cast<long long>(py) * w + px) * c;
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    const int nc = min(kChunk, c - c0);
    float acc[kChunk] = {0.f, 0.f, 0.f, 0.f};
    for (int qy = qy0; qy <= qy1; ++qy) {
      for (int qx = qx0; qx <= qx1; ++qx) {
        const Taps t = sample_taps(m, qx, qy, h, w, border);
        // the taps that are p: x0 at weight 1 - wx, x0 + 1 at wx (in border mode
        // clamped onto the edge, where its weight is 0), the same in y
        const int tx1 = border ? min(t.x0 + 1, w - 1) : t.x0 + 1;
        const int ty1 = border ? min(t.y0 + 1, h - 1) : t.y0 + 1;
        if ((t.x0 != px && tx1 != px) || (t.y0 != py && ty1 != py)) continue;
        float ax = 0.f, ay = 0.f;
        if (t.x0 == px) ax = __fsub_rn(1.f, t.wx);
        if (tx1 == px) ax = __fadd_rn(ax, t.wx);
        if (t.y0 == py) ay = __fsub_rn(1.f, t.wy);
        if (ty1 == py) ay = __fadd_rn(ay, t.wy);
        const float wgt = __fmul_rn(ay, ax);
        const T* gq = gb + (static_cast<long long>(qy) * wo + qx) * c + c0;
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          if (k < nc) acc[k] = fmaf(wgt, to_f(gq[k]), acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (k < nc) out[c0 + k] = from_f<T>(acc[k]);
  }
}

template <typename T>
int launch(bool adjoint, const void* src, const float* mats, void* dst, int b, int h, int w,
           int ho, int wo, int c, bool border, cudaStream_t s) {
  // a thread per output pixel (forward) or per input pixel (adjoint)
  const long long n = static_cast<long long>(b) * (adjoint ? h * w : ho * wo);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (adjoint)
    warp_adjoint_kernel<T><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(src), mats, static_cast<T*>(dst), b, h, w, ho, wo, c, border);
  else
    warp_forward_kernel<T><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(src), mats, static_cast<T*>(dst), b, h, w, ho, wo, c, border);
  FFVC_RETURN_LAST_ERROR();
}

int dispatch(bool adjoint, const void* src, const float* mats, void* dst, int b, int h, int w,
             int ho, int wo, int c, int border, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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

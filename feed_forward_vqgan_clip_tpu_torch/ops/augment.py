"""Cutout augmentations, every code of the reference's table: the geometric
codes (`Af`, `Pe`, `Ro`, the crops `Cr`, `Re`, `Re2`, `Cc`, the resize `R`, the
elastic `Et` and thin-plate `Ts` warps), the pointwise codes (`Ji`, `Ji2`,
`Er`, `Er2`, `Sh`, `Gn`) and the fused Af-then-Pe warp of `fuse_geometric`.

Port of feed_forward_vqgan_clip_tpu/ops/augment.py: the bilinear sampler
(`grid_sample`, `warp_perspective_inverse` with its `out_hw` output frame),
`warp_projective` with its exact image gradient, the kornia 0.5.10 draws and
matrices of each code, the HSV conversions and `build_augment_pipeline`. Like
the JAX package they follow kornia 0.5.10's math, not torchvision's defaults.
Images are NHWC in [0, 1]. Each code is a `*_sample` function that draws its
parameters from an explicit torch.Generator, in the order its docstring gives,
and a function that applies them (`*_apply`, `_crop_resize`, `elastic_warp`,
`tps_warp`, ...). torch's and JAX's generators give different numbers, so the
tests hand the JAX functions the draws of a seeded torch.Generator, replayed in
that order, compare the applying functions at draws made with numpy, and the
samplers by their distributions.

`warp_projective` runs the warp kernels on the card (ops/kernels/warp_forward.py,
warp_adjoint.py) and their plain versions on the CPU; Af, Pe, Ro, the fused
warp and the crops ride it, the crops with a cut_size x cut_size output frame.
`R` (an antialiased resize), `Et` and `Ts` (per-pixel sample fields) have no
Pallas kernel in the JAX package and run in plain PyTorch here too, with
backwards that give the same bits on every run, as the JAX package's do: `R`
is the contraction `jax.image.resize` computes (one weight matrix per axis,
`resize_matrix`), so its gradient is two matrix products; `grid_sample`, which
`Et` and `Ts` sample through, differentiates its 4-tap gather by sorting the
taps by destination pixel and summing each pixel's run in a fixed order
(`segment_sum_sorted`) instead of torch.gather's atomic scatter-add.
"""

import functools
import math
from typing import Callable, List, Sequence

import torch
import torch.nn.functional as F

# the codes' settings in the reference's table (kornia 0.5.10)
AF_DEGREES, AF_TRANSLATE, AF_P = 15.0, 0.1, 0.7
PE_DISTORTION, PE_P = 0.7, 0.7
RO_DEGREES, RO_P = 15.0, 0.7
JI_SATURATION, JI_HUE, JI_P = 0.1, 0.1, 0.7
JI2_BRIGHTNESS, JI2_CONTRAST, JI2_SATURATION, JI2_HUE, JI2_P = 0.1, 0.1, 0.05, 0.05, 0.5
ER_SCALE, ER_RATIO, ER_P = (0.1, 0.4), (0.3, 1 / 0.3), 0.7
SH_SHARPNESS, SH_P = 0.4, 0.7
GN_MEAN, GN_STD, GN_P = 0.0, 1.0, 0.5
ET_KERNEL, ET_SIGMA, ET_ALPHA, ET_P = 63, 32.0, 1.0, 0.7
TS_SCALE, TS_P = 0.3, 0.7
CR_P = 0.5
RE_SCALE, RE2_SCALE, RE_RATIO = (0.1, 1.0), (0.9, 1.0), (0.75, 1.333)


# ---------------------------------------------------------------- the bilinear warp


def _taps(gx, gy, h, w, padding_mode):
    """The 4 bilinear taps of each sample point: [(xi, yi, inside or None)] in
    the order 00, 01, 10, 11, and the weights (wx, wy), each (B, Ho, Wo, 1).
    `inside` marks the taps in [0, W-1] x [0, H-1] under zeros padding."""
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[..., None]
    wy = (gy - y0)[..., None]
    taps = []
    for xi, yi in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)):
        inside = None
        if padding_mode == "zeros":
            inside = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1))[..., None]
        taps.append((xi, yi, inside))
    return taps, wx, wy


def _tap_index(xi, yi, h, w):
    """Flat index (B, Ho, Wo) of each tap into its image's h * w pixels, clamped."""
    return yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()


def _fetch(img, xi, yi, inside):
    b, h, w, c = img.shape
    idx = _tap_index(xi, yi, h, w).reshape(b, -1, 1).expand(-1, -1, c)
    val = torch.gather(img.reshape(b, h * w, c), 1, idx).reshape(*xi.shape, c)
    if inside is not None:
        val = torch.where(inside, val, torch.zeros((), dtype=val.dtype, device=val.device))
    return val


def segment_sum_sorted(keys, vals, n):
    """out[d] = the sum of vals[i] (N, C) over the i with keys[i] == d, for d in
    [0, n), in a fixed order: each key's entries are ordered by a stable sort
    (their order in `keys`), and summed as a pairwise tree over that run
    (entries 2j and 2j+1, then pairs of pairs, ...). Every step is an
    elementwise op or an integer scan, so the bits are the same on every run and
    on every device: no atomics. A key outside [0, n) is dropped."""
    # one zero entry per key, first in its run: every key then has a run, and its
    # run starts at a known place (0 + v adds nothing to the first value)
    keys = torch.cat([torch.arange(n, device=keys.device), keys.clamp(0, n)])
    vals = torch.cat([vals.new_zeros(n, vals.shape[1]), vals])
    order = torch.sort(keys, stable=True).indices
    keys, vals = keys[order], vals[order]
    counts = torch.bincount(keys, minlength=n + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(keys.numel(), device=keys.device) - starts[keys]
    length = counts[keys]
    step, longest = 1, int(counts[:n].max())
    while step < longest:
        take = ((rank % (2 * step) == 0) & (rank + step < length))[:, None]
        ahead = torch.cat([vals[step:], vals.new_zeros(step, vals.shape[1])])
        vals = torch.where(take, vals + ahead, vals)
        step *= 2
    return vals[starts[:n]]


class _BilinearGather(torch.autograd.Function):
    """`grid_sample`'s 4-tap gather with a deterministic backward. The image
    gradient is the transpose of the gather: each tap's contribution g * wy-term
    * wx-term (zero for a tap outside the frame under zeros padding), summed
    per pixel by `segment_sum_sorted` over the taps in row-major order of the
    output pixel, then taps 00, 01, 10, 11; in float32 (float64 for float64
    inputs), rounded to the image's dtype once. torch.gather's own backward adds
    with atomics on the card, so two runs would differ in the last bits. The
    sample coordinates' gradients are elementwise, as autograd computes them
    through wx and wy."""

    @staticmethod
    def forward(ctx, img, gx, gy, padding_mode):
        _, h, w, _ = img.shape
        taps, wx, wy = _taps(gx, gy, h, w, padding_mode)
        v00, v01, v10, v11 = (_fetch(img, *tap) for tap in taps)
        ctx.save_for_backward(img, gx, gy)
        ctx.padding_mode = padding_mode
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        return top * (1 - wy) + bot * wy

    @staticmethod
    def backward(ctx, gout):
        img, gx, gy = ctx.saved_tensors
        b, h, w, c = img.shape
        taps, wx, wy = _taps(gx, gy, h, w, ctx.padding_mode)
        acc = torch.promote_types(torch.promote_types(img.dtype, gx.dtype), torch.float32)
        g = gout.to(acc)
        g_top, g_bot = g * (1 - wy), g * wy
        gimg = dgx = dgy = None
        if ctx.needs_input_grad[0]:
            frame = (torch.arange(b, device=img.device) * (h * w))[:, None, None]
            keys, vals = [], []
            for (xi, yi, inside), ct in zip(taps, (g_top * (1 - wx), g_top * wx,
                                                   g_bot * (1 - wx), g_bot * wx)):
                key = _tap_index(xi, yi, h, w) + frame
                if inside is not None:  # a tap outside the frame goes to the dropped key
                    key = torch.where(inside[..., 0], key, b * h * w)
                keys.append(key)
                vals.append(ct)
            # (B, Ho, Wo, 4): row-major in the output pixel, then the tap
            keys = torch.stack(keys, -1).reshape(-1)
            vals = torch.stack(vals, -2).reshape(-1, c)
            gimg = segment_sum_sorted(keys, vals, b * h * w).reshape(b, h, w, c).to(img.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            v00, v01, v10, v11 = (_fetch(img, *tap).to(acc) for tap in taps)
            dgx = (g_top * (v01 - v00) + g_bot * (v11 - v10)).sum(-1).to(gx.dtype)
            top = v00 * (1 - wx) + v01 * wx
            bot = v10 * (1 - wx) + v11 * wx
            dgy = (g * (bot - top)).sum(-1).to(gy.dtype)
        return gimg, dgx, dgy, None


def grid_sample(img, gx, gy, padding_mode="zeros"):
    """Bilinear sample img (B, H, W, C) at pixel coords gx, gy (B, Ho, Wo) float32
    -> (B, Ho, Wo, C) float32. Zeros padding zeroes each tap outside
    [0, W-1] x [0, H-1]; border padding clamps the tap index. Differentiable in
    img, gx and gy, with a deterministic image gradient (`_BilinearGather`)."""
    return _BilinearGather.apply(img, gx, gy, padding_mode)


def _base_grid(b, h, w, device="cpu"):
    """(gx, gy), each (B, H, W) float32: every pixel's x and y."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return xs.expand(b, h, w), ys.expand(b, h, w)


def inverse_coords(h_inv, ho, wo):
    """The sample coords (sx, sy), each (B, Ho, Wo) float32, of every pixel of an
    (ho, wo) output frame under the per-sample output->input homography h_inv
    (B, 3, 3)."""
    gx, gy = _base_grid(h_inv.shape[0], ho, wo, h_inv.device)
    m = h_inv.float()[:, :, :, None, None]
    den = m[:, 2, 0] * gx + m[:, 2, 1] * gy + m[:, 2, 2]
    sx = (m[:, 0, 0] * gx + m[:, 0, 1] * gy + m[:, 0, 2]) / den
    sy = (m[:, 1, 0] * gx + m[:, 1, 1] * gy + m[:, 1, 2]) / den
    return sx, sy


def warp_perspective_inverse(img, h_inv, padding_mode="zeros", out_hw=None):
    """Warp img (B, H, W, C) with the per-sample inverse homography h_inv (B, 3, 3)
    (output->input, pixel coords) -> (B, Ho, Wo, C) float32, (Ho, Wo) = out_hw or
    the input's size (the crops and resizes ask for another)."""
    _, h, w, _ = img.shape
    ho, wo = out_hw or (h, w)
    return grid_sample(img, *inverse_coords(h_inv, ho, wo), padding_mode)


class WarpProjective(torch.autograd.Function):
    """`warp_perspective_inverse` in the image's dtype with an exact image
    gradient: forward `warp_forward` (K9), backward `warp_adjoint` (K10), the
    counterpart of the JAX package's `warp_projective` custom_vjp. The matrices
    are drawn, never trained: they get no gradient. The input's frame is saved
    for the backward, which maps the output's gradient back onto it.

        out = WarpProjective.apply(img, m, padding_mode, out_hw)
    """

    @staticmethod
    def forward(ctx, img, m, padding_mode, out_hw):
        # imported here: the kernel modules import this module's plain math
        from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_forward import warp_forward

        m = m.float()
        ctx.save_for_backward(m)
        ctx.padding_mode, ctx.img_dtype = padding_mode, img.dtype
        ctx.in_hw = tuple(img.shape[1:3])
        return warp_forward(img, m, padding_mode, out_hw)

    @staticmethod
    def backward(ctx, gout):
        from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_adjoint import warp_adjoint

        (m,) = ctx.saved_tensors
        gimg = warp_adjoint(gout.to(ctx.img_dtype), m, ctx.padding_mode, ctx.in_hw)
        return gimg, None, None, None


def warp_projective(img, m, padding_mode="zeros", out_hw=None):
    """Bilinear warp of img (B, H, W, C) under the output->input maps m (B, 3, 3),
    zeros or border padding -> (B, Ho, Wo, C) in img's dtype, (Ho, Wo) = out_hw
    or (H, W); differentiable in img. JAX's `pad` and `kind` arguments only steer
    the TPU kernels' planner and have no counterpart."""
    return WarpProjective.apply(img, m, padding_mode, out_hw)


# ---------------------------------------------------------------- Af and Pe


def _affine_inverse_about_center(angle, tx, ty, scale, h, w):
    """Inverse affine (B, 2, 3) of rotate(angle) + translate(t) + scale about the
    centre: p_in = R^-1 / s (p_out - c - t) + c."""
    cx = (w - 1) / 2.0
    cy = (h - 1) / 2.0
    cos = torch.cos(-angle) / scale
    sin = torch.sin(-angle) / scale
    a, bb = cos, -sin
    d, e = sin, cos
    c0 = -a * (cx + tx) - bb * (cy + ty) + cx
    f0 = -d * (cx + tx) - e * (cy + ty) + cy
    return torch.stack([torch.stack([a, bb, c0], -1), torch.stack([d, e, f0], -1)], dim=1)


def _affine3(inv2x3):
    """(B, 2, 3) -> (B, 3, 3) with the row [0, 0, 1]."""
    last = torch.tensor([0.0, 0.0, 1.0], device=inv2x3.device).expand(inv2x3.shape[0], 1, 3)
    return torch.cat([inv2x3, last], dim=1)


def solve_homography(src, dst):
    """Per-sample homography H (B, 3, 3) with dst ~ H @ src; src, dst (B, 4, 2)."""
    b = src.shape[0]
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    rows_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], -1)
    rows_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], -1)
    a = torch.cat([rows_u, rows_v], dim=1)  # (B, 8, 8)
    rhs = torch.cat([u, v], dim=1)[..., None]  # (B, 8, 1)
    # solve_ex: no singularity check, so no host sync on the card (as jnp.linalg.solve)
    p = torch.linalg.solve_ex(a, rhs).result[..., 0]
    return torch.cat([p, torch.ones(b, 1, dtype=p.dtype, device=p.device)], dim=1).reshape(b, 3, 3)


def _kornia_ac_false_fold(m3, h, w):
    """Fold kornia 0.5.10's align_corners mismatch into an inverse warp matrix:
    kornia normalises the pixel matrix with the align-corners convention but
    samples with align_corners=False, so a source coordinate s is read at
    s * w / (w - 1) - 0.5 per axis. Composed into rows 0 and 1 of the 3x3
    inverse, the warp itself stays unchanged."""
    fx = w / (w - 1.0)
    fy = h / (h - 1.0)
    r0 = m3[:, 0:1, :] * fx - 0.5 * m3[:, 2:3, :]
    r1 = m3[:, 1:2, :] * fy - 0.5 * m3[:, 2:3, :]
    return torch.cat([r0, r1, m3[:, 2:3, :]], dim=1)


def af_sample(generator, b, h, w, device="cpu"):
    """kornia random_affine_generator draws at the `Af` code's settings: angles
    uniform in +-AF_DEGREES (degrees), translations uniform in +-AF_TRANSLATE of
    the side (pixels). -> (ang, tx, ty), each (b,) float32."""
    ang = _uniform(generator, b, -AF_DEGREES, AF_DEGREES, device)
    tx = _uniform(generator, b, -AF_TRANSLATE, AF_TRANSLATE, device) * w
    ty = _uniform(generator, b, -AF_TRANSLATE, AF_TRANSLATE, device) * h
    return ang, tx, ty


def af_matrices(ang_deg, tx, ty, h, w):
    """The output->input maps (B, 3, 3) of kornia RandomAffine for sampled
    (angle, translations): rotation about the (w-1)/2 centre composed with the
    translation, with the align_corners=False quirk folded in. kornia's rotation
    matrix is OpenCV's [[a, b], [-b, a]] with b = sin(angle), the forward form
    that `_affine_inverse_about_center` builds for +angle, so the inverse takes
    the negated angle."""
    ang = -ang_deg * (math.pi / 180.0)
    inv = _affine_inverse_about_center(ang, tx, ty, torch.ones_like(ang), h, w)
    return _kornia_ac_false_fold(_affine3(inv), h, w)


def af_apply(x, ang_deg, tx, ty, padding_mode="border"):
    """kornia RandomAffine.apply for sampled (angle, translations), border padding
    (zeros for `Ro`)."""
    _, h, w, _ = x.shape
    return warp_projective(x, af_matrices(ang_deg, tx, ty, h, w), padding_mode)


def random_affine(generator, x):
    """The `Af` code: kornia RandomAffine(15, translate=0.1, padding_mode='border'),
    each sample warped with probability AF_P (the warp runs on every sample, the
    select follows)."""
    b, h, w, _ = x.shape
    warped = af_apply(x, *af_sample(generator, b, h, w, x.device))
    return _apply_p(generator, AF_P, warped, x)


def random_rotation(generator, x):
    """The `Ro` code: kornia RandomRotation(15), an angle uniform in +-RO_DEGREES
    (one draw per sample, then the application coin), `af_apply` with zero
    translation and zeros padding, each sample rotated with probability RO_P."""
    b = x.shape[0]
    ang = _uniform(generator, b, -RO_DEGREES, RO_DEGREES, x.device)
    zero = torch.zeros(b, device=x.device)
    return _apply_p(generator, RO_P, af_apply(x, ang, zero, zero, "zeros"), x)


def pe_sample(generator, b, h, w, device="cpu"):
    """kornia random_perspective_generator at the `Pe` code's distortion: each
    corner moved inward by uniform(0, PE_DISTORTION / 2 * side) per axis.
    -> (start, end), each (b, 4, 2) float32 corner points."""
    base = torch.tensor([[0.0, 0.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0], [0.0, h - 1.0]],
                        device=device)
    signs = torch.tensor([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]], device=device)
    half = torch.tensor([float(w), float(h)], device=device) * (PE_DISTORTION / 2.0)
    disp = torch.rand(b, 4, 2, generator=generator, device=device) * half * signs
    start = base.expand(b, 4, 2)
    return start, start + disp


def pe_matrices(start, end, h, w):
    """The output->input maps (B, 3, 3) of kornia RandomPerspective for sampled
    corner points: the homography taking end to start, with the
    align_corners=False quirk folded in."""
    return _kornia_ac_false_fold(solve_homography(end, start), h, w)


def pe_apply(x, start, end):
    """kornia RandomPerspective.apply for sampled corner points, zeros padding."""
    _, h, w, _ = x.shape
    return warp_projective(x, pe_matrices(start, end, h, w), "zeros")


def random_perspective(generator, x):
    """The `Pe` code: kornia RandomPerspective(0.7, p=0.7), each sample warped
    with probability PE_P."""
    b, h, w, _ = x.shape
    warped = pe_apply(x, *pe_sample(generator, b, h, w, x.device))
    return _apply_p(generator, PE_P, warped, x)


def fused_sample(generator, b, h, w, device="cpu"):
    """The draws of `fused_affine_perspective`, in this order: `af_sample`'s
    (angle, tx, ty), the affine's application coins, `pe_sample`'s corner
    displacements, the perspective's coins. -> (ang_deg, tx, ty, af_on, end,
    pe_on); af_on and pe_on (b,) bool."""
    ang, tx, ty = af_sample(generator, b, h, w, device)
    af_on = torch.rand(b, generator=generator, device=device) < AF_P
    _, end = pe_sample(generator, b, h, w, device)
    pe_on = torch.rand(b, generator=generator, device=device) < PE_P
    return ang, tx, ty, af_on, end, pe_on


def fused_matrices(ang_deg, tx, ty, af_on, end, pe_on, h, w):
    """The composed output->input maps (B, 3, 3) of `fused_affine_perspective`,
    as the JAX package builds them: the affine inverse about the centre at +angle
    (no kornia align-corners fold), the homography taking the moved corners back
    to the frame's, each the identity where its coin did not fall, composed
    Af_inv @ Pe_inv (Pe is applied last in the sequential chain, so its inverse
    acts first on the output coordinate)."""
    b = ang_deg.shape[0]
    dev = ang_deg.device
    eye = torch.eye(3, device=dev).expand(b, 3, 3)
    af3 = _affine3(_affine_inverse_about_center(ang_deg * math.pi / 180, tx, ty,
                                                torch.ones(b, device=dev), h, w))
    af3 = torch.where(af_on[:, None, None], af3, eye)
    base = torch.tensor([[0.0, 0.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0], [0.0, h - 1.0]],
                        device=dev).expand(b, 4, 2)
    h_inv = torch.where(pe_on[:, None, None], solve_homography(end, base), eye)
    return torch.einsum("bij,bjk->bik", af3, h_inv)


def fused_affine_perspective(generator, x):
    """`fuse_geometric`: Af followed by Pe composed into one projective warp with
    border padding over the whole composed map (one resample instead of two), as
    the JAX package does it. It is not `af_apply` then `pe_apply`: the
    interpolation, the angle's sign convention, the align-corners fold and the
    padding differ, by design; the per-sample application probabilities are the
    codes' own."""
    b, h, w, _ = x.shape
    m = fused_matrices(*fused_sample(generator, b, h, w, x.device), h, w)
    return warp_projective(x, m, "border")


# ---------------------------------------------------------------- crops and resize


def crop_matrices(x0, y0, cw, ch, out_size):
    """The output->input maps (B, 3, 3) that crop each sample's box (x0, y0, cw,
    ch) and resize it bilinearly to out_size x out_size: the axis-aligned map
    sx = x0 + qx (cw - 1) / (S - 1), sy = y0 + qy (ch - 1) / (S - 1) that kornia's
    crop_by_boxes solves from the box's corners."""
    zeros = torch.zeros_like(x0)
    ones = torch.ones_like(x0)
    denom = float(max(out_size - 1, 1))
    return torch.stack([torch.stack([(cw - 1.0) / denom, zeros, x0], -1),
                        torch.stack([zeros, (ch - 1.0) / denom, y0], -1),
                        torch.stack([zeros, zeros, ones], -1)], dim=1)


def _crop_resize(x, x0, y0, cw, ch, out_size):
    """`crop_matrices` through `warp_projective` with an (out_size, out_size)
    output frame and border padding: x (B, H, W, C) -> (B, out_size, out_size,
    C)."""
    m = crop_matrices(x0, y0, cw, ch, out_size)
    return warp_projective(x, m, "border", (out_size, out_size))


def _full(b, value, device):
    return torch.full((b,), float(value), device=device)


def cr_sample(generator, b, h, w, size, device="cpu"):
    """kornia RandomCrop(size) at the `Cr` code's p: draws, in order, y0 and x0
    uniform in [0, side - size), then the coins; a sample whose coin does not
    fall is cropped at the centre. -> (x0, y0), each (b,) float32."""
    max_y, max_x = h - size, w - size
    y0 = torch.rand(b, generator=generator, device=device) * max_y
    x0 = torch.rand(b, generator=generator, device=device) * max_x
    applied = torch.rand(b, generator=generator, device=device) < CR_P
    return (torch.where(applied, x0, _full(b, max_x / 2.0, device)),
            torch.where(applied, y0, _full(b, max_y / 2.0, device)))


def random_crop(generator, x, size):
    """The `Cr` code: a size x size crop of every sample (the output size is
    fixed), at a random offset with probability CR_P, else centred."""
    b, h, w, _ = x.shape
    side = _full(b, size, x.device)
    return _crop_resize(x, *cr_sample(generator, b, h, w, size, x.device), side, side, size)


def center_crop(x, size):
    """The `Cc` code: kornia CenterCrop(size); no draws."""
    b, h, w, _ = x.shape
    side = _full(b, size, x.device)
    return _crop_resize(x, _full(b, (w - size) / 2.0, x.device),
                        _full(b, (h - size) / 2.0, x.device), side, side, size)


def re_sample(generator, b, h, w, scale, device="cpu"):
    """kornia RandomResizedCrop's box draws: in order, the area uniform in
    scale * H * W, the log aspect (box w/h) uniform in log RE_RATIO, then the
    offsets' uniforms; box sides sqrt(area * aspect) and sqrt(area / aspect)
    clamped to [1, side], the origin uniform in [0, side - box]. -> (x0, y0, cw,
    ch), each (b,) float32."""
    area = _uniform(generator, b, scale[0], scale[1], device) * h * w
    aspect = torch.exp(_uniform(generator, b, math.log(RE_RATIO[0]), math.log(RE_RATIO[1]),
                                device))
    cw = torch.sqrt(area * aspect).clamp(1.0, w)
    ch = torch.sqrt(area / aspect).clamp(1.0, h)
    x0 = torch.rand(b, generator=generator, device=device) * (w - cw)
    y0 = torch.rand(b, generator=generator, device=device) * (h - ch)
    return x0, y0, cw, ch


def random_resized_crop(generator, x, size, scale=RE_SCALE):
    """The `Re` (scale RE_SCALE) and `Re2` (RE2_SCALE) codes: kornia
    RandomResizedCrop(size), a drawn box of every sample resized to size x size."""
    b, h, w, _ = x.shape
    return _crop_resize(x, *re_sample(generator, b, h, w, scale, x.device), size)


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int, dtype, device) -> torch.Tensor:
    """(in, out) weights of a bilinear resize along one axis, as
    `jax.image.resize` builds them (`compute_weight_mat` with the triangle
    kernel, antialias on, scale out / in, no translation): half-pixel centres,
    the kernel widened by in / out when it shrinks, each output's weights
    normalised to sum 1, and zero where its sample lies outside the input. Built
    in float32, then cast to `dtype` (bf16 rounds the weights as JAX's cast does);
    cached per (in, out, dtype, device)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    weights = (1.0 - x / kernel_scale).clamp_min(0.0)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0).to(device=device, dtype=dtype)


def resize_bilinear(x, size: int):
    """NHWC images -> (N, size, size, C), `jax.image.resize(..., "bilinear")`
    (the `R` code, the reference's Resize module, and the in-train eval's
    resize): one `resize_matrix` contraction per axis whose size changes, in
    x's dtype. Forward and backward are matrix products, with no atomics: the
    same bits on every run."""
    _, h, w, _ = x.shape
    if h != size:
        x = torch.einsum("bhwc,ho->bowc", x, resize_matrix(h, size, x.dtype, x.device))
    if w != size:
        x = torch.einsum("bhwc,wo->bhoc", x, resize_matrix(w, size, x.dtype, x.device))
    return x


# ---------------------------------------------------------------- colour and erasing


def rgb_to_hsv(rgb):
    """(..., 3) RGB -> (..., 3) HSV, hue in [0, 1) turns."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-8), torch.zeros_like(maxc))
    safe = delta.clamp_min(1e-8)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv):
    """(..., 3) HSV -> (..., 3) RGB."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):  # jnp.select over the six hue sectors
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def _uniform(generator, n, lo, hi, device):
    return torch.rand(n, generator=generator, device=device) * (hi - lo) + lo


def _apply_p(generator, p, x_aug, x):
    """Per sample, x_aug with probability p, else x."""
    applied = torch.rand(x.shape[0], generator=generator, device=x.device) < p
    return torch.where(applied[:, None, None, None], x_aug, x)


def ji_sample(generator, b, device="cpu"):
    """kornia random_color_jitter_generator (0.5.10) at the `Ji` code's settings:
    per-sample saturation factors uniform[1 - JI_SATURATION, 1 + JI_SATURATION]
    and hue shifts uniform[-JI_HUE, JI_HUE]. The code's brightness and contrast
    are 0 (factors 1), so kornia's random order of the four transforms computes
    the same function whatever it is, and no order is drawn. -> (sf, hf)"""
    sf = _uniform(generator, b, 1 - JI_SATURATION, 1 + JI_SATURATION, device)
    hf = _uniform(generator, b, -JI_HUE, JI_HUE, device)
    return sf, hf


def ji2_sample(generator, b, device="cpu"):
    """kornia random_color_jitter_generator (0.5.10) at the `Ji2` code's
    settings, in this order: brightness, contrast and saturation factors uniform
    in [max(0, 1 - c), 1 + c], hue shifts uniform in +-JI2_HUE, then one
    application order of the four transforms for the whole call
    (torch.randperm(4)). -> (bf, cf, sf, hf, order)"""
    bf = _uniform(generator, b, 1 - JI2_BRIGHTNESS, 1 + JI2_BRIGHTNESS, device)
    cf = _uniform(generator, b, 1 - JI2_CONTRAST, 1 + JI2_CONTRAST, device)
    sf = _uniform(generator, b, 1 - JI2_SATURATION, 1 + JI2_SATURATION, device)
    hf = _uniform(generator, b, -JI2_HUE, JI2_HUE, device)
    order = torch.randperm(4, generator=generator, device=device)
    return bf, cf, sf, hf, order


def ji_apply(x, bf, cf, sf, hf, order=None):
    """kornia ColorJitter.apply_transform (0.5.10): brightness ADDITIVE (x +
    (factor - 1), clamped), contrast a pure scale (clamped), saturation scales S
    in HSV (clamped), hue shifts H modulo 1; each its own HSV round trip, in
    `order` (None: the identity order)."""
    bf = bf.reshape(-1, 1, 1, 1)
    cf = cf.reshape(-1, 1, 1, 1)

    def brightness(img):
        return (img + (bf - 1.0)).clamp(0.0, 1.0)

    def contrast(img):
        return (img * cf).clamp(0.0, 1.0)

    def saturation(img):
        hsv = rgb_to_hsv(img)
        ss = (hsv[..., 1] * sf.reshape(-1, 1, 1)).clamp(0.0, 1.0)
        return hsv_to_rgb(torch.stack([hsv[..., 0], ss, hsv[..., 2]], dim=-1))

    def hue(img):
        hsv = rgb_to_hsv(img)
        hh = torch.remainder(hsv[..., 0] + hf.reshape(-1, 1, 1), 1.0)
        return hsv_to_rgb(torch.stack([hh, hsv[..., 1], hsv[..., 2]], dim=-1))

    fns = (brightness, contrast, saturation, hue)
    steps = range(4) if order is None else [int(k) for k in order.tolist()]
    out = x
    for k in steps:
        out = fns[k](out)
    return out


def color_jitter(generator, x):
    """The `Ji` code: kornia ColorJitter(saturation=0.1, hue=0.1), per-sample
    factors, each sample jittered with probability JI_P. Saturation and hue act
    on disjoint HSV channels, so they share one HSV round trip, as in the JAX
    package (`ji_apply` at factors 1 for brightness and contrast, in any order,
    is the same function). HSV math runs in float32 (a hue in bf16 would be
    quantised to ~1.4 degree steps)."""
    sf, hf = ji_sample(generator, x.shape[0], x.device)
    hsv = rgb_to_hsv(x.float())
    ss = (hsv[..., 1] * sf.reshape(-1, 1, 1)).clamp(0.0, 1.0)
    hh = torch.remainder(hsv[..., 0] + hf.reshape(-1, 1, 1), 1.0)
    out = hsv_to_rgb(torch.stack([hh, ss, hsv[..., 2]], dim=-1))
    return _apply_p(generator, JI_P, out.to(x.dtype), x)


def color_jitter2(generator, x):
    """The `Ji2` code: kornia ColorJitter(0.1, 0.1, 0.05, 0.05, p=0.5), each of the
    four transforms its own HSV or pixel pass in the drawn order (`ji_apply`, in
    float32; reading the order costs one copy of 4 ints to the host), each
    sample jittered with probability JI2_P."""
    out = ji_apply(x.float(), *ji2_sample(generator, x.shape[0], x.device))
    return _apply_p(generator, JI2_P, out.to(x.dtype), x)


def er_sample(generator, n, h, w, device="cpu"):
    """kornia random_rectangles_params_generator (0.5.10) at the `Er` code's
    settings: area uniform in ER_SCALE*H*W; the aspect (box h/w) a two-part
    uniform mixture, since ER_RATIO straddles 1 (uniform(r0, 1) or uniform(1,
    r1), coin-flipped); box height round(sqrt(area*aspect)) and width
    round(sqrt(area/aspect)) clamped to [1, side]; the origin uniform(0, 1)*(side
    - box + 1), kept as a float. -> (x0, y0, ew, eh), each (n,) float32."""
    (s0, s1), (r0, r1) = ER_SCALE, ER_RATIO
    area = _uniform(generator, n, s0, s1, device) * h * w
    a1 = _uniform(generator, n, r0, 1.0, device)
    a2 = _uniform(generator, n, 1.0, r1, device)
    pick = torch.round(torch.rand(n, generator=generator, device=device)).bool()
    aspect = torch.where(pick, a1, a2)
    eh = torch.round(torch.sqrt(area * aspect)).clamp(1, h)
    ew = torch.round(torch.sqrt(area / aspect)).clamp(1, w)
    y0 = torch.rand(n, generator=generator, device=device) * (h - eh + 1)
    x0 = torch.rand(n, generator=generator, device=device) * (w - ew + 1)
    return x0, y0, ew, eh


def er_apply(x, x0, y0, ew, eh):
    """kornia RandomErasing.apply (bbox_to_mask): pixel (j, i) is zeroed iff
    x0 <= j <= x0 + ew - 1 and y0 <= i <= y0 + eh - 1, float comparisons against
    the integer grid. x0..eh are (n,) with n = 1 (one box for the batch) or B."""
    h, w = x.shape[1:3]
    gy = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
    gx = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
    col = lambda v: v.reshape(-1, 1, 1)  # noqa: E731
    inside = ((gx >= col(x0)) & (gx <= col(x0 + ew - 1))
              & (gy >= col(y0)) & (gy <= col(y0 + eh - 1)))
    return torch.where(inside[..., None], torch.zeros((), dtype=x.dtype, device=x.device), x)


def random_erasing(generator, x, same_on_batch=True):
    """The `Er` code: kornia RandomErasing(p=0.7, same_on_batch=True), one
    rectangle of zeros for the whole batch (`Er2`: same_on_batch=False, one per
    sample), each sample erased with probability ER_P."""
    b, h, w, _ = x.shape
    box = er_sample(generator, 1 if same_on_batch else b, h, w, x.device)
    return _apply_p(generator, ER_P, er_apply(x, *box), x)


# ---------------------------------------------------------------- sharpness and noise


def _conv2d_same(x, kernel2d):
    """Each channel of x (B, H, W, C) correlated with kernel2d (kh, kw, odd sides),
    zero padding to the same size; the kernel in x's dtype."""
    c = x.shape[-1]
    kh, kw = kernel2d.shape
    weight = kernel2d.to(device=x.device, dtype=x.dtype).expand(c, 1, kh, kw).contiguous()
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=(kh // 2, kw // 2), groups=c)
    return out.permute(0, 2, 3, 1)


def _keep_border(blurred, x):
    """blurred with x's first and last rows and columns."""
    h, w = x.shape[1:3]
    edge = torch.ones(h, w, dtype=torch.bool, device=x.device)
    edge[1:-1, 1:-1] = False
    return torch.where(edge[None, :, :, None], x, blurred)


def sh_apply(x, factor):
    """kornia RandomSharpness.apply for sampled factors (B, 1, 1, 1): a blend away
    from the 3x3 smoothed image, the border rows and columns not smoothed,
    clamped to [0, 1]."""
    kernel = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]]) / 13.0
    blurred = _keep_border(_conv2d_same(x, kernel), x)
    return (x + factor * (x - blurred)).clamp(0.0, 1.0)


def random_sharpness(generator, x):
    """The `Sh` code: kornia RandomSharpness(0.4, p=0.7), a factor uniform in [0,
    SH_SHARPNESS) per sample, then the coins."""
    b = x.shape[0]
    factor = _uniform(generator, b, 0.0, SH_SHARPNESS, x.device).reshape(b, 1, 1, 1)
    return _apply_p(generator, SH_P, sh_apply(x, factor), x)


def gaussian_noise(generator, x):
    """The `Gn` code: kornia RandomGaussianNoise(0, 1, p=0.5), N(0, 1) noise in
    x's dtype (drawn first, then the coins)."""
    noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return _apply_p(generator, GN_P, x + GN_MEAN + GN_STD * noise, x)


# ---------------------------------------------------------------- elastic and thin-plate


def _sample_normalized_ac_false(x, gx_norm, gy_norm):
    """F.grid_sample(align_corners=False, padding_mode='zeros') at normalised
    [-1, 1] coords: pixel p = ((g + 1) S - 1) / 2, then the 4-tap gather with
    each tap outside the frame zeroed (`grid_sample`)."""
    _, h, w, _ = x.shape
    sx = ((gx_norm + 1.0) * w - 1.0) / 2.0
    sy = ((gy_norm + 1.0) * h - 1.0) / 2.0
    return grid_sample(x, sx, sy, "zeros")


def _gaussian_blur(x, kernel_size, sigma):
    """Each channel of x (B, H, W, C) blurred by a normalised Gaussian of
    kernel_size taps, vertically then horizontally, zero padding."""
    half = kernel_size // 2
    xs = torch.arange(-half, half + 1, dtype=torch.float32)
    g = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return _conv2d_same(_conv2d_same(x, g[:, None]), g[None, :])


def elastic_warp(x, noise):
    """kornia 0.5.10 `elastic_transform2d` at the `Et` code's settings: the noise
    field (B, H, W, 2) blurred by a normalised zero-padded Gaussian (ET_KERNEL
    taps, ET_SIGMA), scaled by ET_ALPHA, added to the normalised align-corners
    grid, clamped to [-1, 1], sampled with align_corners=False and zeros
    padding."""
    _, h, w, _ = x.shape
    disp = _gaussian_blur(noise, ET_KERNEL, ET_SIGMA) * ET_ALPHA
    gnx = torch.linspace(-1.0, 1.0, w, device=x.device)
    gny = torch.linspace(-1.0, 1.0, h, device=x.device)
    gx = (gnx[None, None, :] + disp[..., 0]).clamp(-1.0, 1.0)
    gy = (gny[None, :, None] + disp[..., 1]).clamp(-1.0, 1.0)
    return _sample_normalized_ac_false(x, gx, gy)


def elastic_transform(generator, x):
    """The `Et` code: kornia RandomElasticTransform's defaults, a noise field
    uniform in [-1, 1) of shape (B, H, W, 2) (drawn first, then the coins), each
    sample warped with probability ET_P."""
    b, h, w, _ = x.shape
    noise = torch.rand(b, h, w, 2, generator=generator, device=x.device) * 2.0 - 1.0
    return _apply_p(generator, ET_P, elastic_warp(x, noise), x)


_TPS_EPS = 1e-8
# kornia's control points: the 4 corners and the centre, normalised coords
TPS_SRC = ((-1.0, -1.0), (-1.0, 1.0), (1.0, -1.0), (1.0, 1.0), (0.0, 0.0))


def _tps_kernel(d2):
    """kornia _kernel_distance: 0.5 d^2 log(d^2 + eps) (= d^2 log d)."""
    return 0.5 * d2 * torch.log(d2 + _TPS_EPS)


def _pair_sq_dist(a, b):
    d = (-2.0 * torch.einsum("bnd,bmd->bnm", a, b) + (a * a).sum(-1)[:, :, None]
         + (b * b).sum(-1)[:, None, :])
    return d.clamp_min(0.0)  # kornia clamps at 0


def get_tps_transform(points_src, points_dst):
    """kornia 0.5.10 `get_tps_transform`: solve [K P; P^T 0][w; a] = [dst; 0] with
    U(r) = r^2 log r at the src points. -> (kernel weights (B, N, 2), affine
    weights (B, 3, 2), row 0 the constant term)."""
    b, n = points_src.shape[:2]
    dev = points_src.device
    k = _tps_kernel(_pair_sq_dist(points_src, points_src))
    p = torch.cat([torch.ones(b, n, 1, device=dev), points_src], -1)  # (B, N, 3)
    l_top = torch.cat([k, p], -1)
    l_bot = torch.cat([p, torch.zeros(b, 3, 3, device=dev)], 1).transpose(1, 2)
    rhs = torch.cat([points_dst, torch.zeros(b, 3, 2, device=dev)], 1)
    # solve_ex: no singularity check, so no host sync on the card
    weights = torch.linalg.solve_ex(torch.cat([l_top, l_bot], 1), rhs).result
    return weights[:, :n], weights[:, n:]


def warp_points_tps(points, kernel_centers, kernel_weights, affine_weights):
    """f(v) = a0 + A v + sum_i w_i U(|v - c_i|) over (B, M, 2) points."""
    k = _tps_kernel(_pair_sq_dist(points, kernel_centers))
    return (torch.einsum("bmn,bnd->bmd", k, kernel_weights)
            + torch.einsum("bmd,bde->bme", points, affine_weights[:, 1:])
            + affine_weights[:, None, 0])


def tps_warp(x, src, dst):
    """kornia 0.5.10 RandomThinPlateSpline.apply_transform, with its upstream quirk
    (kornia issue #1186) kept: the weights are solved with `dst` as the spline's
    source points, but the evaluation passes `src` as the kernel centres."""
    b, h, w, _ = x.shape
    kernel_w, affine_w = get_tps_transform(dst, src)
    gny, gnx = torch.meshgrid(torch.linspace(-1.0, 1.0, h, device=x.device),
                              torch.linspace(-1.0, 1.0, w, device=x.device), indexing="ij")
    coords = torch.stack([gnx, gny], -1).reshape(1, h * w, 2).expand(b, h * w, 2)
    warped = warp_points_tps(coords, src, kernel_w, affine_w).reshape(b, h, w, 2)
    return _sample_normalized_ac_false(x, warped[..., 0], warped[..., 1])


def ts_sample(generator, b, device="cpu"):
    """kornia RandomThinPlateSpline(0.3)'s draws: the destination points, TPS_SRC
    moved by uniform(-TS_SCALE, TS_SCALE) per coordinate. -> (src, dst), each
    (b, 5, 2) float32."""
    src = torch.tensor(TPS_SRC, device=device).expand(b, 5, 2)
    shift = torch.rand(b, 5, 2, generator=generator, device=device) * (2 * TS_SCALE) - TS_SCALE
    return src, src + shift


def thin_plate_spline(generator, x):
    """The `Ts` code: `tps_warp` at `ts_sample`'s points (drawn first, then the
    coins), each sample warped with probability TS_P."""
    return _apply_p(generator, TS_P, tps_warp(x, *ts_sample(generator, x.shape[0], x.device)),
                    x)


AugFn = Callable[[torch.Generator, torch.Tensor], torch.Tensor]


def build_augment_pipeline(codes: Sequence[str], cut_size: int) -> List[AugFn]:
    """Aug codes -> list of (generator, images) -> images functions: the JAX
    package's table (the reference's); the crops and `R` resize to cut_size. An
    unknown code raises ValueError."""
    table = {
        "Ji2": color_jitter2, "Ji": color_jitter, "Sh": random_sharpness, "Gn": gaussian_noise,
        "Pe": random_perspective, "Ro": random_rotation, "Af": random_affine,
        "Et": elastic_transform, "Ts": thin_plate_spline,
        "Cr": functools.partial(random_crop, size=cut_size),
        "Er": random_erasing, "Er2": functools.partial(random_erasing, same_on_batch=False),
        "Re": functools.partial(random_resized_crop, size=cut_size, scale=RE_SCALE),
        "Re2": functools.partial(random_resized_crop, size=cut_size, scale=RE2_SCALE),
        "Cc": lambda generator, x: center_crop(x, cut_size),
        "R": lambda generator, x: resize_bilinear(x, cut_size),
    }
    missing = [c for c in codes if c not in table]
    if missing:
        raise ValueError(f"unknown augmentation codes: {missing}")
    return [table[c] for c in codes]

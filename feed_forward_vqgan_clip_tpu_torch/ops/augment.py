"""Cutout augmentations: random affine (`Af`), random perspective (`Pe`), colour
jitter (`Ji`) and random erasing (`Er`), the reference's default set.

Port of feed_forward_vqgan_clip_tpu/ops/augment.py: the bilinear sampler
(`grid_sample`, `warp_perspective_inverse`), `warp_projective` with its exact
image gradient, the kornia 0.5.10 draws and matrices of `Af` and `Pe`
(`af_sample` / `af_matrices` / `af_apply` / `random_affine`, `pe_sample` /
`pe_matrices` / `pe_apply` / `random_perspective`, `solve_homography`,
`_kornia_ac_false_fold`), the HSV
conversions, `ji_sample` / `ji_apply` / `color_jitter`, `er_sample` /
`er_apply` / `random_erasing` and `build_augment_pipeline`. Like the JAX package
they follow kornia 0.5.10's math, not torchvision's defaults. Images are NHWC
in [0, 1]. Random draws come from an explicit torch.Generator; torch's and
JAX's generators give different numbers, so the tests compare the `*_apply`
functions at draws made with numpy and the samplers by their distributions.

`warp_projective` runs the warp kernels on the card (ops/kernels/warp_forward.py,
warp_adjoint.py) and their plain versions on the CPU. The other codes, the crops
that ride the same warp with a rectangular output and `fuse_geometric` are
ROADMAP A13.
"""

import math
from typing import Callable, List, Sequence

import torch

# the default codes' settings in the reference's table (kornia 0.5.10)
AF_DEGREES, AF_TRANSLATE, AF_P = 15.0, 0.1, 0.7
PE_DISTORTION, PE_P = 0.7, 0.7
JI_SATURATION, JI_HUE, JI_P = 0.1, 0.1, 0.7
ER_SCALE, ER_RATIO, ER_P = (0.1, 0.4), (0.3, 1 / 0.3), 0.7


# ---------------------------------------------------------------- the bilinear warp


def grid_sample(img, gx, gy, padding_mode="zeros"):
    """Bilinear sample img (B, H, W, C) at pixel coords gx, gy (B, Ho, Wo) float32
    -> (B, Ho, Wo, C) float32. Zeros padding zeroes each tap outside
    [0, W-1] x [0, H-1]; border padding clamps the tap index."""
    b, h, w, c = img.shape
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[..., None]
    wy = (gy - y0)[..., None]
    flat = img.reshape(b, h * w, c)

    def fetch(xi, yi):
        xc = xi.clamp(0, w - 1).long()
        yc = yi.clamp(0, h - 1).long()
        idx = (yc * w + xc).reshape(b, -1, 1).expand(-1, -1, c)
        val = torch.gather(flat, 1, idx).reshape(*xi.shape, c)
        if padding_mode == "zeros":
            inside = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1))[..., None]
            val = torch.where(inside, val, torch.zeros((), dtype=val.dtype, device=val.device))
        return val

    v00 = fetch(x0, y0)
    v01 = fetch(x0 + 1, y0)
    v10 = fetch(x0, y0 + 1)
    v11 = fetch(x0 + 1, y0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def _base_grid(b, h, w, device="cpu"):
    """(gx, gy), each (B, H, W) float32: every pixel's x and y."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return xs.expand(b, h, w), ys.expand(b, h, w)


def inverse_coords(h_inv, h, w):
    """The sample coords (sx, sy), each (B, H, W) float32, of every output pixel
    under the per-sample output->input homography h_inv (B, 3, 3)."""
    gx, gy = _base_grid(h_inv.shape[0], h, w, h_inv.device)
    m = h_inv.float()[:, :, :, None, None]
    den = m[:, 2, 0] * gx + m[:, 2, 1] * gy + m[:, 2, 2]
    sx = (m[:, 0, 0] * gx + m[:, 0, 1] * gy + m[:, 0, 2]) / den
    sy = (m[:, 1, 0] * gx + m[:, 1, 1] * gy + m[:, 1, 2]) / den
    return sx, sy


def warp_perspective_inverse(img, h_inv, padding_mode="zeros"):
    """Warp img (B, H, W, C) with the per-sample inverse homography h_inv (B, 3, 3)
    (output->input, pixel coords) -> (B, H, W, C) float32. The output has the
    input's size (the crops' rectangular outputs are ROADMAP A13)."""
    _, h, w, _ = img.shape
    return grid_sample(img, *inverse_coords(h_inv, h, w), padding_mode)


class WarpProjective(torch.autograd.Function):
    """`warp_perspective_inverse` in the image's dtype with an exact image
    gradient: forward `warp_forward` (K9), backward `warp_adjoint` (K10), the
    counterpart of the JAX package's `warp_projective` custom_vjp. The matrices
    are drawn, never trained: they get no gradient.

        out = WarpProjective.apply(img, m, padding_mode)
    """

    @staticmethod
    def forward(ctx, img, m, padding_mode):
        # imported here: the kernel modules import this module's plain math
        from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_forward import warp_forward

        m = m.float()
        ctx.save_for_backward(m)
        ctx.padding_mode, ctx.img_dtype = padding_mode, img.dtype
        return warp_forward(img, m, padding_mode)

    @staticmethod
    def backward(ctx, gout):
        from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_adjoint import warp_adjoint

        (m,) = ctx.saved_tensors
        gimg = warp_adjoint(gout.to(ctx.img_dtype), m, ctx.padding_mode)
        return gimg, None, None


def warp_projective(img, m, padding_mode="zeros"):
    """Bilinear warp of img (B, H, W, C) under the output->input maps m (B, 3, 3),
    zeros or border padding -> (B, H, W, C) in img's dtype; differentiable in img."""
    return WarpProjective.apply(img, m, padding_mode)


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


def af_apply(x, ang_deg, tx, ty):
    """kornia RandomAffine.apply for sampled (angle, translations), border padding."""
    _, h, w, _ = x.shape
    return warp_projective(x, af_matrices(ang_deg, tx, ty, h, w), "border")


def random_affine(generator, x):
    """The `Af` code: kornia RandomAffine(15, translate=0.1, padding_mode='border'),
    each sample warped with probability AF_P (the warp runs on every sample, the
    select follows)."""
    b, h, w, _ = x.shape
    warped = af_apply(x, *af_sample(generator, b, h, w, x.device))
    return _apply_p(generator, AF_P, warped, x)


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


def random_erasing(generator, x):
    """The `Er` code: kornia RandomErasing(p=0.7, same_on_batch=True), one
    rectangle of zeros for the whole batch, each sample erased with probability
    ER_P."""
    _, h, w, _ = x.shape
    box = er_sample(generator, 1, h, w, x.device)
    return _apply_p(generator, ER_P, er_apply(x, *box), x)


AugFn = Callable[[torch.Generator, torch.Tensor], torch.Tensor]


def build_augment_pipeline(codes: Sequence[str]) -> List[AugFn]:
    """Aug codes -> list of (generator, images) -> images functions (the
    reference's table; the other codes, the crops among them, are ROADMAP A13)."""
    table = {"Af": random_affine, "Pe": random_perspective, "Ji": color_jitter,
             "Er": random_erasing}
    for c in codes:
        if c not in table:
            raise NotImplementedError(
                f"augmentation code {c!r} is not ported yet (ROADMAP A13); the port has "
                f"{sorted(table)}")
    return [table[c] for c in codes]

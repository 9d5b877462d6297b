"""Cutout augmentations: colour jitter (`Ji`) and random erasing (`Er`).

Port of the pointwise half of feed_forward_vqgan_clip_tpu/ops/augment.py: the
HSV conversions, `ji_sample` / `ji_apply` / `color_jitter`, `er_sample` /
`er_apply` / `random_erasing` and `build_augment_pipeline`. Like the JAX package
they follow kornia 0.5.10's math, not torchvision's defaults. Images are NHWC
in [0, 1]. Random draws come from an explicit torch.Generator; torch's and
JAX's generators give different numbers, so the tests compare the `*_apply`
functions at draws made with numpy and the samplers by their distributions.

The geometric codes (`Af`, `Pe`) need the projective warp kernels (ROADMAP A8,
B5/B6); the other codes are ROADMAP A13.
"""

from typing import Callable, List, Sequence

import torch

# the `Ji` and `Er` codes' settings in the reference's table (kornia 0.5.10)
JI_SATURATION, JI_HUE, JI_P = 0.1, 0.1, 0.7
ER_SCALE, ER_RATIO, ER_P = (0.1, 0.4), (0.3, 1 / 0.3), 0.7


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
    reference's table; the crop codes, which also take the cut size, are
    ROADMAP A13)."""
    table = {"Ji": color_jitter, "Er": random_erasing}
    for c in codes:
        if c not in table:
            where = "ROADMAP A8 (with the warp kernels B5/B6)" if c in ("Af", "Pe") else \
                "ROADMAP A13"
            raise NotImplementedError(
                f"augmentation code {c!r} is not ported yet ({where}); the port has "
                f"{sorted(table)}")
    return [table[c] for c in codes]

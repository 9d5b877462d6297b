"""The plain reference of the mapper's train step (feed_forward_vqgan_clip's
`main.py` with the JAX package's cutouts), in float32 with TF32 off:

    h    = CLIP text(tokens)                       (frozen; input and target)
    z    = clamp_with_grad(mapper(h), min(codebook), max(codebook))
    zq   = z + (codebook[argmin |z - c|^2] - z), the gradient straight to z
    img  = clamp_with_grad((decoder(zq) + 1) / 2, 0, 1)
    cuts = cutouts(img): (avg pool + max pool) / 2 to the image tower's size,
           repeated cutn times, then Af, Pe, Ji, Er (kornia 0.5.10's draws and
           math, each sample with its probability), then additive noise
    loss = mean 2 arcsin(|normalize(h) - normalize(CLIP image(cuts))| / 2)^2
    Adam (b1 0.9, b2 0.999, eps 1e-8, lr 1e-3, optax's update) on every mapper
    parameter

The cutouts draw from the torch.Generator the step is given, in the same
order and with the same calls (and dtypes) as the configuration's cutouts, so
that the program and the reference see the same crops; the warps are
torch's `grid_sample` (bilinear, align_corners=False) at kornia's pixel maps.
Where the reference follows the program's state (its codebook rows, its
images at the cutouts' backward), `train3` says so.
"""

import math

import torch
import torch.nn.functional as F

from perfbench.reference import models as R
from perfbench.reference.precision import EXACT, Precision

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
AF_DEGREES, AF_TRANSLATE, AF_P = 15.0, 0.1, 0.7
PE_DISTORTION, PE_P = 0.7, 0.7
JI_SATURATION, JI_HUE, JI_P = 0.1, 0.1, 0.7
ER_SCALE, ER_RATIO, ER_P = (0.1, 0.4), (0.3, 1 / 0.3), 0.7
NOISE_FAC = 0.1
B1, B2, EPS = 0.9, 0.999, 1e-8


def clip_image_spec(c):
    """CLIP's ViT image tower (OpenAI key names under `visual.`) and logit_scale."""
    w, g, spec = c["vision_width"], c["image_size"] // c["patch_size"], {}
    p = c["patch_size"]
    spec["visual.conv1.weight"] = ((w, 3, p, p), R._normal((3 * p * p) ** -0.5))
    spec["visual.class_embedding"] = ((w,), R._normal(0.02))
    spec["visual.positional_embedding"] = ((g * g + 1, w), R._normal(0.01))
    R._norm_pair("visual.ln_pre.", w, spec)
    for i in range(c["vision_layers"]):
        q = f"visual.transformer.resblocks.{i}."
        R._norm_pair(q + "ln_1.", w, spec)
        spec[q + "attn.in_proj_weight"] = ((3 * w, w), R._normal(w ** -0.5))
        spec[q + "attn.in_proj_bias"] = ((3 * w,), R.BIAS)
        R._dense(q + "attn.out_proj.", w, w, spec)
        R._norm_pair(q + "ln_2.", w, spec)
        R._dense(q + "mlp.c_fc.", 4 * w, w, spec)
        R._dense(q + "mlp.c_proj.", w, 4 * w, spec)
    R._norm_pair("visual.ln_post.", w, spec)
    spec["visual.proj"] = ((w, c["embed_dim"]), R._normal(w ** -0.5))
    spec["logit_scale"] = ((), R._normal(0.0))
    return spec


def clip_image(sd, x, c, P: Precision = EXACT, *, act: str):
    """x (B, H, W, 3) CLIP-normalised -> (B, embed_dim): stride-p patchify, class
    token, positions, pre-LN transformer with the activation `act`
    (`R.clip_act`), LN of the class token, projection."""
    act = R.ACTIVATIONS[act]
    with P.matmul_mode():
        w, heads, p = c["vision_width"], c["vision_heads"], c["patch_size"]
        h = F.conv2d(P.q(x.permute(0, 3, 1, 2)), P.q(sd["visual.conv1.weight"]), stride=p)
        h = h.flatten(2).transpose(1, 2)
        b = h.shape[0]
        h = torch.cat([sd["visual.class_embedding"].float().expand(b, 1, w), h], 1)
        h = R.layer_norm(h + sd["visual.positional_embedding"], sd["visual.ln_pre.weight"],
                         sd["visual.ln_pre.bias"])
        t, dh = h.shape[1], w // heads
        for i in range(c["vision_layers"]):
            q = f"visual.transformer.resblocks.{i}."
            y = R.layer_norm(h, sd[q + "ln_1.weight"], sd[q + "ln_1.bias"])
            qkv = R.linear(y, sd[q + "attn.in_proj_weight"], sd[q + "attn.in_proj_bias"], P)
            qq, kk, vv = (z.reshape(b, t, heads, dh).transpose(1, 2) for z in qkv.chunk(3, -1))
            att = torch.softmax(P.q(qq) @ P.q(kk).transpose(-1, -2) * dh ** -0.5, -1)
            o = (P.q(att) @ P.q(vv)).transpose(1, 2).reshape(b, t, w)
            h = h + R.linear(o, sd[q + "attn.out_proj.weight"], sd[q + "attn.out_proj.bias"], P)
            y = R.layer_norm(h, sd[q + "ln_2.weight"], sd[q + "ln_2.bias"])
            y = R.linear(y, sd[q + "mlp.c_fc.weight"], sd[q + "mlp.c_fc.bias"], P)
            h = h + R.linear(act(y), sd[q + "mlp.c_proj.weight"], sd[q + "mlp.c_proj.bias"], P)
        y = R.layer_norm(h[:, 0], sd["visual.ln_post.weight"], sd["visual.ln_post.bias"])
        return P.q(y) @ P.q(sd["visual.proj"])


class ClampWithGrad(torch.autograd.Function):
    """VQGAN-CLIP's clamp: forward clamp; the gradient passes where it would not
    push an input already out of range further out."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        y = x.clamp(lo, hi)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * (g * (x - y) >= 0).to(g.dtype), None, None


# -- cutouts ---------------------------------------------------------------------

def _uniform(gen, n, lo, hi, dev):
    return torch.rand(n, generator=gen, device=dev) * (hi - lo) + lo


def _coin(gen, p, warped, x):
    on = torch.rand(x.shape[0], generator=gen, device=x.device) < p
    return torch.where(on[:, None, None, None], warped, x)


def _warp(x, m, padding):
    """Bilinear warp of x (B, H, W, C) at the output->input pixel maps m (B, 3, 3)."""
    b, h, w, _ = x.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x.device),
                            torch.arange(w, dtype=torch.float32, device=x.device), indexing="ij")
    m = m.float()[:, :, :, None, None]
    den = m[:, 2, 0] * xs + m[:, 2, 1] * ys + m[:, 2, 2]
    sx = (m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]) / den
    sy = (m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]) / den
    grid = torch.stack([(2 * sx + 1) / w - 1, (2 * sy + 1) / h - 1], -1)
    out = F.grid_sample(x.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode=padding,
                        align_corners=False)
    return out.permute(0, 2, 3, 1)


def _fold(m3, h, w):
    """kornia 0.5.10 normalises with the align-corners convention and samples
    without it: a source coordinate s is read at s * w / (w - 1) - 0.5."""
    fx, fy = w / (w - 1.0), h / (h - 1.0)
    return torch.cat([m3[:, 0:1] * fx - 0.5 * m3[:, 2:3], m3[:, 1:2] * fy - 0.5 * m3[:, 2:3],
                      m3[:, 2:3]], 1)


def affine(gen, x):
    """RandomAffine(15, translate=0.1, padding_mode='border'), p=0.7."""
    b, h, w, _ = x.shape
    dev = x.device
    ang = _uniform(gen, b, -AF_DEGREES, AF_DEGREES, dev)
    tx = _uniform(gen, b, -AF_TRANSLATE, AF_TRANSLATE, dev) * w
    ty = _uniform(gen, b, -AF_TRANSLATE, AF_TRANSLATE, dev) * h
    a = ang * (math.pi / 180.0)  # the inverse rotates by +angle about the centre
    cos, sin = torch.cos(a), torch.sin(a)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    c0 = -cos * (cx + tx) + sin * (cy + ty) + cx
    f0 = -sin * (cx + tx) - cos * (cy + ty) + cy
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    m = torch.stack([torch.stack([cos, -sin, c0], -1), torch.stack([sin, cos, f0], -1),
                     torch.stack([zero, zero, one], -1)], 1)
    return _coin(gen, AF_P, _warp(x, _fold(m, h, w), "border"), x)


def _homography(src, dst):
    """H (B, 3, 3), h33 = 1, with dst ~ H src for four points (B, 4, 2)."""
    x, y, u, v = src[..., 0], src[..., 1], dst[..., 0], dst[..., 1]
    o, z = torch.ones_like(x), torch.zeros_like(x)
    a = torch.cat([torch.stack([x, y, o, z, z, z, -u * x, -u * y], -1),
                   torch.stack([z, z, z, x, y, o, -v * x, -v * y], -1)], 1)
    p = torch.linalg.solve(a.double(), torch.cat([u, v], 1)[..., None].double())[..., 0].float()
    return torch.cat([p, torch.ones_like(p[:, :1])], 1).reshape(-1, 3, 3)


def perspective(gen, x):
    """RandomPerspective(0.7, p=0.7): corners moved inward by U(0, 0.35 side)."""
    b, h, w, _ = x.shape
    dev = x.device
    base = torch.tensor([[0.0, 0.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0], [0.0, h - 1.0]],
                        device=dev)
    signs = torch.tensor([[1.0, 1.0], [-1.0, 1.0], [-1.0, -1.0], [1.0, -1.0]], device=dev)
    half = torch.tensor([float(w), float(h)], device=dev) * (PE_DISTORTION / 2.0)
    start = base.expand(b, 4, 2)
    end = start + torch.rand(b, 4, 2, generator=gen, device=dev) * half * signs
    return _coin(gen, PE_P, _warp(x, _fold(_homography(end, start), h, w), "zeros"), x)


def rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(-1)
    mx, mn = rgb.amax(-1), rgb.amin(-1)
    d = mx - mn
    s = torch.where(mx > 0, d / mx.clamp_min(1e-8), torch.zeros_like(mx))
    sd = d.clamp_min(1e-8)
    rc, gc, bc = (mx - r) / sd, (mx - g) / sd, (mx - b) / sd
    hh = torch.where(mx == r, bc - gc, torch.where(mx == g, 2.0 + rc - bc, 4.0 + gc - rc))
    hh = torch.where(d > 0, torch.remainder(hh / 6.0, 1.0), torch.zeros_like(hh))
    return hh, s, mx


def hsv_to_rgb(hh, s, v):
    i = torch.floor(hh * 6.0)
    f = hh * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)], -1)


def jitter(gen, x):
    """ColorJitter(saturation=0.1, hue=0.1), p=0.7; brightness and contrast 1."""
    b = x.shape[0]
    sf = _uniform(gen, b, 1 - JI_SATURATION, 1 + JI_SATURATION, x.device)
    hf = _uniform(gen, b, -JI_HUE, JI_HUE, x.device)
    hh, s, v = rgb_to_hsv(x)
    out = hsv_to_rgb(torch.remainder(hh + hf[:, None, None], 1.0),
                     (s * sf[:, None, None]).clamp(0.0, 1.0), v)
    return _coin(gen, JI_P, out, x)


def erasing(gen, x):
    """RandomErasing(p=0.7, same_on_batch=True): one box of zeros for the batch."""
    _, h, w, _ = x.shape
    dev = x.device
    (s0, s1), (r0, r1) = ER_SCALE, ER_RATIO
    area = _uniform(gen, 1, s0, s1, dev) * h * w
    a1, a2 = _uniform(gen, 1, r0, 1.0, dev), _uniform(gen, 1, 1.0, r1, dev)
    aspect = torch.where(torch.round(torch.rand(1, generator=gen, device=dev)).bool(), a1, a2)
    eh = torch.round(torch.sqrt(area * aspect)).clamp(1, h)
    ew = torch.round(torch.sqrt(area / aspect)).clamp(1, w)
    y0 = torch.rand(1, generator=gen, device=dev) * (h - eh + 1)
    x0 = torch.rand(1, generator=gen, device=dev) * (w - ew + 1)
    gy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    inside = (gx >= x0) & (gx <= x0 + ew - 1) & (gy >= y0) & (gy <= y0 + eh - 1)
    return _coin(gen, ER_P, torch.where(inside[..., None], torch.zeros((), device=dev), x), x)


def _max_pool_axis(x, size, dim):
    """Adaptive max pooling along `dim` of NHWC x: window i is
    [floor(i n / size), ceil((i + 1) n / size)), its maximum a chain of
    pairwise maxima in window order. A pairwise maximum of two equal values
    passes half the gradient to each (jnp.maximum's rule, which the
    configuration's cutouts keep); a window shorter than the longest repeats
    its last element, which passes that element its whole gradient."""
    n = x.shape[dim]
    start = torch.tensor([(i * n) // size for i in range(size)], device=x.device)
    end = torch.tensor([-((-(i + 1) * n) // size) for i in range(size)], device=x.device)
    out = x.index_select(dim, start)
    for k in range(1, int((end - start).max())):
        out = torch.maximum(out, x.index_select(dim, torch.minimum(start + k, end - 1)))
    return out


def cutouts(gen, img, size, cutn, noise_dtype):
    """img (B, H, W, 3) in [0, 1] -> (cutn * B, size, size, 3): (adaptive
    average + adaptive max pool) / 2 to `size`, repeated cutn-major, Af, Pe,
    Ji, Er, then noise U(0, 0.1) x N(0, 1) per cutout (drawn in `noise_dtype`,
    the dtype the configuration's cutouts run in)."""
    avg = F.adaptive_avg_pool2d(img.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
    mx = _max_pool_axis(_max_pool_axis(img, size, 1), size, 2)
    x = ((avg + mx) / 2.0).repeat(cutn, 1, 1, 1)
    for aug in (affine, perspective, jitter, erasing):
        x = aug(gen, x)
    n = x.shape[0]
    fac = (torch.rand(n, 1, 1, 1, generator=gen, device=x.device) * NOISE_FAC).to(noise_dtype)
    noise = torch.randn(x.shape, generator=gen, device=x.device, dtype=noise_dtype)
    return x + fac.float() * noise.float()


# -- the step --------------------------------------------------------------------

def normalize(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def image_loss(sds, h, img, gen, cfg, cutn, noise_dtype, P: Precision = EXACT, cut=None):
    """The loss of images img (B, H, W, 3) for text embeddings h: cutouts (or
    `cut(img)`), the image tower, the squared spherical distance's mean."""
    c = cfg["clip"]
    x = cut(img) if cut else cutouts(gen, img, c["image_size"], cutn, noise_dtype)
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    emb = normalize(clip_image(sds["clip"], (x - mean) / std, c, P, act=R.clip_act(cfg)))
    d = (normalize(h).repeat(cutn, 1) - emb).norm(dim=-1)
    return (2.0 * torch.arcsin((d / 2.0).clamp(0.0, 1.0)).square()).mean()


def render(sds, params, tokens, cfg, P: Precision = EXACT, codes=None):
    """-> (h, images) of a step: text embeddings (no gradient), and the mapper's
    latents through the straight-through VQ (`codes` (B, S, S), where given,
    are the rows it takes in place of its own search) and the decoder,
    differentiable in `params`."""
    c, m, v = cfg["clip"], cfg["mapper"], cfg["vqgan"]
    cb = sds["vqgan"]["quantize.embedding.weight"].float()
    with torch.no_grad():
        h = R.clip_text(sds["clip"], tokens, c, P, act=R.clip_act(cfg))
    z = ClampWithGrad.apply(R.mapper(params, h, m, v["embed_dim"], P), cb.min(), cb.max())
    with torch.no_grad():
        idx = R.codebook_indices(z.detach(), cb, P) if codes is None else codes
    zq = z + (cb[idx] - z).detach()
    return h, ClampWithGrad.apply((R.vqgan_decode(sds["vqgan"], zq, v, P) + 1.0) / 2.0, 0.0, 1.0)


def loss_fn(sds, params, tokens, gen, cfg, cutn, noise_dtype, P: Precision = EXACT, cut=None,
            codes=None):
    """The step's loss, differentiable in the mapper's `params`."""
    h, img = render(sds, params, tokens, cfg, P, codes)
    return image_loss(sds, h, img, gen, cfg, cutn, noise_dtype, P, cut)


def train3(sds, batches, gen_for, codes, images, cfg, cutn, noise_dtype, lr,
           P: Precision = EXACT):
    """Three Adam steps from the benchmark's mapper weights -> (the first
    step's gradient by leaf, each leaf's change over the three steps, the
    images each step decoded).

    Step k goes through the program's codebook rows `codes[k]`. Its gradient
    takes the loss's gradient with respect to the images at the program's
    images `images[k]` (cutouts drawn from `gen_for(k)`), then the
    reference's decoder and mapper backward. The cutouts' max pooling routes its gradient
    by which pixel of a window is largest, and bfloat16 images tie where float32
    ones do not; at the program's images both see the same ties."""
    params = {k: t.detach().clone().float().requires_grad_(True) for k, t in sds["mapper"].items()}
    mu = {k: torch.zeros_like(t) for k, t in params.items()}
    nu = {k: torch.zeros_like(t) for k, t in params.items()}
    first, own = None, []
    for step, (tokens, idx, img_prog) in enumerate(zip(batches, codes, images), start=1):
        h, img = render(sds, params, tokens, cfg, P, idx)
        at = img_prog.detach().float().requires_grad_(True)
        (dimg,) = torch.autograd.grad(
            image_loss(sds, h, at, gen_for(step - 1), cfg, cutn, noise_dtype, P), at)
        grads = torch.autograd.grad(img, list(params.values()), grad_outputs=dimg)
        own.append(img.detach())
        with torch.no_grad():
            if first is None:
                first = {k: g.clone() for k, g in zip(params, grads)}
            for (k, p), g in zip(params.items(), grads):
                mu[k].mul_(B1).add_(g, alpha=1 - B1)
                nu[k].mul_(B2).add_(g * g, alpha=1 - B2)
                upd = (mu[k] / (1 - B1 ** step)) / ((nu[k] / (1 - B2 ** step)).sqrt() + EPS)
                p.add_(upd, alpha=-lr)
    change = {k: (p.detach() - sds["mapper"][k].float()) for k, p in params.items()}
    return first, change, own

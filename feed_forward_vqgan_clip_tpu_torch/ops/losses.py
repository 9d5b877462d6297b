"""Loss terms of the train step: squared spherical CLIP distance, total
variation, L2 and the VGG-feature diversity term.

Port of feed_forward_vqgan_clip_tpu/ops/losses.py (`normalize`,
`spherical_dist`, `spherical_dist_loss`, `tv_loss`, `l2_loss`,
`normalize_tensor`, `diversity_loss`). The feature maps of the diversity term
are NCHW here (models/vgg.py), NHWC in the JAX package: the channel axis is 1.
"""

import torch


def normalize(x):
    """F.normalize parity: x / max(||x||, 1e-12) along the last axis."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / n.clamp_min(1e-12)


def spherical_dist(a, b):
    """Per-row squared spherical distance 2*arcsin(||a-b||/2)^2 between unit vectors
    (the reference's `H.sub(embed).norm(-1).div(2).arcsin().pow(2).mul(2)`)."""
    d = torch.linalg.vector_norm(a - b, dim=-1)
    # ||a-b||/2 can exceed 1 by float error for antipodal points
    return 2.0 * torch.arcsin((d / 2.0).clamp(0.0, 1.0)).square()


def spherical_dist_loss(a, b):
    """Mean squared spherical distance (the training `dists` term)."""
    return spherical_dist(a, b).mean()


def tv_loss(x):
    """Total variation 0.5 * (mean |dH| + mean |dW|) of NHWC images."""
    dh = (x[:, 1:, :, :] - x[:, :-1, :, :]).abs().mean()
    dw = (x[:, :, 1:, :] - x[:, :, :-1, :]).abs().mean()
    return 0.5 * (dh + dw)


def l2_loss(z):
    """Mean squared latent magnitude."""
    return z.square().mean()


def normalize_tensor(feats, eps=1e-10):
    """Channel-wise unit-normalised NCHW feature maps: feats / (||feats||_C + eps)
    (taming's `normalize_tensor`)."""
    return feats / (torch.linalg.vector_norm(feats, dim=1, keepdim=True) + eps)


def diversity_loss(feature_maps, repeat: int, bs: int, mode: str = "between_same_prompts"):
    """The diversity term over a list of NCHW feature maps (repeat*bs, C, H, W),
    laid out repeat-major (the reference's `.repeat(repeat, 1)`): per map, the
    channel-summed squared difference of the normalised features averaged over
    every ordered pair of samples and every position, summed over the maps.
    "between_same_prompts" pairs the repeats of each prompt, "all" every two
    samples. Each unordered pair is formed once (the diagonal adds 0, and
    (i, j) adds what (j, i) does), so no (n, n, ...) tensor is built."""
    if mode not in ("between_same_prompts", "all"):
        raise ValueError("diversity_mode should be 'between_same_prompts' or 'all'")
    div = 0.0
    for feats in feature_maps:
        f = normalize_tensor(feats)
        n, _, hh, ww = f.shape
        if mode == "between_same_prompts":
            f = f.reshape(repeat, bs, *f.shape[1:])
            count = repeat * repeat * bs * hh * ww
        else:
            count = n * n * hh * ww
        i, j = torch.triu_indices(len(f), len(f), 1, device=f.device)
        div = div + 2.0 * (f[i] - f[j]).square().sum() / count
    return div

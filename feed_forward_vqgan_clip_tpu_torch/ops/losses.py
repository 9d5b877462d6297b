"""Loss terms of the train step: squared spherical CLIP distance, total
variation and L2.

Port of feed_forward_vqgan_clip_tpu/ops/losses.py (`normalize`,
`spherical_dist`, `spherical_dist_loss`, `tv_loss`, `l2_loss`). The diversity
loss needs the VGG16 features (ROADMAP A16).
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

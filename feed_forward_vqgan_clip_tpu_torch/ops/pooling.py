"""Adaptive average / max pooling for NHWC images.

Port of feed_forward_vqgan_clip_tpu/ops/pooling.py. The reference's cutout
module uses torch's AdaptiveAvgPool2d / AdaptiveMaxPool2d, and the JAX file
reproduces their windows (output cell i covers [floor(i*in/out),
ceil((i+1)*in/out))) with matmul formulations chosen for the TPU. Here they are
torch's own pools, through an NCHW view. Values agree with the JAX functions;
gradients agree except where a max-pool window holds two equal maxima (torch
sends the gradient to one of them, the JAX formulation splits it).
"""

import torch.nn.functional as F


def adaptive_avg_pool(x, size: int):
    """x (B, H, W, C) -> (B, size, size, C) in x's dtype."""
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)


def adaptive_max_pool(x, size: int):
    """x (B, H, W, C) -> (B, size, size, C) in x's dtype."""
    return F.adaptive_max_pool2d(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)

"""Nearest-codebook vector quantization with a straight-through gradient.

Port of feed_forward_vqgan_clip_tpu/ops/quantize.py: expanded-L2 nearest
neighbour over the codebook with first-match tie-breaking; the forward value is
the code row, the backward is identity to the latent. On a CUDA tensor the index
search is the kernel of ops/kernels/vq_lookup.py; on a CPU tensor it is
`nearest_codebook_indices`, the JAX package's XLA path.
"""

import torch

from feed_forward_vqgan_clip_tpu_torch.ops.grad_ops import replace_grad
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.vq_lookup import (
    nearest_codebook_indices_kernel,
)


def nearest_codebook_indices(x, codebook):
    """argmin_k |x - codebook_k|^2 over the last axis: x (..., C), codebook (K, C)
    -> int32 (...,). The expanded form |x|^2 + |c|^2 - 2 x.c of the reference;
    argmin keeps the first minimum."""
    x2 = x.square().sum(-1, keepdim=True)
    c2 = codebook.square().sum(-1)
    d = x2 + c2 - 2.0 * torch.einsum("...c,kc->...k", x, codebook)
    return d.argmin(-1).to(torch.int32)


@torch.no_grad()
def quantize_indices(x, codebook):
    """Nearest-codebook int32 indices for x (..., C); no gradient flows through.

    CUDA: the VQ kernel on float32 copies of x and the codebook. CPU: the expanded
    L2 above."""
    if x.device.type == "cpu":
        return nearest_codebook_indices(x, codebook)
    flat = x.reshape(-1, x.shape[-1]).float()
    idx = nearest_codebook_indices_kernel(flat, codebook.float())
    return idx.reshape(x.shape[:-1])


def vector_quantize(x, codebook):
    """Quantize x (..., C) to its nearest codebook rows with a straight-through
    gradient: forward codebook[argmin], backward identity to x."""
    idx = quantize_indices(x, codebook)
    x_q = codebook[idx.long()].to(x.dtype)
    return replace_grad(x_q, x)

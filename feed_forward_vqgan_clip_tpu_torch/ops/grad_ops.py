"""Straight-through gradient ops as torch.autograd.Functions.

Port of feed_forward_vqgan_clip_tpu/ops/grad_ops.py (the reference's ReplaceGrad
and ClampWithGrad pair).
"""

import torch


class _ReplaceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_forward, x_backward):
        ctx.shape = x_backward.shape
        # the JAX op's arithmetic, x_b + (x_f - x_b), so values match it bit for bit
        return x_backward + (x_forward - x_backward)

    @staticmethod
    def backward(ctx, grad):
        return None, grad.sum_to_size(ctx.shape)


def replace_grad(x_forward, x_backward):
    """Forward `x_forward`; route the whole gradient to `x_backward`, summed to its
    shape where it was broadcast."""
    return _ReplaceGrad.apply(x_forward, x_backward)


class _ClampWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        y = torch.clamp(x, lo, hi)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, y = ctx.saved_tensors
        return grad * (grad * (x - y) >= 0).to(grad.dtype), None, None


def clamp_with_grad(x, lo, hi):
    """Clamp to [lo, hi]; the gradient passes where ``g * (x - clamp(x)) >= 0``, so it
    is zeroed only where it would push an out-of-range input further out."""
    return _ClampWithGrad.apply(x, lo, hi)

"""Kernel dispatch for the MLP-Mixer mapper, inference and train.

Port of feed_forward_vqgan_clip_tpu/models/mappers/fused.py: on a CUDA tensor
every Mixer block is one call of the block kernels (ops/kernels/mixer_block.py),
`mixer_block` for inference and the differentiable `MixerBlockTrain` for
training; on a CPU tensor the module runs as it is. The TPU's gates (VMEM budget,
Mosaic alignment, interpret mode) have no counterpart: the kernels take any shape.
"""

import torch

from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import Mixer
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
    MixerBlockTrain,
    mixer_block,
)


def fused_mixer_forward(mapper: Mixer, x, block_weights):
    """Deterministic Mixer forward with each block through `mixer_block`.

    Mirrors Mixer.forward, channel-major view quirk included. `block_weights`:
    one MixerBlockWeights per block, in the mapper's compute dtype."""
    h = mapper.embed(x)
    for w in block_weights:
        h = mixer_block(h, w)
    return mapper.head(h)


def make_mapper_apply(mapper: Mixer):
    """x -> z for deterministic (inference) forwards of `mapper`.

    CUDA input goes through the block kernel; the blocks' weights are cast to the
    compute dtype once, at the first CUDA call, so later changes to the mapper's
    parameters need a new apply function. CPU input runs the module."""
    weights = {}

    @torch.no_grad()
    def apply_fn(x):
        if x.device.type != "cuda":
            return mapper(x)
        if x.device not in weights:
            weights[x.device] = [b.kernel_weights(mapper.dtype) for b in mapper.blocks]
        return fused_mixer_forward(mapper, x, weights[x.device])

    return apply_fn


def fused_mixer_train_forward(mapper: Mixer, x):
    """Differentiable Mixer forward with each block through `MixerBlockTrain`
    (forward-with-residuals kernels, channel and token backward kernels). The
    dense and LayerNorm layers around the blocks autodiff as usual. Only for
    deterministic forwards (dropout == 0)."""
    h = mapper.embed(x)
    for block in mapper.blocks:
        h = MixerBlockTrain.apply(h, mapper.dtype, *block.train_weights())
    return mapper.head(h)


def make_mapper_train_apply(mapper: Mixer):
    """x -> z for differentiable deterministic forwards (the train step's
    dropout == 0 path): CUDA input through the block kernels, CPU input through
    the module. Unlike `make_mapper_apply` nothing is cached across calls: the
    parameters change every step, and each forward casts them anew."""

    def apply_fn(x):
        if x.device.type != "cuda":
            return mapper(x)
        return fused_mixer_train_forward(mapper, x)

    return apply_fn

"""Inference dispatch for the MLP-Mixer mapper.

Port of the inference half of feed_forward_vqgan_clip_tpu/models/mappers/fused.py
(`fused_mixer_forward`, `make_mapper_apply`): on a CUDA tensor every Mixer block
is one call of the block kernel (ops/kernels/mixer_block.py); on a CPU tensor the
module runs as it is. The TPU's gates (VMEM budget, Mosaic alignment, interpret
mode) have no counterpart: the kernels take any shape.
"""

import torch

from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import Mixer
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import mixer_block


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

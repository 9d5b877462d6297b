"""Kernel dispatch for the MLP-Mixer mapper, inference and train.

Port of feed_forward_vqgan_clip_tpu/models/mappers/fused.py: on a CUDA tensor
every Mixer block is one call of the block kernels (ops/kernels/mixer_block.py),
`mixer_block` for inference and the differentiable `MixerBlockTrain` for
training; on a CPU tensor the module runs as it is. The other mapper families
(VitGAN, x-transformer) have no kernel: `fused_supported` sends them through
their modules on every device, as the JAX gate does. The streamed forward
(`streamed_mixer_forward`, the small-request serving path) runs the whole block
stack as one launch of ops/kernels/mixer_stream.py (K4) over weights stacked and
folded once per loaded model; `stacked_mixer_forward` runs the same stacked
weights block by block (`mixer_block_stacked`, K5). On a CPU tensor both run
their kernels' plain versions. The TPU's gates (VMEM budget, Mosaic alignment,
interpret mode) have no counterpart: the kernels take any shape.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import Dropout, Mixer, lean_layer_norm
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
    MixerBlockTrain,
    StackedMixerWeights,
    mixer_block,
    mixer_block_stacked,
    stack_mixer_params,
)
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_stream import mixer_stream

# batches of at most this many rows take the whole-stack launch; the JAX
# Predictor's rule (n <= 8), where the TPU's depth-streaming kernel wins
STREAM_MAX_BATCH = 8


def fused_mixer_forward(mapper: Mixer, x, block_weights):
    """Deterministic Mixer forward with each block through `mixer_block`.

    Mirrors Mixer.forward, channel-major view quirk included. `block_weights`:
    one MixerBlockWeights per block, in the mapper's compute dtype."""
    h = mapper.embed(x)
    for w in block_weights:
        h = mixer_block(h, w)
    return mapper.head(h)


def fused_supported(mapper) -> bool:
    """The block kernels take a Mixer of any shape, but whole weight tensors: a
    Mixer split for tensor parallelism (parallel/tensor_parallel.py marks it
    `tp`) and every other mapper run as modules."""
    return isinstance(mapper, Mixer) and getattr(mapper, "tp", None) is None


def make_mapper_apply(mapper):
    """x -> z for deterministic (inference) forwards of `mapper`.

    CUDA input to a Mixer goes through the block kernel; the blocks' weights are
    cast to the compute dtype once, at the first CUDA call, so later changes to
    the mapper's parameters need a new apply function. CPU input, and every
    other mapper, runs the module."""
    weights = {}
    fused = fused_supported(mapper)

    @torch.no_grad()
    def apply_fn(x):
        if x.device.type != "cuda" or not fused:
            return mapper(x)
        if x.device not in weights:
            weights[x.device] = [b.kernel_weights(mapper.dtype) for b in mapper.blocks]
        return fused_mixer_forward(mapper, x, weights[x.device])

    return apply_fn


class StreamedMixerParams(NamedTuple):
    """`prepare_streamed_params`' output: the layers around the blocks (`head`:
    proj, embed, final norm and final_proj as {name: tensor} in the compute
    dtype, norms float32) and the blocks' stacked, LN2-folded weights."""

    head: dict
    stack: StackedMixerWeights


def streamed_supported(mapper) -> bool:
    """The streamed forward serves a Mixer mapper whose forwards are
    deterministic (dropout 0). The TPU's VMEM gate has no counterpart."""
    return fused_supported(mapper) and all(
        m.p == 0 for m in mapper.modules() if isinstance(m, Dropout))


@torch.no_grad()
def prepare_streamed_params(mapper: Mixer) -> StreamedMixerParams:
    """Stack and fold the mapper's weights once, on the mapper's device and in its
    compute dtype (about 570 MB at the flagship in bf16). Later changes to the
    mapper's parameters need new streamed params."""
    dt = mapper.dtype
    mat = lambda p: p.detach().to(dt).contiguous()  # noqa: E731
    final_norm = mapper.mixer[2 + mapper.depth]
    head = {
        "proj_w": mat(mapper.proj.weight), "proj_b": mat(mapper.proj.bias),
        "embed_w": mat(mapper.mixer[1].weight), "embed_b": mat(mapper.mixer[1].bias),
        "norm_w": final_norm.weight.detach().float(), "norm_b": final_norm.bias.detach().float(),
        "final_w": mat(mapper.final_proj.weight), "final_b": mat(mapper.final_proj.bias),
    }
    stack = stack_mixer_params([b.kernel_weights(torch.float32) for b in mapper.blocks], dt)
    return StreamedMixerParams(head, stack)


def _around_blocks(mapper: Mixer, head: dict, x, blocks):
    """Mixer.forward's layers around the blocks (the channel-major view quirk
    included) on the prepared `head`, with `blocks(h)` between them."""
    dt = mapper.dtype
    h = F.linear(x.to(dt), head["proj_w"], head["proj_b"])
    h = mapper.mixer[0](h)
    h = blocks(F.linear(h, head["embed_w"], head["embed_b"]))
    h = lean_layer_norm(h, head["norm_w"], head["norm_b"], dt)
    h = F.linear(h, head["final_w"], head["final_b"])
    s = mapper.image_size
    return h.reshape(h.shape[0], s, s, mapper.channels)


@torch.no_grad()
def streamed_mixer_forward(mapper: Mixer, stream_params: StreamedMixerParams, x):
    """Small-request forward: the whole block stack as one `mixer_stream`
    launch on a CUDA tensor, its plain version on a CPU tensor.
    `stream_params`: `prepare_streamed_params(mapper)`."""
    return _around_blocks(mapper, stream_params.head, x,
                          lambda h: mixer_stream(h, stream_params.stack))


@torch.no_grad()
def stacked_mixer_forward(mapper: Mixer, stream_params: StreamedMixerParams, x):
    """The same function block by block: one `mixer_block_stacked` call per
    block, on views into the stacked weights."""
    def blocks(h):
        for i in range(mapper.depth):
            h = mixer_block_stacked(h, stream_params.stack, i)
        return h

    return _around_blocks(mapper, stream_params.head, x, blocks)


def make_streamed_mixer_apply(mapper: Mixer):
    """x -> z over the stacked weights, prepared once here: at most
    STREAM_MAX_BATCH rows through `streamed_mixer_forward` (one launch for the
    stack), more through `stacked_mixer_forward` (one launch per block), so
    that one weight layout serves every batch."""
    spp = prepare_streamed_params(mapper)

    def apply_fn(x):
        if len(x) <= STREAM_MAX_BATCH:
            return streamed_mixer_forward(mapper, spp, x)
        return stacked_mixer_forward(mapper, spp, x)

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


def make_mapper_train_apply(mapper):
    """x -> z for differentiable deterministic forwards (the train step's
    dropout == 0 path): CUDA input to a Mixer through the block kernels, CPU
    input and every other mapper through the module. Unlike `make_mapper_apply`
    nothing is cached across calls: the parameters change every step, and each
    forward casts them anew."""
    fused = fused_supported(mapper)

    def apply_fn(x):
        if x.device.type != "cuda" or not fused:
            return mapper(x)
        return fused_mixer_train_forward(mapper, x)

    return apply_fn

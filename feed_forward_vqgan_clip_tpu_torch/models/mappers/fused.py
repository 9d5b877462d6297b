"""Kernel dispatch for the MLP-Mixer mapper, inference and train.

Port of feed_forward_vqgan_clip_tpu/models/mappers/fused.py. `mapper_route` is
the one rule for which kernels run an inference forward, and `make_mapper_apply`,
the apply the Generator and the Predictor both build, follows it call by call:
on a CUDA tensor a Mixer of at most STREAM_MAX_BATCH rows runs its whole block
stack as one launch of ops/kernels/mixer_stream.py (K4) over weights stacked and
LN2-folded once (`streamed_mixer_forward`), a larger batch one `mixer_block`
launch (K2) a block; on a CPU tensor, and for the other mapper families
(VitGAN, x-transformer), which have no kernel, the module runs as it is, as in
the JAX Predictor. Training runs each block through the differentiable
`MixerBlockTrain`. The TPU's gates (VMEM budget, Mosaic alignment, interpret
mode) have no counterpart: the kernels take any shape.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import Mixer, lean_layer_norm
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
    MixerBlockTrain,
    StackedMixerWeights,
    mixer_block,
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


class StreamedMixerParams(NamedTuple):
    """`prepare_streamed_params`' output: the layers around the blocks (`head`:
    proj, embed, final norm and final_proj as {name: tensor} in the compute
    dtype, norms float32) and the blocks' stacked, LN2-folded weights."""

    head: dict
    stack: StackedMixerWeights


def streamed_supported(mapper) -> bool:
    """The streamed forward serves a Mixer mapper whose forwards are
    deterministic (dropout 0). The TPU's VMEM gate has no counterpart."""
    return fused_supported(mapper) and mapper.dropout == 0


def mapper_route(mapper, n: int, device: torch.device) -> str:
    """Which kernels run a deterministic forward of `mapper` over n rows on
    `device`: "stream" (one K4 launch for the whole block stack) for at most
    STREAM_MAX_BATCH rows where `streamed_supported` holds, "block" (one K2
    launch a block) for more rows or dropout > 0, "module" (the mapper's own
    forward) off CUDA and wherever `fused_supported` does not hold."""
    if device.type != "cuda" or not fused_supported(mapper):
        return "module"
    if n <= STREAM_MAX_BATCH and streamed_supported(mapper):
        return "stream"
    return "block"


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


@torch.no_grad()
def streamed_mixer_forward(mapper: Mixer, stream_params: StreamedMixerParams, x):
    """Small-request forward: Mixer.forward's layers around the blocks (the
    channel-major view quirk included) on the prepared head, and the whole block
    stack as one `mixer_stream` launch on a CUDA tensor, its plain version on a
    CPU tensor. `stream_params`: `prepare_streamed_params(mapper)`."""
    dt, head = mapper.dtype, stream_params.head
    h = F.linear(x.to(dt), head["proj_w"], head["proj_b"])
    h = mapper.mixer[0](h)
    h = mixer_stream(F.linear(h, head["embed_w"], head["embed_b"]), stream_params.stack)
    h = lean_layer_norm(h, head["norm_w"], head["norm_b"], dt)
    h = F.linear(h, head["final_w"], head["final_b"])
    s = mapper.image_size
    return h.reshape(h.shape[0], s, s, mapper.channels)


def make_mapper_apply(mapper):
    """x -> z for deterministic (inference) forwards of `mapper`, each call down
    the route `mapper_route` picks for its rows and device. A route's weights
    are prepared on its first call on a device: the blocks' weights cast to the
    compute dtype for "block", `prepare_streamed_params` for "stream"; so later
    changes to the mapper's parameters need a new apply function."""
    blocks, stacks = {}, {}

    @torch.no_grad()
    def apply_fn(x):
        route = mapper_route(mapper, len(x), x.device)
        if route == "module":
            return mapper(x)
        if route == "stream":
            if x.device not in stacks:
                stacks[x.device] = prepare_streamed_params(mapper)
            return streamed_mixer_forward(mapper, stacks[x.device], x)
        if x.device not in blocks:
            blocks[x.device] = [b.kernel_weights(mapper.dtype) for b in mapper.blocks]
        return fused_mixer_forward(mapper, x, blocks[x.device])

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

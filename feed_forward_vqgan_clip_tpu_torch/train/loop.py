"""The amortized VQGAN-CLIP train step, on one device.

Port of `FrozenModels` and `make_train_step` of feed_forward_vqgan_clip_tpu/
train/loop.py: text encode (frozen CLIP, no grad; once when the input and the
target are the same tokens, `same_io`) -> `repeat` tiling (+ noise concat when
`noise_dim > 0`) -> mapper (through the Mixer train kernels on the card) ->
clamp_with_grad -> straight-through VQ -> frozen VQGAN decode -> cutouts with
augmentations in `aug_dtype` -> CLIP normalisation -> frozen CLIP image encode ->
spherical loss against the cutn-major tiled targets (+ input, L2 and TV terms)
-> backward -> Adam. Loss parity with the reference's `train`, term by term.

Randomness (augmentations, noise factors, noise rows without a bank) comes from
the torch.Generator each step is given. The mesh and shard_map paths, tensor
parallelism and the diversity term wait for ROADMAP A12 and A16; dropout > 0
and the host loop (batching, checkpoints, EMA, previews) for A10.
"""

from typing import Callable, NamedTuple, Optional

import torch

from feed_forward_vqgan_clip_tpu_torch.config import COMPUTE_DTYPES, TrainConfig
from feed_forward_vqgan_clip_tpu_torch.models.mappers.fused import make_mapper_train_apply
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import Perceptor, load_perceptor
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import VQGAN, latent_bounds, load_vqgan, synth
from feed_forward_vqgan_clip_tpu_torch.ops.cutouts import MakeCutouts
from feed_forward_vqgan_clip_tpu_torch.ops.grad_ops import clamp_with_grad
from feed_forward_vqgan_clip_tpu_torch.ops.losses import (
    l2_loss,
    normalize,
    spherical_dist_loss,
    tv_loss,
)
from feed_forward_vqgan_clip_tpu_torch.registry import CLIP_MEAN, CLIP_STD
from feed_forward_vqgan_clip_tpu_torch.train.state import TrainState

# the stages a step reports to its `mark` callback, in order
STAGES = ("text", "mapper", "decode", "cutouts", "image_tower", "loss", "backward", "adam")


class FrozenModels(NamedTuple):
    """The frozen perceptor (both CLIP towers) and VQGAN. The VGG16 of the
    diversity loss and the eval perceptor wait for ROADMAP A16 / A10."""

    perceptor: Perceptor
    vq: VQGAN


def build_frozen(cfg: TrainConfig, dtype, *, device="cuda", seed: int = 0) -> FrozenModels:
    """The frozen models: the weights at the config's `clip_model_path` and
    `vqgan_checkpoint`, else random from `seed`; their parameters do not require
    grad."""
    perceptor = load_perceptor(cfg.get("clip_model"), cfg.get("clip_model_path"), dtype=dtype,
                               device=device, seed=seed)
    return FrozenModels(perceptor, load_vqgan(cfg, dtype, device=device, seed=seed))


def make_train_step(cfg: TrainConfig, mapper, frozen: FrozenModels, make_cutouts: MakeCutouts,
                    *, inp_is_tokens: bool, out_is_tokens: bool, same_io: bool = False):
    """-> (train_step, loss_fn).

    loss_fn(batch, generator, mark=None) -> (loss, metrics), differentiable in the
    mapper's parameters; train_step(state, batch, generator, mark=None) ->
    (state, metrics) runs it, the backward and Adam, updating `state` in place.
    `batch` holds "inp" and "out" (token ids (B, 77) or features (B, dim)) and
    optionally "noise" (repeat, noise_dim) bank rows. `mark(stage)`, where given,
    is called as each stage of STAGES has been enqueued (for per-stage timing).
    Metrics are 0-d tensors on the device: loss, dists, diversity, l2, tv."""
    repeat = int(cfg.get("repeat"))
    cutn = int(cfg.get("cutn"))
    noise_dim = int(cfg.get("noise_dim") or 0)
    normalize_input = bool(cfg.get("normalize_input"))
    input_loss = bool(cfg.get("input_loss"))
    input_loss_coef = float(cfg.get("input_loss_coef"))
    target_loss_coef = float(cfg.get("target_loss_coef"))
    l2_coef = float(cfg.get("l2_coef"))
    tv_coef = float(cfg.get("tv_coef"))
    if float(cfg.get("diversity_coef")):
        raise NotImplementedError("the diversity loss needs VGG16 features (ROADMAP A16)")
    if float(cfg.get("dropout") or 0.0) > 0:
        raise NotImplementedError("dropout > 0 trains through the module path with dropout "
                                  "draws; it comes with the trainer loop (ROADMAP A10)")
    aug_dtype = COMPUTE_DTYPES[str(cfg.get("aug_dtype") or cfg.get("compute_dtype"))]
    perceptor, vq = frozen.perceptor, frozen.vq
    mapper_train_apply = make_mapper_train_apply(mapper)

    def loss_fn(batch, generator: torch.Generator, mark: Optional[Callable] = None):
        mark = mark or (lambda stage: None)
        z_lo, z_hi = latent_bounds(vq)
        inp, out = batch["inp"], batch["out"]
        bs = inp.shape[0]
        dev = inp.device
        inp_feats = perceptor.encode_text(inp).float() if inp_is_tokens else inp.float()
        # text-only datasets feed the same tokens as input and target: encode once
        if same_io:
            out_feats = inp_feats
        elif out_is_tokens:
            out_feats = perceptor.encode_text(out).float()
        else:
            out_feats = out.float()
        if normalize_input:
            inp_feats = normalize(inp_feats)
        mark("text")
        # (repeat*bs, dim), repeat-major
        inp_feats = inp_feats.repeat(repeat, 1)
        out_feats = out_feats.repeat(repeat, 1)
        if noise_dim:
            if "noise" in batch:  # fixed bank rows (repeat, noise_dim)
                noise = batch["noise"].repeat_interleave(bs, dim=0)
            else:
                noise = torch.randn(repeat * bs, noise_dim, generator=generator, device=dev)
            net_in = torch.cat([inp_feats, noise.to(inp_feats.dtype)], dim=1)
        else:
            net_in = inp_feats
        z = mapper_train_apply(net_in)  # (repeat*bs, S, S, C)
        l2 = l2_loss(z) if l2_coef > 0 else torch.zeros((), device=dev)
        mark("mapper")
        # float32: JAX's clip promotes the compute-dtype latent against f32 bounds
        z = clamp_with_grad(z.float(), z_lo, z_hi)
        xr = synth(vq, z).float()  # (repeat*bs, H, W, 3)
        tv = tv_loss(xr) if tv_coef > 0 else torch.zeros((), device=dev)
        mark("decode")
        x = make_cutouts(generator, xr.to(aug_dtype))  # (cutn*repeat*bs, h, w, 3)
        mean = torch.tensor(CLIP_MEAN, device=dev).to(aug_dtype)
        std = torch.tensor(CLIP_STD, device=dev).to(aug_dtype)
        x = (x - mean) / std
        mark("cutouts")
        embed = normalize(perceptor.encode_image(x).float())
        mark("image_tower")
        h = normalize(out_feats.repeat(cutn, 1))  # (cutn*repeat*bs, dim), cutn-major
        dists = target_loss_coef * spherical_dist_loss(h, embed)
        if input_loss:
            hi = normalize(inp_feats.repeat(cutn, 1))
            dists = dists + input_loss_coef * spherical_dist_loss(hi, embed)
        loss = dists + l2_coef * l2 + tv_coef * tv
        mark("loss")
        metrics = {"loss": loss, "dists": dists, "diversity": torch.zeros((), device=dev),
                   "l2": l2, "tv": tv}
        return loss, {k: v.detach().float() for k, v in metrics.items()}

    def train_step(state: TrainState, batch, generator: torch.Generator,
                   mark: Optional[Callable] = None):
        mark = mark or (lambda stage: None)
        for p in state.params:
            p.grad = None
        loss, metrics = loss_fn(batch, generator, mark)
        loss.backward()
        mark("backward")
        state.apply_gradients()
        # the loss EMA stays on the device: no host sync per step
        state.avg_loss = metrics["loss"] * 0.01 + state.avg_loss * 0.99
        mark("adam")
        return state, metrics

    return train_step, loss_fn

"""Mapper factory: the port of feed_forward_vqgan_clip_tpu/models/mappers/__init__.py.

Only the MLP-Mixer is ported so far; the VitGAN and x-transformer mappers are
ROADMAP A14.
"""

import torch

from feed_forward_vqgan_clip_tpu_torch.registry import CLIP_DIM
from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import Mixer


def build_mapper(config: dict, *, vq_channels: int = 256, dtype=torch.float32, device=None):
    """config: the training-config keys the JAX `build_mapper` reads.

    input dim = clip_dim + noise_dim; out channels = VQGAN z_channels;
    vq_image_size defaults to 16."""
    clip_model = config["clip_model"]
    clip_dim = int(config.get("clip_dim") or CLIP_DIM.get(clip_model, 512))
    noise_dim = int(config.get("noise_dim") or 0)
    model_type = config["model_type"]
    if model_type != "mlp_mixer":
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported yet (ROADMAP A14); the port has 'mlp_mixer'"
        )
    return Mixer(
        input_dim=clip_dim + noise_dim,
        image_size=int(config.get("vq_image_size") or 16),
        channels=vq_channels,
        dim=int(config["dim"]),
        depth=int(config["depth"]),
        dropout=float(config.get("dropout") or 0.0),
        dtype=dtype,
        device=device,
    )

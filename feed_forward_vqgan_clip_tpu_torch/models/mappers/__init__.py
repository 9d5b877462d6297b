"""Mapper factory: the port of feed_forward_vqgan_clip_tpu/models/mappers/__init__.py."""

import torch

from feed_forward_vqgan_clip_tpu_torch.registry import CLIP_DIM
from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import Mixer
from feed_forward_vqgan_clip_tpu_torch.models.mappers.vitgan import Generator, SimpleGenerator
from feed_forward_vqgan_clip_tpu_torch.models.mappers.xtransformer import XTransformer

MAPPER_TYPES = ("mlp_mixer", "vitgan", "simple_vitgan", "xtransformer")


def build_mapper(config: dict, *, vq_channels: int = 256, dtype=torch.float32, device=None):
    """config: the training-config keys the JAX `build_mapper` reads.

    input dim = clip_dim + noise_dim; out channels = VQGAN z_channels;
    vq_image_size defaults to 16, num_heads to 6; the VitGAN Generator has
    vq_image_size // 8 as its initialize_size."""
    clip_model = config["clip_model"]
    clip_dim = int(config.get("clip_dim") or CLIP_DIM.get(clip_model, 512))
    input_dim = clip_dim + int(config.get("noise_dim") or 0)
    vq_image_size = int(config.get("vq_image_size") or 16)
    model_type = config["model_type"]
    dim, depth = int(config["dim"]), int(config["depth"])
    dropout = float(config.get("dropout") or 0.0)
    num_heads = int(config.get("num_heads") or 6)
    kw = dict(dtype=dtype, device=device)

    if model_type == "vitgan":
        return Generator(vq_image_size // 8, input_dim, dim, depth, num_heads, dropout,
                         vq_channels, **kw)
    if model_type == "simple_vitgan":
        return SimpleGenerator(vq_image_size, input_dim, dim, depth, num_heads, dropout,
                               vq_channels, **kw)
    if model_type == "mlp_mixer":
        return Mixer(input_dim, vq_image_size, vq_channels, dim, depth, dropout=dropout, **kw)
    if model_type == "xtransformer":
        return XTransformer(input_dim, vq_image_size, vq_channels, dim, depth, heads=num_heads,
                            initial_proj=bool(config.get("initial_proj", True)),
                            add_input=bool(config.get("add_input", False)), dropout=dropout,
                            **kw)
    raise ValueError(
        "model_type should be 'vitgan', 'simple_vitgan', 'mlp_mixer' or 'xtransformer'")

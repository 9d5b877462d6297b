"""Configuration: the knobs the train step, the checkpoint loader and the
serving path read, under the reference's names.

The port's own copy of the matching entries of feed_forward_vqgan_clip_tpu/
config.py (`DEFAULTS`, `TrainConfig`, `make_config`, `vqgan_arch_config` for
the presets and inline dicts). Other knobs pass through `make_config` unread.
Reading YAML configs and taming's VQGAN YAML come with the trainer (ROADMAP A10).
"""

from typing import Any, Dict

import torch

from feed_forward_vqgan_clip_tpu_torch.registry import VQGAN_CONFIGS

# knob -> default (the reference's config.get(...) defaults), for the knobs the
# port's train step, mapper and frozen-model builders read
DEFAULTS: Dict[str, Any] = {
    "repeat": 1,
    "cutn": 8,
    "noise_dim": 0,
    "model_type": "mlp_mixer",
    "dim": 128,
    "depth": 8,
    "dropout": 0.0,
    "vq_image_size": 16,
    "vqgan_model": "vqgan_imagenet_f16_16384",
    "vqgan_arch": None,  # inline ddconfig-style dict (smoke configs)
    "vqgan_config": None,  # taming YAML (read by the JAX package; ROADMAP A10 here)
    "vqgan_checkpoint": None,  # taming .ckpt / state dict; None: random init
    "clip_model": "ViT-B/32",
    "clip_model_path": None,  # OpenAI-named CLIP state dict; None: random init
    "clip_dim": None,
    "diversity_coef": 0.0,
    "input_loss": False,
    "input_loss_coef": 1.0,
    "target_loss_coef": 1.0,
    "l2_coef": 0.0,
    "tv_coef": 0.0,
    "normalize_input": False,
    "compute_dtype": "bfloat16",
    "aug_dtype": None,  # cutout/augment stage dtype: None follows compute_dtype
}


class TrainConfig(dict):
    """dict with reference-style .get defaulting and attribute access."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def get(self, key, default=None):
        if key in self:
            return super().get(key)
        if default is not None:
            return default
        return DEFAULTS.get(key, default)


COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg: TrainConfig):
    """The torch dtype of the config's `compute_dtype`."""
    return COMPUTE_DTYPES[str(cfg.get("compute_dtype", "bfloat16"))]


def make_config(**overrides) -> TrainConfig:
    cfg = TrainConfig(DEFAULTS)
    cfg.update(overrides)
    return cfg


def vqgan_arch_config(cfg: TrainConfig) -> dict:
    """The VQGAN architecture dict: an inline `vqgan_arch` over the f16-16384
    preset, else the `vqgan_model` preset."""
    inline = cfg.get("vqgan_arch")
    if isinstance(inline, dict):
        base = dict(VQGAN_CONFIGS["vqgan_imagenet_f16_16384"])
        base.update(inline)
        base["ch_mult"] = tuple(base["ch_mult"])
        base["attn_resolutions"] = tuple(base["attn_resolutions"])
        return base
    return dict(VQGAN_CONFIGS[cfg.get("vqgan_model") or "vqgan_imagenet_f16_16384"])

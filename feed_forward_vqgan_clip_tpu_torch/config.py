"""Configuration: the reference's yaml knob surface, under the reference's names.

The port's own copy of feed_forward_vqgan_clip_tpu/config.py (`DEFAULTS`,
`TrainConfig`, `load_config`, `make_config`, `vqgan_arch_config`). The yaml
module is imported only where a yaml file is read (`load_config`, a taming
`vqgan_config`), so the rest of the port runs without it.
"""

import os
from typing import Any, Dict, Optional

import torch

from feed_forward_vqgan_clip_tpu_torch.registry import CLIP_DIM, CLIP_SIZE, VQGAN_CONFIGS

# knob -> default (the reference's config.get(...) defaults)
DEFAULTS: Dict[str, Any] = {
    "lr": 0.001,
    "epochs": 200,
    "max_steps": None,
    "batch_size": 8,
    "repeat": 1,
    "cutn": 8,
    "cut_size": None,  # defaults to clip_size
    "augs": None,  # defaults to ('Af', 'Pe', 'Ji', 'Er')
    "pool": True,
    "pool_size": None,  # defaults to clip_size
    "interpolate": False,
    "interp_size": None,
    "noise_dim": 0,
    "nb_noise": None,
    "model_type": "mlp_mixer",
    "dim": 128,
    "depth": 8,
    "num_heads": 6,
    "dropout": 0.0,
    "initial_proj": True,
    "add_input": False,
    "vq_image_size": 16,
    "vqgan_config": None,  # taming yaml
    "vqgan_checkpoint": None,  # taming .ckpt / state dict; None: random init
    "vqgan_model": "vqgan_imagenet_f16_16384",  # registry preset when no yaml is given
    "clip_model": "ViT-B/32",
    "clip_model_path": None,  # OpenAI-named CLIP state dict; None: random init
    "clip_size": None,
    "clip_dim": None,
    "path": None,
    "eval_path": None,
    "eval_clip_model": None,
    "eval_clip_model_path": None,
    "folder": None,
    "log_interval": 100,
    "diversity_coef": 0.0,
    "diversity_mode": "between_same_prompts",
    "input_loss": False,
    "input_loss_coef": 1.0,
    "target_loss_coef": 1.0,
    "l2_coef": 0.0,
    "tv_coef": 0.0,
    "tv_exponent": 1.0,  # read by the reference but never used; kept for configs
    "clip_grad_norm": None,
    "scheduler": None,
    "normalize_input": False,
    "use_ema": False,
    "ema_decay": 0.995,
    "ema_warmup": True,  # torch_ema's (1+n)/(10+n) ramp; False pins the decay
    "use_wandb": False,
    "wandb_project": "feed_forward_vqgan_clip",
    "wandb_entity": None,
    "wandb_log_interval": 1,
    "vgg_path": None,
    "noise_fac": 0.1,  # cutout additive-noise factor
    "fuse_geometric": False,
    "vqgan_arch": None,  # inline ddconfig-style dict (smoke configs)
    "compute_dtype": "bfloat16",
    "opt_dtype": "bfloat16",  # Adam moment storage; "float32" is torch.Adam's
    "aug_dtype": None,  # cutout/augment stage dtype: None follows compute_dtype
    "seed": 0,
    "mesh_shape": None,
    "use_pallas": "auto",
    "fused_mixer": None,
    "profile_dir": None,
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


def load_config(path: str) -> TrainConfig:
    """A yaml config over DEFAULTS; the run folder defaults to the config's
    directory, as in the reference."""
    import yaml

    with open(path) as fd:
        raw = yaml.safe_load(fd) or {}
    cfg = TrainConfig(DEFAULTS)
    cfg.update(raw)
    if not cfg.get("folder"):
        cfg["folder"] = os.path.dirname(os.path.abspath(path))
    return cfg


def make_config(**overrides) -> TrainConfig:
    cfg = TrainConfig(DEFAULTS)
    cfg.update(overrides)
    return cfg


def resolved_clip_geometry(cfg: TrainConfig):
    """(clip_size, clip_dim), honoring explicit overrides."""
    clip_model = cfg.get("clip_model")
    return (cfg.get("clip_size") or CLIP_SIZE.get(clip_model),
            cfg.get("clip_dim") or CLIP_DIM.get(clip_model))


def vqgan_arch_config(cfg: TrainConfig) -> dict:
    """The VQGAN architecture dict: an inline `vqgan_arch` over the f16-16384
    preset, else a taming yaml at `vqgan_config`, else the `vqgan_model` preset."""
    inline = cfg.get("vqgan_arch")
    if isinstance(inline, dict):
        base = dict(VQGAN_CONFIGS["vqgan_imagenet_f16_16384"])
        base.update(inline)
        base["ch_mult"] = tuple(base["ch_mult"])
        base["attn_resolutions"] = tuple(base["attn_resolutions"])
        return base
    yaml_path: Optional[str] = cfg.get("vqgan_config")
    if yaml_path and os.path.exists(yaml_path):
        import yaml

        with open(yaml_path) as fd:
            p = yaml.safe_load(fd)["model"]["params"]
        if "first_stage_config" in p:  # a Net2NetTransformer: the VQGAN is its first stage
            p = p["first_stage_config"]["params"]
        dd = p["ddconfig"]
        return dict(
            n_embed=p["n_embed"], embed_dim=p["embed_dim"],
            z_channels=dd["z_channels"], resolution=dd["resolution"],
            in_channels=dd.get("in_channels", 3), out_ch=dd.get("out_ch", 3),
            ch=dd.get("ch", 128), ch_mult=tuple(dd.get("ch_mult", (1, 1, 2, 2, 4))),
            num_res_blocks=dd.get("num_res_blocks", 2),
            attn_resolutions=tuple(dd.get("attn_resolutions", (16,))),
            dropout=dd.get("dropout", 0.0),
        )
    return dict(VQGAN_CONFIGS[cfg.get("vqgan_model") or "vqgan_imagenet_f16_16384"])

"""Mapper checkpoints in the reference's `.th` format.

Port of the `.th` branch of feed_forward_vqgan_clip_tpu/io/checkpoint.py
`load_model`: a torch file holding the dict {state_dict, config, step, epoch},
the fixed noise bank under `NOISE` in the state dict. The port's Mixer keeps the
reference's mlp_mixer_pytorch key names, so the state dict loads as it is, with
no converter. `save_model` writes the same format, which the JAX package's
`load_model` reads too.

Not ported: the JAX package's native checkpoint directories (flax msgpack +
meta.json) and the legacy whole-module pickles (which need the reference's own
classes); `load_model` raises NotImplementedError on both (ROADMAP A6).
"""

import os

import torch

from feed_forward_vqgan_clip_tpu_torch.config import dtype_of, make_config, vqgan_arch_config
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper


def save_model(path: str, mapper, config: dict, noise=None, *, step: int = 0,
               epoch: int = 0) -> str:
    """Write `mapper`'s state dict, `config` (a plain dict) and the noise bank
    (N, noise_dim), if any, as a reference `.th` file; atomic (tmp + rename)."""
    sd = {k: v.detach().float().cpu() for k, v in mapper.state_dict().items()}
    if noise is not None:
        sd["NOISE"] = torch.as_tensor(noise, dtype=torch.float32).cpu()
    tmp = path + ".tmp"
    torch.save({"state_dict": sd, "config": dict(config), "step": int(step),
                "epoch": int(epoch)}, tmp)
    os.replace(tmp, path)
    return path


def load_model(path: str, *, device="cuda"):
    """A reference `.th` dict checkpoint -> (mapper, config, noise): the mapper
    built from the stored config in its `compute_dtype` on `device`, eval mode,
    no grad; noise the float32 bank on the CPU, or None."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a native checkpoint directory (flax msgpack); the port reads "
            "reference .th files only (ROADMAP A6)"
        )
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except (ModuleNotFoundError, AttributeError) as e:
        raise NotImplementedError(
            f"{path} pickles classes this environment lacks (a legacy whole-module "
            "checkpoint?); the port reads {state_dict, config} .th files only (ROADMAP A6)"
        ) from e
    if not (isinstance(obj, dict) and "state_dict" in obj and "config" in obj):
        raise NotImplementedError(
            f"{path} is not a {{state_dict, config}} checkpoint (a legacy whole-module "
            "pickle?); the port reads those only (ROADMAP A6)"
        )
    sd = dict(obj["state_dict"])
    noise = sd.pop("NOISE", None)
    cfg = make_config(**obj["config"])
    mapper = build_mapper(cfg, vq_channels=int(vqgan_arch_config(cfg)["z_channels"]),
                          dtype=dtype_of(cfg), device=device)
    mapper.load_state_dict({k: v.float() for k, v in sd.items()})
    mapper.eval().requires_grad_(False)
    if noise is not None:
        noise = noise.detach().float().cpu()
    return mapper, cfg, noise

"""Mapper and trainer checkpoints in the reference's `.th` format and layout.

Port of the `.th` branch of feed_forward_vqgan_clip_tpu/io/checkpoint.py
`load_model`: a torch file holding the dict {state_dict, config, step, epoch},
the fixed noise bank under `NOISE` in the state dict. The port's mappers (the
MLP-Mixer, the VitGAN generators, the x-transformer) keep the reference's key
names, so the state dict loads as it is, with no converter. `save_model` writes
the same format, which the JAX package's `load_model` reads too.

A trainer's run folder holds, as the reference's does:

    <folder>/checkpoint.th       the mapper ({state_dict, config, step, epoch})
    <folder>/checkpoint_ema.th   the EMA of its parameters, same format (use_ema)
    <folder>/opt.th              Adam: {step, count, mu, nu}, the moments by
                                 parameter name in their stored dtype

Every file is written atomically (tmp + rename), and the trainer writes
checkpoint.th last: its rename is the commit point `checkpoint_exists` keys off.

Not ported: the JAX package's native checkpoint directories (flax msgpack +
meta.json, ROADMAP A16f) and the legacy whole-module pickles (which need the
reference's own classes); `load_model` raises NotImplementedError on both.
"""

import os
from typing import Dict, Optional, Tuple

import torch

from feed_forward_vqgan_clip_tpu_torch.config import (
    TrainConfig,
    dtype_of,
    make_config,
    vqgan_arch_config,
)
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper


def _atomic_save(obj, path: str) -> str:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def save_state_dict(path: str, state_dict: Dict[str, torch.Tensor], config: dict, noise=None,
                    *, step: int = 0, epoch: int = 0) -> str:
    """Write a mapper state dict (stored float32 on the CPU), `config` (a plain
    dict) and the noise bank (N, noise_dim), if any, as a reference `.th` file."""
    sd = {k: v.detach().float().cpu() for k, v in state_dict.items()}
    if noise is not None:
        sd["NOISE"] = torch.as_tensor(noise, dtype=torch.float32).cpu()
    return _atomic_save({"state_dict": sd, "config": dict(config), "step": int(step),
                         "epoch": int(epoch)}, path)


def save_model(path: str, mapper, config: dict, noise=None, *, step: int = 0,
               epoch: int = 0) -> str:
    """`mapper`'s state dict as a reference `.th` file (`save_state_dict`)."""
    return save_state_dict(path, mapper.state_dict(), config, noise, step=step, epoch=epoch)


def checkpoint_path(folder: str, name: str = "checkpoint") -> str:
    return os.path.join(folder, name + ".th")


def checkpoint_exists(folder: str, name: str = "checkpoint") -> bool:
    return os.path.exists(checkpoint_path(folder, name))


def save_checkpoint(folder: str, name: str, state_dict, config: dict, step: int, epoch: int,
                    noise=None) -> str:
    """`<folder>/<name>.th` in the reference's format."""
    return save_state_dict(checkpoint_path(folder, name), state_dict, config, noise,
                           step=step, epoch=epoch)


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], TrainConfig, int, int,
                                        Optional[torch.Tensor]]:
    """A reference `.th` checkpoint -> (state_dict, config, step, epoch, noise),
    tensors float32 on the CPU."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = dict(obj["state_dict"])
    noise = sd.pop("NOISE", None)
    return (sd, make_config(**obj["config"]), int(obj.get("step", 0)),
            int(obj.get("epoch", 0)), noise)


def save_optimizer(folder: str, names, opt_state, step: int) -> str:
    """`<folder>/opt.th`: the Adam count and moments (by parameter name, in their
    stored dtype, on the CPU) after `step` updates."""
    return _atomic_save({
        "step": int(step), "count": int(opt_state.count),
        "mu": {n: m.detach().cpu() for n, m in zip(names, opt_state.mu)},
        "nu": {n: v.detach().cpu() for n, v in zip(names, opt_state.nu)},
    }, os.path.join(folder, "opt.th"))


def load_optimizer(folder: str) -> Optional[dict]:
    """`<folder>/opt.th` as `save_optimizer` wrote it, or None."""
    path = os.path.join(folder, "opt.th")
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=False)


def load_model(path: str, *, device="cuda"):
    """A reference `.th` dict checkpoint -> (mapper, config, noise): the mapper
    built from the stored config in its `compute_dtype` on `device`, eval mode,
    no grad; noise the float32 bank on the CPU, or None."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a native checkpoint directory (flax msgpack); the port reads "
            "reference .th files only (ROADMAP A16f)"
        )
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except (ModuleNotFoundError, AttributeError) as e:
        raise NotImplementedError(
            f"{path} pickles classes this environment lacks (a legacy whole-module "
            "checkpoint?); the port reads {state_dict, config} .th files only (ROADMAP A16f)"
        ) from e
    if not (isinstance(obj, dict) and "state_dict" in obj and "config" in obj):
        raise NotImplementedError(
            f"{path} is not a {{state_dict, config}} checkpoint (a legacy whole-module "
            "pickle?); the port reads those only (ROADMAP A16f)"
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

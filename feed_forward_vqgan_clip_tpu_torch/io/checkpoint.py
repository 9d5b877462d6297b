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

`load_model` also reads the two other formats the JAX package's `load_model`
reads:

  * the JAX package's checkpoint directories, `<dir>/params.msgpack` (flax
    msgpack of the mapper's parameter tree, read by io/msgpack.py),
    `meta.json` ({config, step, epoch}; written last, the commit point) and
    `noise.npy`; the tree becomes the port's state dict through io/from_jax.py
    (`mapper_state_dict`). `save_checkpoint_dir` writes the same layout.
  * the reference's legacy whole-module pickles. A `.th` is read by
    `torch.load(weights_only=False)` first; where it names a class that is not
    importable here (the reference's mapper modules, omegaconf's containers),
    it is read again through `LegacyUnpickler`, which turns such a class into a
    stub nn.Module subclass, so the pickled `_parameters`, `_buffers` and
    `_modules` still give the reference's state-dict keys, and `.config` and
    `.NOISE` come back as attributes. `plain_config` turns a stored OmegaConf
    config, real or stubbed, into plain dicts.

Like `torch.load(weights_only=False)`, both readers run the pickle's own
reconstruction code: a `.th` must come from a trusted source.
"""

import _compat_pickle
import json
import os
import pickle
import types
from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.config import (
    TrainConfig,
    dtype_of,
    make_config,
    vqgan_arch_config,
)
from feed_forward_vqgan_clip_tpu_torch.io import msgpack
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import mapper_state_dict, numpy_leaves
from feed_forward_vqgan_clip_tpu_torch.models.mappers import MAPPER_TYPES, build_mapper


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


def load_pytree(path: str) -> Any:
    """A flax msgpack file -> its tree, as flax's `msgpack_restore` returns it."""
    return msgpack.load(path)


def save_pytree(path: str, tree) -> str:
    """`tree` as flax's `to_bytes` writes it, atomically."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fd:
        msgpack.pack_to(fd, tree)
    os.replace(tmp, path)
    return path


def save_checkpoint_dir(folder: str, name: str, tree, config: dict, step: int, epoch: int,
                        noise=None) -> str:
    """`<folder>/<name>/` in the JAX package's layout (its `save_checkpoint`):
    params.msgpack and noise.npy first, meta.json last."""
    path = os.path.join(folder, name)
    os.makedirs(path, exist_ok=True)
    save_pytree(os.path.join(path, "params.msgpack"), tree)
    if noise is not None:
        tmp = os.path.join(path, "noise.npy.tmp")
        with open(tmp, "wb") as fd:
            np.save(fd, np.asarray(torch.as_tensor(noise).float().cpu()))
        os.replace(tmp, os.path.join(path, "noise.npy"))
    tmp = os.path.join(path, "meta.json.tmp")
    with open(tmp, "w") as fd:
        json.dump({"config": dict(config), "step": int(step), "epoch": int(epoch)}, fd,
                  default=str)
    os.replace(tmp, os.path.join(path, "meta.json"))
    return path


def load_checkpoint(path: str) -> Tuple[Any, TrainConfig, int, int, Optional[torch.Tensor]]:
    """A reference `.th` checkpoint -> (state_dict, config, step, epoch, noise),
    tensors float32 on the CPU; a JAX checkpoint directory -> (its parameter
    tree, config, step, epoch, noise), the tree's leaves as msgpack.unpackb
    gives them."""
    if os.path.isdir(path):
        tree = load_pytree(os.path.join(path, "params.msgpack"))
        with open(os.path.join(path, "meta.json")) as fd:
            meta = json.load(fd)
        noise_path = os.path.join(path, "noise.npy")
        noise = (torch.from_numpy(np.load(noise_path)).float()
                 if os.path.exists(noise_path) else None)
        return (tree, make_config(**meta["config"]), int(meta["step"]), int(meta["epoch"]),
                noise)
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


# packages whose classes (and dtypes) LegacyUnpickler builds for real, the
# modules whose functions it calls (tensor and array rebuilding, activations
# kept as attributes), and the builtins it names; every other class becomes a
# stub nn.Module subclass. This keeps a pickle's missing classes from failing
# the load; it is no safety boundary (torch's and numpy's classes do I/O).
LEGACY_PACKAGES = ("torch", "numpy", "collections")
LEGACY_FUNCTION_MODULES = ("torch._utils", "torch._tensor", "torch.serialization",
                           "torch.nn.functional", "numpy.core.multiarray",
                           "numpy._core.multiarray", "numpy.core.numeric", "numpy._core.numeric",
                           "copyreg", "_codecs")
LEGACY_BUILTINS = frozenset({"set", "frozenset", "slice", "complex", "range", "bytearray",
                             "dict", "list", "tuple", "object", "int", "float", "bool", "str",
                             "bytes"})


class _Stub(nn.Module):
    """A class a legacy pickle names that is not built for real: rebuilt from its
    pickled state (never through __init__), it holds the module's attributes."""

    def __init__(self, *args, **kwargs):
        raise pickle.UnpicklingError(
            f"legacy checkpoint: {type(self).__module__}.{type(self).__name__} is called, "
            "not rebuilt from its state")


class LegacyUnpickler(pickle.Unpickler):
    """An unpickler for reference `.th` files that name classes not importable
    here: torch's, numpy's and the containers' classes are built for real, the
    functions that rebuild tensors and arrays are called, a few builtins are
    allowed, and any other class (the reference's `mlp_mixer_pytorch`,
    `vitgan`, `x_transformers`, einops' layers, omegaconf's containers, ...)
    becomes a stub nn.Module subclass of its name (`_Stub`), which holds the
    pickled attributes and computes nothing; a stub that the pickle calls
    raises. The file must be trusted, as for `torch.load(weights_only=False)`."""

    _stubs: Dict[Tuple[str, str], type] = {}

    def find_class(self, module, name):
        if (module, name) in _compat_pickle.NAME_MAPPING:  # protocol 2's Python 2 names
            module, name = _compat_pickle.NAME_MAPPING[(module, name)]
        module = _compat_pickle.IMPORT_MAPPING.get(module, module)
        if module in LEGACY_FUNCTION_MODULES:
            return super().find_class(module, name)
        if module.split(".")[0] in LEGACY_PACKAGES:
            obj = super().find_class(module, name)
            if isinstance(obj, (type, torch.dtype)):
                return obj
            raise pickle.UnpicklingError(f"legacy checkpoint: {module}.{name} is not allowed")
        if module == "builtins":
            if name in LEGACY_BUILTINS:
                return super().find_class(module, name)
            raise pickle.UnpicklingError(f"legacy checkpoint: builtins.{name} is not allowed")
        key = (module, name)
        if key not in self._stubs:
            self._stubs[key] = type(name, (_Stub,), {"__module__": module})
        return self._stubs[key]


# torch.load's `pickle_module`: the standard load with LegacyUnpickler
legacy_pickle = types.ModuleType("legacy_pickle")
legacy_pickle.Unpickler, legacy_pickle.load = LegacyUnpickler, pickle.load


def load_th(path: str):
    """A reference torch file on the CPU, read by `torch.load(weights_only=False)`,
    or, where it names a class that is not importable here, through
    LegacyUnpickler. The file must be trusted."""
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    except (ModuleNotFoundError, AttributeError):
        return torch.load(path, map_location="cpu", weights_only=False,
                          pickle_module=legacy_pickle)


def plain_config(cfg):
    """A stored config as plain dicts and lists: an OmegaConf container, real or
    stubbed by LegacyUnpickler, becomes what its nodes hold (an interpolation
    stays its string)."""
    state = getattr(cfg, "__dict__", {})
    if "_content" in state:  # an OmegaConf DictConfig or ListConfig
        cfg = state["_content"]
    elif "_val" in state:  # one of its value nodes
        return plain_config(state["_val"])
    if isinstance(cfg, Mapping):
        return {k: plain_config(v) for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [plain_config(v) for v in cfg]
    return cfg


def _read_th(path: str):
    """(state dict, plain config, noise) of a reference `.th`: a {state_dict,
    config} dict or a legacy whole-module pickle."""
    obj = load_th(path)
    if isinstance(obj, dict) and "state_dict" in obj and "config" in obj:
        sd = dict(obj["state_dict"])
        return sd, plain_config(obj["config"]), sd.pop("NOISE", None)
    if isinstance(obj, nn.Module) and hasattr(obj, "config"):
        sd = obj.state_dict()
        noise = sd.pop("NOISE", None)
        noise = getattr(obj, "NOISE", noise)
        return sd, plain_config(obj.config), noise
    raise ValueError(f"{path} is neither a {{state_dict, config}} checkpoint nor a whole "
                     "mapper module with a .config")


def load_model(path: str, *, device="cuda"):
    """A mapper checkpoint -> (mapper, config, noise): the mapper built from the
    stored config in its `compute_dtype` on `device`, eval mode, no grad; noise
    the float32 bank on the CPU, or None. `path` is a reference `.th` (a
    {state_dict, config} dict or a legacy whole-module pickle) or a JAX
    checkpoint directory. An unknown `model_type` raises NotImplementedError
    (as the JAX package's converter does for a `.th`; for a directory its
    mapper factory raises ValueError, as the JAX package's does)."""
    if os.path.isdir(path):
        tree, cfg, _step, _epoch, noise = load_checkpoint(path)
        sd = None
    else:
        sd, raw_cfg, noise = _read_th(path)
        cfg = make_config(**raw_cfg)
        if cfg.get("model_type") not in MAPPER_TYPES:
            raise NotImplementedError(f"no converter for model_type={cfg.get('model_type')!r}")
    mapper = build_mapper(cfg, vq_channels=int(vqgan_arch_config(cfg)["z_channels"]),
                          dtype=dtype_of(cfg), device=device)
    if sd is None:
        sd = mapper_state_dict(numpy_leaves(tree), cfg)
    mapper.load_state_dict({k: v.float() for k, v in sd.items() if isinstance(v, torch.Tensor)})
    mapper.eval().requires_grad_(False)
    if noise is not None:
        noise = torch.as_tensor(noise).detach().float().cpu()
    return mapper, cfg, noise

"""Perceptor (CLIP-family) loading: the text and image towers.

Port of feed_forward_vqgan_clip_tpu/models/perceptor.py. Routes as the JAX
package does: CLIP ViT names and OpenCLIP ViT tags of a registry arch to the ViT
towers (models/clip_vit.py); `RN*`, the ml-jku `cloob_rn50` / `cloob_rn50x4`
(CLIP's RN50 / RN50x4 towers, reported under the cloob name's size and width)
and OpenCLIP RN tags to the ModifiedResNet tower (models/clip_resnet.py).
Weights come from a torch file in OpenAI CLIP's key names (a state dict, a
{"state_dict": ...} wrapper, or OpenAI's TorchScript archive; the ml-jku CLOOB
layout and a `module.` prefix are renamed to them) when a path is given, else
from a random init drawn from a torch.Generator, with the JAX package's loud
warning. The JAX package's msgpack directories are not read (ROADMAP A16f);
crowsonkb's CLOOB ViTs and OpenCLIP archs outside the registry are ROADMAP A15b.
"""

import logging
import os
from typing import NamedTuple, Optional

import torch
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.registry import (
    CLIP_DIM,
    CLIP_RESNET_CONFIGS,
    CLIP_SIZE,
    CLIP_VIT_CONFIGS,
)
from feed_forward_vqgan_clip_tpu_torch.models.clip_resnet import CLIPResNet
from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import (
    make_clip,
    make_clip_from_config,
    parse_openclip,
)

log = logging.getLogger(__name__)

# the ml-jku CLOOB ResNets: CLIP's RN towers (JAX models/cloob.load_cloob)
CLOOB_RESNETS = {"cloob_rn50": "RN50", "cloob_rn50x4": "RN50x4"}


class Perceptor(NamedTuple):
    module: nn.Module
    name: str
    size: int
    dim: int

    @torch.no_grad()
    def encode_text(self, tokens):
        return self.module.encode_text(tokens)

    def encode_image(self, x):
        """x (B, H, W, 3) CLIP-normalised -> (B, dim) float32; differentiable in x."""
        return self.module.encode_image(x)


def _resnet_arch(name: str):
    """(CLIP_RESNET_CONFIGS entry, activation) of an RN-family perceptor name;
    None for a ViT name."""
    if name.startswith("cloob"):
        if name not in CLOOB_RESNETS:
            raise NotImplementedError(f"perceptor {name!r}: crowsonkb's CLOOB ViTs (haiku "
                                      "pickles) are not ported yet (ROADMAP A15b)")
        return CLIP_RESNET_CONFIGS[CLOOB_RESNETS[name]], "quick_gelu"
    if name.startswith("RN"):
        if name not in CLIP_RESNET_CONFIGS:
            raise ValueError(f"unknown CLIP RN arch {name!r}; known archs: "
                             f"{sorted(CLIP_RESNET_CONFIGS)}")
        return CLIP_RESNET_CONFIGS[name], "quick_gelu"
    if name.startswith("openclip/"):
        arch, act = parse_openclip(name)
        if arch in CLIP_RESNET_CONFIGS:
            return CLIP_RESNET_CONFIGS[arch], act
        if arch not in CLIP_VIT_CONFIGS:
            raise NotImplementedError(
                f"OpenCLIP arch {arch!r} (from {name!r}) is outside the registry; building it "
                "from a checkpoint's shapes (sniff_clip_arch) is not ported yet (ROADMAP A15b)")
    return None


def load_perceptor(name: str, path: Optional[str] = None, *, dtype=torch.bfloat16,
                   device="cuda", seed: int = 0, image: bool = True) -> Perceptor:
    """A frozen CLIP (parameters do not require grad): the weights of the torch
    file at `path`, else random from `seed`. `image=False` builds the text tower
    alone (the serving path) and reads only its entries of the file."""
    resnet = _resnet_arch(name)
    if resnet is None:
        module = make_clip(name, dtype=dtype, device=device, image=image)
        size, dim = 224, module.embed_dim
    else:
        cfg, act = resnet
        module = (CLIPResNet(cfg, act, dtype=dtype, device=device) if image else
                  make_clip_from_config(cfg, act, dtype=dtype, device=device))
        size, dim = cfg["image_size"], cfg["embed_dim"]
    if path:
        module.load_state_dict(_read_clip_state_dict(path, module))
    else:
        log.warning(
            "No weights for CLIP %s — random init (smoke/bench only; pass "
            "clip_model_path for real runs).", name
        )
        gen = torch.Generator(device=module.text_projection.device).manual_seed(seed)
        module.init_random_(gen)
    module.eval().requires_grad_(False)
    return Perceptor(module=module, name=name, size=CLIP_SIZE.get(name, size),
                     dim=CLIP_DIM.get(name, dim))


def _openai_names(sd: dict) -> dict:
    """OpenAI CLIP's key names from the other layouts the JAX converters read: a
    `module.` / `_orig_mod.` / `model.` prefix on the keys stripped; the ml-jku
    CLOOB layout (the text tower under `transformer.`, `logit_inv_tau` for
    `logit_scale`, the loss-only `logit_scale_hopfield`) renamed."""
    for prefix in ("module.", "_orig_mod.", "model."):
        if any(k.startswith(prefix) for k in sd) and not any(
                k.startswith("visual.") or k == "logit_scale" for k in sd):
            sd = {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}
    if "logit_inv_tau" in sd:
        renamed = {}
        for k, v in sd.items():
            if k == "logit_inv_tau":
                renamed["logit_scale"] = v.reshape(())
            elif k != "logit_scale_hopfield":
                renamed[k[len("transformer."):] if k.startswith("transformer.") else k] = v
        sd = renamed
    return sd


def _read_clip_state_dict(path: str, module: nn.Module) -> dict:
    """The entries of `module` from the CLIP torch file at `path`, in float32.
    Entries the module lacks (the image tower's for a text tower, OpenAI's
    `input_resolution`, `context_length`, `vocab_size`, BatchNorm's
    `num_batches_tracked`) are dropped; a missing entry raises in
    load_state_dict."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a native (flax msgpack) CLIP directory; the port reads torch "
            "files only (ROADMAP A16f)"
        )
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(obj, dict):  # a module (OpenAI's TorchScript archive)
        obj = obj.state_dict()
    if "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    obj = _openai_names(obj)
    keys = set(module.state_dict())
    return {k: v.float() for k, v in obj.items() if k in keys}

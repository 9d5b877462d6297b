"""Perceptor (CLIP-family) loading: the text and image towers.

Port of feed_forward_vqgan_clip_tpu/models/perceptor.py. Routes as the JAX
package does: CLIP ViT names and OpenCLIP ViT tags of a registry arch to the ViT
towers (models/clip_vit.py); `RN*`, the ml-jku `cloob_rn50` / `cloob_rn50x4`
(CLIP's RN50 / RN50x4 towers, reported under the cloob name's size and width)
and OpenCLIP RN tags to the ModifiedResNet tower (models/clip_resnet.py);
crowsonkb's `cloob_laion_*` ViTs to models/cloob.py (their haiku pickles); an
OpenCLIP arch outside the registry to the tower its checkpoint's shapes
describe (io/clip_arch.sniff_clip_arch), which needs a path.
Weights come from a torch file in OpenAI CLIP's key names (a state dict, a
{"state_dict": ...} wrapper, or OpenAI's TorchScript archive; the ml-jku CLOOB
layout, a `module.` prefix and OpenCLIP's `text.`-nested text tower are renamed
to them) or from the JAX package's directory (`params.msgpack`, through
io/from_jax.py) when a path is given, else from a random init drawn from a
torch.Generator, with the JAX package's loud warning.
"""

import logging
import os
from typing import NamedTuple, Optional

import torch
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.io import msgpack
from feed_forward_vqgan_clip_tpu_torch.io.clip_arch import (
    normalize_openclip_naming,
    sniff_clip_arch,
)
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import (
    clip_resnet_state_dict,
    clip_state_dict,
    numpy_leaves,
)
from feed_forward_vqgan_clip_tpu_torch.registry import (
    CLIP_DIM,
    CLIP_RESNET_CONFIGS,
    CLIP_SIZE,
    CLIP_VIT_CONFIGS,
)
from feed_forward_vqgan_clip_tpu_torch.models.clip_resnet import CLIPResNet
from feed_forward_vqgan_clip_tpu_torch.models.cloob import CROWSON_CONFIGS, load_cloob
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

    @property
    def logit_scale(self):
        """exp of the loaded `logit_scale`: the CLIP score's factor (0-d float32)."""
        return self.module.logit_scale.float().exp()


def _arch(name: str, path: Optional[str]):
    """(family, CLIP config, activation, file state dict or None) of a perceptor
    name: family "vit" (config None: the registry's, by name) or "resnet". An
    OpenCLIP arch outside the registry is sniffed from the file at `path`,
    whose state dict comes back so it is read once."""
    if name.startswith("cloob"):
        if name not in CLOOB_RESNETS:
            raise ValueError(f"unknown CLOOB model {name!r}")
        return "resnet", CLIP_RESNET_CONFIGS[CLOOB_RESNETS[name]], "quick_gelu", None
    if name.startswith("RN"):
        if name not in CLIP_RESNET_CONFIGS:
            raise ValueError(f"unknown CLIP RN arch {name!r}; known archs: "
                             f"{sorted(CLIP_RESNET_CONFIGS)}")
        return "resnet", CLIP_RESNET_CONFIGS[name], "quick_gelu", None
    if name.startswith("openclip/"):
        arch, act = parse_openclip(name)
        if arch in CLIP_RESNET_CONFIGS:
            return "resnet", CLIP_RESNET_CONFIGS[arch], act, None
        if arch not in CLIP_VIT_CONFIGS:
            if not path:
                raise ValueError(
                    f"unknown openclip arch {arch!r} with no clip_model_path: known ViT "
                    f"archs {sorted(CLIP_VIT_CONFIGS)}, RN archs {sorted(CLIP_RESNET_CONFIGS)}; "
                    "any other arch works when clip_model_path points at its checkpoint "
                    "(the architecture is sniffed from the weights' shapes).")
            sd = _read_torch_state_dict(path)
            family, cfg = sniff_clip_arch(sd)
            return family, cfg, act, sd
    return "vit", None, None, None


def load_perceptor(name: str, path: Optional[str] = None, *, dtype=torch.bfloat16,
                   device="cuda", seed: int = 0, image: bool = True) -> Perceptor:
    """A frozen CLIP (parameters do not require grad): the weights of the file at
    `path`, else random from `seed`. `image=False` builds the text tower alone
    (the serving path) and reads only its entries of the file."""
    if name in CROWSON_CONFIGS:
        module = load_cloob(name, path, dtype=dtype, device=device, seed=seed, image=image)
        return Perceptor(module=module, name=name, size=CLIP_SIZE.get(name, 224),
                         dim=CLIP_DIM.get(name, CROWSON_CONFIGS[name]["d_embed"]))
    family, cfg, act, sd = _arch(name, path)
    if cfg is None:
        module = make_clip(name, dtype=dtype, device=device, image=image)
    elif family == "resnet" and image:
        module = CLIPResNet(cfg, act, dtype=dtype, device=device)
    else:  # a sniffed ViT, or an RN's text tower alone
        module = make_clip_from_config(cfg, act, dtype=dtype, device=device, image=image)
    size, dim = (224, module.embed_dim) if cfg is None else (cfg["image_size"], cfg["embed_dim"])
    if path:
        module.load_state_dict(_read_clip_state_dict(path, module, sd))
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
    """OpenAI CLIP's key names from the other layouts the JAX converters read:
    OpenCLIP's (a `module.` / `_orig_mod.` / `model.` prefix stripped, a
    `text.`-nested text tower moved to the top level:
    io/clip_arch.normalize_openclip_naming); the ml-jku CLOOB layout (the text
    tower under `transformer.`, `logit_inv_tau` for `logit_scale`, the
    loss-only `logit_scale_hopfield`) renamed."""
    sd = normalize_openclip_naming(sd)
    if "logit_inv_tau" in sd:
        renamed = {}
        for k, v in sd.items():
            if k == "logit_inv_tau":
                renamed["logit_scale"] = v.reshape(())
            elif k != "logit_scale_hopfield":
                renamed[k[len("transformer."):] if k.startswith("transformer.") else k] = v
        sd = renamed
    return sd


def _read_torch_state_dict(path: str) -> dict:
    """The CLIP torch file at `path` in OpenAI CLIP's key names."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(obj, dict):  # a module (OpenAI's TorchScript archive)
        obj = obj.state_dict()
    if "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    return _openai_names(obj)


def _read_jax_dir(path: str) -> dict:
    """The JAX package's CLIP directory (`params.msgpack`: a ViT's or a
    ModifiedResNet's variables) as the port's state dict."""
    tree = numpy_leaves(msgpack.load(os.path.join(path, "params.msgpack")))
    params = tree["params"] if "params" in tree else tree
    if "attnpool" in params["visual"]:
        return clip_resnet_state_dict(tree)
    return clip_state_dict(tree)


def _read_clip_state_dict(path: str, module: nn.Module, sd: Optional[dict] = None) -> dict:
    """The entries of `module` from the CLIP file or JAX directory at `path` (or
    from `sd`, that file's state dict already read), in float32. Entries the
    module lacks (the image tower's for a text tower, OpenAI's
    `input_resolution`, `context_length`, `vocab_size`, BatchNorm's
    `num_batches_tracked`) are dropped; a missing entry raises in
    load_state_dict."""
    if sd is None:
        sd = _read_jax_dir(path) if os.path.isdir(path) else _read_torch_state_dict(path)
    keys = set(module.state_dict())
    return {k: v.float() for k, v in sd.items() if k in keys}

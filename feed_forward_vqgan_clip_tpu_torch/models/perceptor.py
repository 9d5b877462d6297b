"""Perceptor (CLIP-family) loading: the ViT text and image towers.

Port of the ViT branch of feed_forward_vqgan_clip_tpu/models/perceptor.py.
Weights come from a torch file in OpenAI CLIP's key names (a state dict, a
{"state_dict": ...} wrapper, or OpenAI's TorchScript archive) when a path is
given, else from a random init drawn from a torch.Generator, with the JAX
package's loud warning. The JAX package's msgpack directories are not read
(ROADMAP A6); RN, CLOOB and OpenCLIP-sniffed perceptors are ROADMAP A15.
"""

import logging
import os
from typing import NamedTuple, Optional

import torch
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.registry import CLIP_DIM, CLIP_SIZE
from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip

log = logging.getLogger(__name__)


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


def load_perceptor(name: str, path: Optional[str] = None, *, dtype=torch.bfloat16,
                   device="cuda", seed: int = 0, image: bool = True) -> Perceptor:
    """A frozen CLIP (parameters do not require grad): the weights of the torch
    file at `path`, else random from `seed`. `image=False` builds the text tower
    alone (the serving path) and reads only its entries of the file."""
    if name.startswith(("RN", "cloob")):
        raise NotImplementedError(f"perceptor {name!r} is not ported yet (ROADMAP A15)")
    module = make_clip(name, dtype=dtype, device=device, image=image)
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
    return Perceptor(
        module=module,
        name=name,
        size=CLIP_SIZE.get(name, 224),
        dim=CLIP_DIM.get(name, module.embed_dim),
    )


def _read_clip_state_dict(path: str, module: nn.Module) -> dict:
    """The entries of `module` from the CLIP torch file at `path`, in float32.
    Entries the module lacks (the image tower's for a text tower, OpenAI's
    `input_resolution`, `context_length`, `vocab_size`) are dropped; a missing
    entry raises in load_state_dict."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a native (flax msgpack) CLIP directory; the port reads torch "
            "files only (ROADMAP A6)"
        )
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(obj, dict):  # a module (OpenAI's TorchScript archive)
        obj = obj.state_dict()
    if "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    keys = set(module.state_dict())
    return {k: v.float() for k, v in obj.items() if k in keys}

"""Perceptor (CLIP-family) loading: the ViT text tower for now.

Port of the ViT branch of feed_forward_vqgan_clip_tpu/models/perceptor.py.
Released CLIP weights are not in the repository yet, so the only source is a
random init from a torch.Generator, with the JAX package's loud warning. RN,
CLOOB and OpenCLIP-sniffed perceptors are ROADMAP A15.
"""

import logging
from typing import NamedTuple, Optional

import torch
from torch import nn

from feed_forward_vqgan_clip_tpu.registry import CLIP_DIM, CLIP_SIZE
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


def load_perceptor(name: str, path: Optional[str] = None, *, dtype=torch.bfloat16,
                   device=None, seed: int = 0) -> Perceptor:
    if path is not None:
        raise NotImplementedError(
            "loading CLIP weights into the torch port is not implemented yet "
            "(ROADMAP A5/A6): only the random-init smoke path exists"
        )
    if name.startswith(("RN", "cloob")):
        raise NotImplementedError(f"perceptor {name!r} is not ported yet (ROADMAP A15)")
    module = make_clip(name, dtype=dtype, device=device)
    log.warning(
        "No weights for CLIP %s — random init (smoke/bench only; the port "
        "cannot load released CLIP weights yet).", name
    )
    gen = torch.Generator(device=module.text_projection.device).manual_seed(seed)
    module.init_random_(gen).eval()
    return Perceptor(
        module=module,
        name=name,
        size=CLIP_SIZE.get(name, 224),
        dim=CLIP_DIM.get(name, module.embed_dim),
    )

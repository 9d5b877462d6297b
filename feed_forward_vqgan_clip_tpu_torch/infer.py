"""Inference: CLIP token ids -> images.

Port of feed_forward_vqgan_clip_tpu/infer.py's `Generator`, built from modules
instead of a checkpoint: released mapper, VQGAN and CLIP weights and the BPE
vocabulary are not in the repository yet, so requests come as CLIP token-id
arrays and weights from `from_jax` or a seed. The flow prior and the noise bank
are later work.
"""

from typing import Optional

import torch

from feed_forward_vqgan_clip_tpu.registry import VQGAN_CONFIGS
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
from feed_forward_vqgan_clip_tpu_torch.models.mappers.fused import make_mapper_apply
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import load_perceptor
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import latent_bounds, make_vqgan, synth
from feed_forward_vqgan_clip_tpu_torch.ops.grad_ops import clamp_with_grad


class Generator:
    """Mapper + frozen perceptor and VQGAN with the prompt->image path."""

    def __init__(self, perceptor, mapper, vqgan, *, noise_dim: int = 0):
        self.perceptor = perceptor
        self.mapper = mapper.eval()
        self.vq = vqgan.eval()
        self.noise_dim = noise_dim
        self._mapper_apply = make_mapper_apply(self.mapper)

    @torch.no_grad()
    def encode_tokens(self, tokens):
        """tokens int (B, 77) -> H (B, clip_dim) float32."""
        return self.perceptor.encode_text(tokens).float()

    @torch.no_grad()
    def render(self, net_in):
        """Mapper input (B, clip_dim + noise_dim) -> images (B, H, W, 3) float32 in [0, 1]."""
        lo, hi = latent_bounds(self.vq)
        # float32: JAX's clip promotes the bf16 latent against the f32 bounds
        z = clamp_with_grad(self._mapper_apply(net_in).float(), lo, hi)
        return synth(self.vq, z).float()

    def generate(self, h, *, nb_repeats: int = 1, generator: Optional[torch.Generator] = None):
        """H (B, clip_dim) -> images (nb_repeats*B, H, W, 3); noise from `generator`."""
        h = h.repeat(nb_repeats, 1)
        if self.noise_dim:
            noise = torch.randn(len(h), self.noise_dim, generator=generator, device=h.device)
            h = torch.cat([h, noise.to(h.dtype)], dim=1)
        return self.render(h)


def build_generator(*, clip_model: str = "ViT-B/32", vqgan_config=None, dim: int = 1024,
                    depth: int = 32, vq_image_size: int = 16, noise_dim: int = 0,
                    dtype=torch.bfloat16, device=None, seed: int = 0) -> Generator:
    """A Generator with random weights drawn from `seed`; the defaults are the
    flagship (`__graft_entry__.entry`): CLIP ViT-B/32 text tower, Mixer 32x1024,
    VQGAN f16-16384."""
    vq_cfg = dict(vqgan_config or VQGAN_CONFIGS["vqgan_imagenet_f16_16384"])
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    perceptor = load_perceptor(clip_model, dtype=dtype, device=device, seed=seed)
    vq = make_vqgan(vq_cfg, dtype=dtype, device=device).init_random_(gen)
    mapper_cfg = dict(clip_model=clip_model, model_type="mlp_mixer", dim=dim, depth=depth,
                      vq_image_size=vq_image_size, noise_dim=noise_dim)
    mapper = build_mapper(mapper_cfg, vq_channels=int(vq_cfg["embed_dim"]), dtype=dtype,
                          device=device).init_random_(gen)
    return Generator(perceptor, mapper, vq, noise_dim=noise_dim)

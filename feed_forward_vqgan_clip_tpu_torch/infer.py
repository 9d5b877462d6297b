"""Inference: prompts or CLIP token ids -> images.

Port of feed_forward_vqgan_clip_tpu/infer.py: `Generator` (a mapper with its
frozen perceptor and VQGAN and the prompt->image path), `Generator.from_checkpoint`
(the JAX Generator's constructor: a reference `.th` mapper checkpoint and the
config it carries) and `test` (prompts -> PNG grid, the reference `test`
command). `build_generator` builds the flagship from a seed instead, for
`entry`. The noise bank follows the reference: a bank with more rows than
requested images is truncated, a smaller one is indexed at random, no bank
means Gaussian noise. With a flow prior (models/flow.py) the tiled text
embeddings are replaced by the prior's samples for them, drawn from the
request's generator, before the noise columns are added.
"""

import logging
import os
from typing import Optional

import numpy as np
import torch

from feed_forward_vqgan_clip_tpu_torch.config import dtype_of
from feed_forward_vqgan_clip_tpu_torch.io import checkpoint
from feed_forward_vqgan_clip_tpu_torch.io.images import save_grid
from feed_forward_vqgan_clip_tpu_torch.models.flow import Prior, load_prior_model
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
from feed_forward_vqgan_clip_tpu_torch.models.mappers.fused import make_mapper_apply
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import load_perceptor
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import (
    latent_bounds,
    load_vqgan,
    make_vqgan,
    synth,
)
from feed_forward_vqgan_clip_tpu_torch.ops.grad_ops import clamp_with_grad
from feed_forward_vqgan_clip_tpu_torch.ops.losses import normalize
from feed_forward_vqgan_clip_tpu_torch.registry import VQGAN_CONFIGS
from feed_forward_vqgan_clip_tpu_torch.tokenizer import bpe
from feed_forward_vqgan_clip_tpu_torch.tracing import span

log = logging.getLogger(__name__)


def noise_rows(n: int, noise_dim: int, bank, generator: torch.Generator, device):
    """(n, noise_dim) float32 mapper-input noise: the bank's first n rows when it
    holds more than n, n random rows of it otherwise, Gaussian rows without one
    (reference main.py `test`)."""
    if bank is None:
        return torch.randn(n, noise_dim, generator=generator, device=generator.device).to(device)
    bank = torch.as_tensor(bank, dtype=torch.float32)
    if len(bank) > n:
        return bank[:n].to(device)
    idx = torch.randint(0, len(bank), (n,), generator=generator, device=generator.device)
    return bank[idx.cpu()].to(device)


class Generator:
    """Mapper + frozen perceptor and VQGAN with the prompt->image path. The
    mapper runs through `fused.make_mapper_apply`, on the kernels its
    `mapper_route` picks for each batch. While tracing is on
    (tracing.py), `render` records the span `render`, timed on the device,
    holding `mapper` and synth's `decode`; `encode_tokens` records `text`,
    `encode_prompts` also `tokenize` (host clock)."""

    def __init__(self, perceptor, mapper, vqgan, *, noise_dim: int = 0, cfg=None,
                 noise_bank=None, prior: Optional[Prior] = None):
        self.perceptor = perceptor
        self.mapper = mapper.eval()
        self.vq = vqgan.eval()
        self.noise_dim = noise_dim
        self.cfg = cfg or {}
        self.noise_bank = noise_bank
        self.prior = prior
        self._mapper_apply = make_mapper_apply(self.mapper)

    @classmethod
    def from_checkpoint(cls, model_path: str, *, prior_path: Optional[str] = None,
                        device="cuda") -> "Generator":
        """The mapper of a reference `.th` checkpoint with the perceptor and VQGAN
        its config names (`clip_model`, `clip_model_path`, `vqgan_checkpoint`;
        random from seed 0 where no path is given), in its `compute_dtype`, and
        the prior `.th` at `prior_path`, if given."""
        mapper, cfg, noise = checkpoint.load_model(model_path, device=device)
        dtype = dtype_of(cfg)
        perceptor = load_perceptor(cfg.get("clip_model"), cfg.get("clip_model_path"),
                                   dtype=dtype, device=device, image=False)
        vq = load_vqgan(cfg, dtype, device=device)
        prior = load_prior_model(prior_path, device=device) if prior_path else None
        return cls(perceptor, mapper, vq, noise_dim=int(cfg.get("noise_dim") or 0), cfg=cfg,
                   noise_bank=noise, prior=prior)

    @torch.no_grad()
    def encode_tokens(self, tokens):
        """tokens int (B, 77) -> H (B, clip_dim) float32."""
        with span("text"):
            return self.perceptor.encode_text(tokens).float()

    def encode_prompts(self, texts):
        """Prompts -> H (B, clip_dim) float32, normalised where the config says
        `normalize_input`."""
        with span("tokenize"):
            toks = torch.from_numpy(bpe.get_tokenizer().tokenize(texts, truncate=True)).long()
        h = self.encode_tokens(toks.to(next(self.mapper.parameters()).device))
        return normalize(h) if self.cfg.get("normalize_input") else h

    @torch.no_grad()
    def render(self, net_in):
        """Mapper input (B, clip_dim + noise_dim) -> images (B, H, W, 3) float32 in [0, 1]."""
        with span("render", device=True, batch=len(net_in)):
            lo, hi = latent_bounds(self.vq)
            with span("mapper"):
                z = self._mapper_apply(net_in)
            # float32: JAX's clip promotes the bf16 latent against the f32 bounds
            return synth(self.vq, clamp_with_grad(z.float(), lo, hi)).float()

    def generate(self, h, *, nb_repeats: int = 1, seed: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        """H (B, clip_dim) -> images (nb_repeats*B, H, W, 3); the prior's samples
        for the tiled H, then noise rows (`noise_rows`), drawn from `generator`,
        else from a generator seeded with `seed` (0 when None) on H's device."""
        h = h.repeat(nb_repeats, 1)
        if generator is None:
            generator = torch.Generator(device=h.device).manual_seed(seed or 0)
        if self.prior is not None:
            h = self.prior.sample(h, generator)
        if self.noise_dim:
            noise = noise_rows(len(h), self.noise_dim, self.noise_bank, generator, h.device)
            h = torch.cat([h, noise.to(h.dtype)], dim=1)
        return self.render(h)


def test(model_path: str, text_or_path: str, *, nb_repeats: int = 1, out_path: str = "gen.png",
         images_per_row: Optional[int] = None, prior_path: Optional[str] = None,
         seed: Optional[int] = None, device="cuda") -> str:
    """Prompts ('|'-separated, or a .txt file with one per line) -> a PNG grid of
    nb_repeats images per prompt (the reference `test` command), through the
    prior at `prior_path` where given."""
    if text_or_path.endswith(".txt") and os.path.exists(text_or_path):
        with open(text_or_path) as fd:
            texts = [line.strip() for line in fd.readlines()]
    else:
        texts = text_or_path.split("|")
    gen = Generator.from_checkpoint(model_path, prior_path=prior_path, device=device)
    images = gen.generate(gen.encode_prompts(texts), nb_repeats=nb_repeats, seed=seed)
    save_grid(np.asarray(images.cpu()), out_path, nrow=images_per_row or nb_repeats)
    log.info("Wrote %s (%d images)", out_path, len(images))
    return out_path


def build_generator(*, clip_model: str = "ViT-B/32", vqgan_config=None, dim: int = 1024,
                    depth: int = 32, vq_image_size: int = 16, noise_dim: int = 0,
                    dtype=torch.bfloat16, device="cuda", seed: int = 0) -> Generator:
    """A Generator with random weights drawn from `seed`, on `device`; the
    defaults are the flagship (`__graft_entry__.entry`): CLIP ViT-B/32 text
    tower, Mixer 32x1024, VQGAN f16-16384."""
    vq_cfg = dict(vqgan_config or VQGAN_CONFIGS["vqgan_imagenet_f16_16384"])
    gen = torch.Generator(device=device).manual_seed(seed)
    perceptor = load_perceptor(clip_model, dtype=dtype, device=device, seed=seed, image=False)
    vq = make_vqgan(vq_cfg, dtype=dtype, device=device).init_random_(gen)
    mapper_cfg = dict(clip_model=clip_model, model_type="mlp_mixer", dim=dim, depth=depth,
                      vq_image_size=vq_image_size, noise_dim=noise_dim)
    mapper = build_mapper(mapper_cfg, vq_channels=int(vq_cfg["embed_dim"]), dtype=dtype,
                          device=device).init_random_(gen)
    return Generator(perceptor, mapper, vq, noise_dim=noise_dim)

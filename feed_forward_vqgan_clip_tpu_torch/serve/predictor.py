"""Serving predictor: prompt -> PNG grid, with deduplicated frozen-model caches.

Port of feed_forward_vqgan_clip_tpu/serve/predictor.py. `setup()` loads every
mapper checkpoint (reference `.th` files, legacy whole-module pickles or the JAX
package's checkpoint directories) and caches perceptors by
(clip_model, clip_model_path) and VQGANs by checkpoint and architecture, with
their latent bounds; for each Mixer mapper it also stacks and folds the weights
once for the streamed forward. The other mapper families (VitGAN, x-transformer)
run as modules on every device. Priors are cached by path: each model's prior
is the one `prior_paths` names, else its released companion (`PRIOR_MODELS`)
where that file is present. `predict()` runs tokenize -> text encode -> tile to
grid_h * grid_w rows -> (with `prior=True` and a prior for the model: the
prior's samples for those rows) -> + noise -> mapper -> clamp -> VQ + decode ->
grid -> PNG. A request of at most `STREAM_MAX_BATCH` (8) images goes through the
depth-streaming Mixer stack (one K4 launch for all blocks on the card); a larger
one through the per-block path (K2 per block). On the CPU the same routing runs
the kernels' plain versions and the module path.

Everything stays resident on one device. `prior=True` for a model without a
prior is ignored, as in the JAX package.
"""

import json
import logging
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from feed_forward_vqgan_clip_tpu_torch.config import dtype_of, vqgan_arch_config
from feed_forward_vqgan_clip_tpu_torch.io import checkpoint
from feed_forward_vqgan_clip_tpu_torch.io.images import make_grid, save_image
from feed_forward_vqgan_clip_tpu_torch.models.flow import Prior, load_prior_model
from feed_forward_vqgan_clip_tpu_torch.models.mappers.fused import (
    STREAM_MAX_BATCH,
    make_mapper_apply,
    prepare_streamed_params,
    streamed_mixer_forward,
    streamed_supported,
)
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import load_perceptor
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import latent_bounds, load_vqgan, synth
from feed_forward_vqgan_clip_tpu_torch.ops.grad_ops import clamp_with_grad
from feed_forward_vqgan_clip_tpu_torch.ops.losses import normalize
from feed_forward_vqgan_clip_tpu_torch.registry import PRIOR_MODELS, RELEASED_MODELS
from feed_forward_vqgan_clip_tpu_torch.tokenizer import bpe

log = logging.getLogger(__name__)

# the stages `predict` reports to its `mark` callback, in order
STAGES = ("text", "prior", "mapper", "decode")


def default_model_paths() -> list:
    """The released mapper checkpoints present in the working directory."""
    return [p for p in RELEASED_MODELS if os.path.exists(p)]


def _vqgan_key(cfg) -> str:
    return json.dumps([cfg.get("vqgan_checkpoint"), cfg.get("vqgan_config"),
                       vqgan_arch_config(cfg)], sort_keys=True, default=str)


class Predictor:
    def __init__(self, model_paths: Optional[Sequence[str]] = None,
                 prior_paths: Optional[Dict[str, str]] = None, *, device="cuda"):
        """model_paths: mapper checkpoints (.th files or JAX directories); defaults to the
        released ones present locally. prior_paths: {model basename: prior
        .th path}; a model it does not name takes its released companion prior
        (PRIOR_MODELS) where that file is present locally."""
        self.model_paths = list(model_paths) if model_paths is not None else default_model_paths()
        self.prior_paths = prior_paths or {}
        self.device = torch.device(device)
        self.models: Dict[str, tuple] = {}  # name -> (mapper, cfg, noise bank)
        self.perceptors: Dict[Tuple[str, Optional[str]], object] = {}
        self.vqgans: Dict[str, tuple] = {}  # key -> (vqgan, (lo, hi))
        self.priors: Dict[str, Prior] = {}  # prior path -> prior
        self.model_prior: Dict[str, str] = {}  # model name -> prior path
        self._mapper_apply: Dict[str, Callable] = {}
        self._stream_params: Dict[str, object] = {}

    def setup(self):
        for path in self.model_paths:
            name = os.path.basename(path.rstrip("/"))
            try:
                mapper, cfg, noise = checkpoint.load_model(path, device=self.device)
            except NotImplementedError as e:
                # an unknown model_type (a future or foreign checkpoint; every
                # released family loads, from a .th, a legacy pickle or a JAX
                # directory): serve the loadable models instead of failing, as
                # the JAX Predictor does; a damaged file still fails setup()
                log.warning("skipping %s: %s", name, e)
                continue
            self.models[name] = (mapper, cfg, noise)
            prior_path = self.prior_paths.get(name)
            if prior_path is None and os.path.exists(PRIOR_MODELS.get(name, "")):
                prior_path = PRIOR_MODELS[name]
            if prior_path:
                if prior_path not in self.priors:
                    self.priors[prior_path] = load_prior_model(prior_path, device=self.device)
                self.model_prior[name] = prior_path
            dtype = dtype_of(cfg)
            pkey = (cfg.get("clip_model"), cfg.get("clip_model_path"))
            if pkey not in self.perceptors:
                self.perceptors[pkey] = load_perceptor(*pkey, dtype=dtype, device=self.device,
                                                       image=False)
            vkey = _vqgan_key(cfg)
            if vkey not in self.vqgans:
                vq = load_vqgan(cfg, dtype, device=self.device)
                self.vqgans[vkey] = (vq, latent_bounds(vq))
            self._mapper_apply[name] = make_mapper_apply(mapper)
            if streamed_supported(mapper):
                self._stream_params[name] = prepare_streamed_params(mapper)
        log.info("Predictor ready: %d models, %d perceptors, %d vqgans, %d priors",
                 len(self.models), len(self.perceptors), len(self.vqgans), len(self.priors))

    def route(self, model: str, n: int) -> str:
        """"stream" (the whole block stack in one launch) or "block" (the
        per-block path) for a request of n images."""
        return "stream" if n <= STREAM_MAX_BATCH and model in self._stream_params else "block"

    @torch.no_grad()
    def predict(self, prompt: str, model: Optional[str] = None, prior: bool = False,
                grid_size: str = "1x1", seed: Optional[int] = None, out_path: str = "out.png",
                mark: Optional[Callable[[str], None]] = None) -> str:
        """prompt -> PNG grid path. `mark(stage)`, where given, is called as each
        of STAGES ends (for CUDA-event timing); the PNG is encoded after them."""
        mark = mark or (lambda stage: None)
        gen = torch.Generator().manual_seed(
            int(np.random.randint(0, 2**31)) if seed is None else int(seed))
        if model is None:
            model = list(self.models)[int(torch.randint(len(self.models), (), generator=gen))]
        mapper, cfg, noise_bank = self.models[model]
        perceptor = self.perceptors[(cfg.get("clip_model"), cfg.get("clip_model_path"))]
        vq, (lo, hi) = self.vqgans[_vqgan_key(cfg)]
        gh, gw = (int(v) for v in grid_size.split("x"))
        n = gh * gw

        toks = torch.from_numpy(bpe.get_tokenizer().tokenize([prompt], truncate=True)).long()
        h = perceptor.encode_text(toks.to(self.device)).float()
        if cfg.get("normalize_input"):
            h = normalize(h)
        h = h.repeat(n, 1)
        mark("text")
        if prior and model in self.model_prior:  # else prior=True is ignored
            h = self.priors[self.model_prior[model]].sample(h, gen)
        mark("prior")
        noise_dim = int(cfg.get("noise_dim") or 0)
        if noise_dim:
            if noise_bank is not None and len(noise_bank) >= n:
                nz = noise_bank[:n]
            else:
                nz = torch.randn(n, noise_dim, generator=gen)
            h = torch.cat([h, nz.to(self.device, h.dtype)], dim=1)
        if self.route(model, n) == "stream":
            z = streamed_mixer_forward(mapper, self._stream_params[model], h)
        else:
            z = self._mapper_apply[model](h)
        mark("mapper")
        # float32: the bf16 latent is clamped against the f32 bounds
        imgs = synth(vq, clamp_with_grad(z.float(), lo, hi)).float()
        mark("decode")
        save_image(make_grid(imgs.cpu().numpy(), nrow=gw), out_path)
        return out_path

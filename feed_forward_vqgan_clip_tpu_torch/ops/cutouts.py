"""MakeCutouts: pooled views + augmentations feeding the CLIP image encoder.

Port of feed_forward_vqgan_clip_tpu/ops/cutouts.py (the reference's MakeCutouts):
  * (adaptive_avg_pool + adaptive_max_pool) / 2 to pool_size;
  * the pooled batch tiled `cutn` times, cutn-major (torch .repeat(cutn, 1, 1, 1));
    the loss tiles its targets the same way;
  * the augmentation pipeline from 2-character codes, default ('Af', 'Pe', 'Ji',
    'Er'), the set the port has (ops/augment.py);
  * additive noise: per-sample factor ~ U(0, noise_fac) times N(0, 1) noise, in
    the batch's dtype.

Images are NHWC; random draws come from the torch.Generator the call is given.
The JAX package's `fuse_geometric` (Af+Pe composed into one warp) is ROADMAP
A13; its unpooled and `interpolate` variants wait for a caller.
"""

from typing import Optional, Sequence

import torch

from feed_forward_vqgan_clip_tpu_torch.ops.augment import build_augment_pipeline
from feed_forward_vqgan_clip_tpu_torch.ops.pooling import adaptive_avg_pool, adaptive_max_pool


class MakeCutouts:
    def __init__(self, cut_size: int, cutn: int, augs: Optional[Sequence[str]] = None,
                 pool_size: Optional[int] = None, noise_fac: float = 0.1):
        self.cut_size = cut_size
        self.cutn = cutn
        self.pool_size = pool_size if pool_size is not None else cut_size
        self.noise_fac = noise_fac
        # an empty or None list means the DEFAULT set, as in the reference
        self.codes = list(augs) if augs else ["Af", "Pe", "Ji", "Er"]
        self.augs = build_augment_pipeline(self.codes)

    def __call__(self, generator: torch.Generator, x):
        """x (B, H, W, 3) in [0, 1] -> (cutn*B, h', w', 3) in x's dtype."""
        pooled = (adaptive_avg_pool(x, self.pool_size) + adaptive_max_pool(x, self.pool_size)) / 2.0
        batch = pooled.repeat(self.cutn, 1, 1, 1)
        for aug in self.augs:
            batch = aug(generator, batch)
        if self.noise_fac:
            n = batch.shape[0]
            facs = (torch.rand(n, 1, 1, 1, generator=generator, device=batch.device)
                    * self.noise_fac).to(batch.dtype)
            noise = torch.randn(batch.shape, generator=generator, device=batch.device,
                                dtype=batch.dtype)
            batch = batch + facs * noise
        return batch

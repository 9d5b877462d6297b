"""MakeCutouts: pooled or whole views + augmentations feeding the CLIP image
encoder.

Port of feed_forward_vqgan_clip_tpu/ops/cutouts.py (the reference's MakeCutouts):
  * pool=True: (adaptive_avg_pool + adaptive_max_pool) / 2 to pool_size;
    pool=False: the images as they are;
  * the batch tiled `cutn` times, cutn-major (torch .repeat(cutn, 1, 1, 1)); the
    loss tiles its targets the same way;
  * the augmentation pipeline from 2-character codes, default ('Af', 'Pe', 'Ji',
    'Er') (ops/augment.py); with `fuse_geometric` each Af, Pe pair is one
    composed warp (`fused_affine_perspective`). A crop code (Cr, Re, Re2, Cc)
    cuts cut_size x cut_size views from whatever size the batch has: from the
    unpooled render, or from a pool_size other than cut_size, its warp has an
    output frame other than its input's;
  * additive noise: per-sample factor ~ U(0, noise_fac) times N(0, 1) noise, in
    the batch's dtype;
  * interpolate=True: adaptive_avg_pool of the result to interp_size.

Images are NHWC; random draws come from the torch.Generator the call is given,
in the pipeline's order, then the noise factors and the noise.
"""

from typing import Optional, Sequence

import torch

from feed_forward_vqgan_clip_tpu_torch.ops.augment import (
    build_augment_pipeline,
    fused_affine_perspective,
)
from feed_forward_vqgan_clip_tpu_torch.ops.pooling import adaptive_avg_pool, adaptive_max_pool


class MakeCutouts:
    def __init__(self, cut_size: int, cutn: int, augs: Optional[Sequence[str]] = None,
                 pool: bool = True, pool_size: Optional[int] = None, interpolate: bool = False,
                 interp_size: Optional[int] = None, noise_fac: float = 0.1,
                 fuse_geometric: bool = False):
        self.cut_size = cut_size
        self.cutn = cutn
        self.pool = pool
        self.pool_size = pool_size if pool_size is not None else cut_size
        self.interpolate = interpolate
        self.interp_size = interp_size if interp_size is not None else self.pool_size
        self.noise_fac = noise_fac
        # an empty or None list means the DEFAULT set, as in the reference
        self.codes = list(augs) if augs else ["Af", "Pe", "Ji", "Er"]
        self.augs = []
        i = 0
        while i < len(self.codes):
            if fuse_geometric and self.codes[i:i + 2] == ["Af", "Pe"]:
                self.augs.append(fused_affine_perspective)
                i += 2
            else:
                self.augs.extend(build_augment_pipeline(self.codes[i:i + 1], cut_size))
                i += 1

    def __call__(self, generator: torch.Generator, x):
        """x (B, H, W, 3) in [0, 1] -> (cutn*B, h', w', 3) in x's dtype (float32
        after a code that promotes, as in the JAX package)."""
        if self.pool:
            x = (adaptive_avg_pool(x, self.pool_size) + adaptive_max_pool(x, self.pool_size)) / 2.0
        batch = x.repeat(self.cutn, 1, 1, 1)
        for aug in self.augs:
            batch = aug(generator, batch)
        if self.noise_fac:
            n = batch.shape[0]
            facs = (torch.rand(n, 1, 1, 1, generator=generator, device=batch.device)
                    * self.noise_fac).to(batch.dtype)
            noise = torch.randn(batch.shape, generator=generator, device=batch.device,
                                dtype=batch.dtype)
            batch = batch + facs * noise
        if self.interpolate:
            batch = adaptive_avg_pool(batch, self.interp_size)
        return batch

"""Frechet Inception Distance math, on the host (numpy and scipy).

The port's own copy of feed_forward_vqgan_clip_tpu/eval/fid.py (the reference
uses piq.FID): FID between two feature sets = ||mu1 - mu2||^2 + tr(C1 + C2 -
2 sqrtm(C1 @ C2)).
"""

import numpy as np
from scipy import linalg


def _sqrtm(m):
    out = linalg.sqrtm(m)
    return out[0] if isinstance(out, tuple) else out


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray, eps: float = 1e-6) -> float:
    """feats: (N, D) activation features (e.g. InceptionV3 pool3)."""
    mu1, mu2 = feats_a.mean(axis=0), feats_b.mean(axis=0)
    c1 = np.cov(feats_a, rowvar=False)
    c2 = np.cov(feats_b, rowvar=False)
    diff = mu1 - mu2
    covmean = _sqrtm(c1 @ c2)
    if not np.isfinite(covmean).all():
        offset = np.eye(c1.shape[0]) * eps
        covmean = _sqrtm((c1 + offset) @ (c2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(c1) + np.trace(c2) - 2 * np.trace(covmean))

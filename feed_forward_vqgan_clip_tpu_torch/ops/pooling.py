"""Adaptive average / max pooling for NHWC images, with deterministic backwards.

Port of feed_forward_vqgan_clip_tpu/ops/pooling.py. The reference's cutout
module uses torch's AdaptiveAvgPool2d / AdaptiveMaxPool2d; their windows are
kept (output cell i covers [floor(i*in/out), ceil((i+1)*in/out))), but not
their CUDA backwards, which add with atomics: two runs of a step would differ in
the last bits, and the straight-through VQ turns that into other codes. Here, as
in the JAX file, the average is two matmuls with (out, in) window matrices, and
the max is shifted running maxima (`torch.maximum`) selected by one-hot
matmuls, so both backwards are matmuls and elementwise maxima: the same bits on
every run. At a window holding two equal maxima `torch.maximum`'s backward
splits the gradient between them, as `jnp.maximum`'s does, so the gradients
match the JAX package's there too.
"""

import functools

import numpy as np
import torch


def _window(i, in_size, out_size):
    return (i * in_size) // out_size, -((-(i + 1) * in_size) // out_size)


@functools.lru_cache(maxsize=64)
def _avg_matrix(in_size: int, out_size: int, dtype, device) -> torch.Tensor:
    """(out, in): row i averages window i; in `dtype` (bf16 rounds 1/3 as JAX's
    cast does)."""
    w = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        s, e = _window(i, in_size, out_size)
        w[i, s:e] = 1.0 / (e - s)
    return torch.from_numpy(w).to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=64)
def _max_select(in_size: int, out_size: int, dtype, device):
    """{window length k: (out, in) one-hot S_k}: S_k[i, start_i] = 1 for the
    outputs whose window has length k, so out = sum_k S_k @ z_k with z_k[p] =
    max(x[p..p+k))."""
    windows = [_window(i, in_size, out_size) for i in range(out_size)]
    mats = {}
    for k in range(1, max(e - s for s, e in windows) + 1):
        sel = np.zeros((out_size, in_size), np.float32)
        for i, (s, e) in enumerate(windows):
            if e - s == k:
                sel[i, s] = 1.0
        if sel.any():
            mats[k] = torch.from_numpy(sel).to(device=device, dtype=dtype)
    return mats


def adaptive_avg_pool(x, size: int):
    """x (B, H, W, C) -> (B, size, size, C) in x's dtype."""
    _, h, w, _ = x.shape
    x = torch.einsum("oh,bhwc->bowc", _avg_matrix(h, size, x.dtype, x.device), x)
    return torch.einsum("ow,bhwc->bhoc", _avg_matrix(w, size, x.dtype, x.device), x)


def _running_max(x, dim: int, max_len: int):
    """[z_1, ..., z_max_len], z_k[p] = max(x[p..p+k)) along `dim`; the last k - 1
    entries of z_k (never selected) keep z_{k-1}'s."""
    outs = [x]
    cur = x
    n = x.shape[dim]
    for k in range(2, max_len + 1):
        merged = torch.maximum(cur.narrow(dim, 0, n - k + 1), x.narrow(dim, k - 1, n - k + 1))
        cur = torch.cat([merged, cur.narrow(dim, n - k + 1, k - 1)], dim)
        outs.append(cur)
    return outs


def _max_pool_axis(x, size: int, dim: int):
    mats = _max_select(x.shape[dim], size, x.dtype, x.device)
    zs = _running_max(x, dim, max(mats))
    spec = "oi,bihc->bohc" if dim == 1 else "oi,bhic->bhoc"
    out = None
    for k, sel in mats.items():
        term = torch.einsum(spec, sel, zs[k - 1])
        out = term if out is None else out + term
    return out


def adaptive_max_pool(x, size: int):
    """x (B, H, W, C) -> (B, size, size, C) in x's dtype."""
    return _max_pool_axis(_max_pool_axis(x, size, 1), size, 2)

"""Nearest-codebook search on the card: the CUDA kernel in csrc/vq_lookup.cu.

Replaces feed_forward_vqgan_clip_tpu/ops/pallas/vq_lookup.py
(`_vq_kernel`, `nearest_codebook_indices_pallas`). Both compute the first-match
argmin_k (|c_k|^2 - 2 x.c_k); the per-row |x|^2 of the expanded distance is the
same for every code and is dropped. |c|^2 is one plain torch reduction here, as
the JAX wrapper computes it outside its kernel. See the .cu file for the design
and what bounds it on an H100.
"""

import torch

from feed_forward_vqgan_clip_tpu_torch.ops.kernels import build

_TOKENS_PER_BLOCK = 64  # kTN in csrc/vq_lookup.cu
_CODES_PER_TILE = 64    # kTK


def nearest_codebook_indices_plain(x, codebook):
    """argmin_k (|c_k|^2 - 2 x.c_k) for x (N, C) f32, codebook (K, C) f32 -> int32 (N,).

    Materializes the (N, K) score matrix; torch.argmin returns the first minimum."""
    c2 = codebook.float().square().sum(-1)
    scores = c2[None, :] - 2.0 * (x.float() @ codebook.float().T)
    return scores.argmin(-1).to(torch.int32)


def split_plan(n, k, sms):
    """(splits, codes_per_split): codebook ranges per block, enough for two
    blocks per SM at small N."""
    n_tiles = -(-n // _TOKENS_PER_BLOCK)
    k_tiles = -(-k // _CODES_PER_TILE)
    splits = max(1, min(k_tiles, -(-2 * sms // n_tiles)))
    codes_per_split = -(-k_tiles // splits) * _CODES_PER_TILE
    return -(-k // codes_per_split), codes_per_split


def nearest_codebook_indices_kernel(x, codebook):
    """First-match nearest-codebook indices for x (N, C), codebook (K, C) -> int32 (N,).

    A CUDA tensor launches the kernel; a CPU tensor runs the plain version."""
    if x.device.type == "cpu":
        return nearest_codebook_indices_plain(x, codebook)
    if x.device.type != "cuda" or codebook.device != x.device:
        raise ValueError(f"x on {x.device}, codebook on {codebook.device}: need one CUDA device")
    if x.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError(f"vq kernel takes float32, got {x.dtype} and {codebook.dtype}")
    if x.dim() != 2 or codebook.dim() != 2 or x.shape[1] != codebook.shape[1]:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(codebook.shape)}: need (N, C), (K, C)")
    x = x.contiguous()
    codebook = codebook.contiguous()
    n, c = x.shape
    k = codebook.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    lib = build.load_library()
    c2 = codebook.square().sum(-1)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, codes_per_split = split_plan(n, k, sms)
    part_min = torch.empty(splits, n, dtype=torch.float32, device=x.device)
    part_arg = torch.empty(splits, n, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ffvc_vq_argmin(
            x.data_ptr(), codebook.data_ptr(), c2.data_ptr(), part_min.data_ptr(),
            part_arg.data_ptr(), out.data_ptr(), n, k, c, splits, codes_per_split,
            build.stream_handle(x.device),
        )
    build.check(err, "ffvc_vq_argmin")
    nearest_codebook_indices_kernel.launches += 1
    return out


nearest_codebook_indices_kernel.launches = 0

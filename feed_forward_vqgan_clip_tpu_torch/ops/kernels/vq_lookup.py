"""Nearest-codebook search on the card: the CUDA kernel in csrc/vq_lookup.cu.

Replaces feed_forward_vqgan_clip_tpu/ops/pallas/vq_lookup.py
(`_vq_kernel`, `nearest_codebook_indices_pallas`). Both compute the first-match
argmin_k (|c_k|^2 - 2 x.c_k); the per-row |x|^2 of the expanded distance is the
same for every code and is dropped. |c|^2 is one plain torch reduction here, as
the JAX wrapper computes it outside its kernel.

The kernel runs x.c on the bf16 tensor cores as six products of split operands
(each float32 value as three bf16 pieces, `bf16x3_split`), in one wgmma chain
per output tile, with the argmin in the chain's epilogue; `vq_plan` cuts the
codebook into the splits that fill the card. See the .cu file for the design and
what bounds it on an H100.
"""

import functools
from typing import NamedTuple

import torch

from feed_forward_vqgan_clip_tpu_torch.ops.kernels import build

VQ_ROWS = 128          # tokens of a row block (kWgBM in csrc/wgmma_gemm.cuh)
VQ_BN = 128            # codes of a column tile (vq::kBN in csrc/vq_lookup.cu)
VQ_CHANNEL_STEP = 64   # channels of one K step; the pieces are padded to a multiple


def nearest_codebook_indices_plain(x, codebook):
    """argmin_k (|c_k|^2 - 2 x.c_k) for x (N, C) f32, codebook (K, C) f32 -> int32 (N,).

    Materializes the (N, K) score matrix; torch.argmin returns the first minimum."""
    c2 = codebook.float().square().sum(-1)
    scores = c2[None, :] - 2.0 * (x.float() @ codebook.float().T)
    return scores.argmin(-1).to(torch.int32)


def bf16x3_split(v):
    """The three bf16 pieces of float32 v: h = bf16(v), m = bf16(v - h), l =
    bf16(v - h - m), so that v = h + m + l exactly wherever the pieces stay in
    bf16's normal range; h is taken towards zero where rounding would carry a
    finite v to infinity. The plain version of csrc/vq_lookup.cu `split3`."""
    v = v.float()
    h = v.to(torch.bfloat16)
    toward_zero = (v.view(torch.int32) & -65536).view(torch.float32).to(torch.bfloat16)
    h = torch.where(h.isinf() & v.isfinite(), toward_zero, h)
    r = v - h.float()
    m = r.to(torch.bfloat16)
    return h, m, (r - m.float()).to(torch.bfloat16)


class VqPlan(NamedTuple):
    """The search's launch: row_blocks x splits CTAs; split s takes the column tiles
    [s col_tiles // splits, (s + 1) col_tiles // splits) of VQ_BN codes, and CTA i
    holds split i // row_blocks and row block i % row_blocks (csrc/vq_lookup.cu)."""

    channels: int    # C padded to a multiple of VQ_CHANNEL_STEP
    row_blocks: int
    col_tiles: int
    splits: int
    bn: int = VQ_BN

    @property
    def ctas(self):
        return self.row_blocks * self.splits

    def split_codes(self, s, k):
        """The codes [begin, end) of split s over a codebook of k."""
        t0 = s * self.col_tiles // self.splits
        t1 = (s + 1) * self.col_tiles // self.splits
        return t0 * self.bn, min(k, t1 * self.bn)


@functools.lru_cache(maxsize=64)
def vq_plan(n, k, c, sms):
    """The splits of the codebook for N tokens, K codes of C channels on `sms` SMs
    (one CTA an SM: the ring takes most of its shared memory). Time in tile
    units: waves (ceil(CTAs / sms)) x the longest split's column tiles. The
    fewest such units; among plans of equal time one that fills the card (CTAs
    >= sms, where there are that many tiles), then the fewest CTAs (fewer ring
    fills and partials to fold). N=256 (2 row blocks) takes 66 splits: 132 CTAs
    of 1-2 tiles; N=1024 32 splits: 256 CTAs, two waves of 4 tiles."""
    row_blocks = -(-n // VQ_ROWS)
    col_tiles = -(-k // VQ_BN)
    fill = min(sms, row_blocks * col_tiles)
    best = None
    for splits in range(1, col_tiles + 1):
        ctas = row_blocks * splits
        key = (-(-ctas // sms) * -(-col_tiles // splits), ctas < fill, ctas)
        if best is None or key < best[0]:
            best = (key, splits)
    channels = max(-(-c // VQ_CHANNEL_STEP), 1) * VQ_CHANNEL_STEP
    return VqPlan(channels, row_blocks, col_tiles, best[1])


def split_pieces(x, codebook, channels):
    """x (N, C), codebook (K, C) float32 -> their pieces (3, N, channels), (3, K,
    channels) bf16 (h, m, l; channels zero-padded). A CUDA tensor launches
    csrc/vq_lookup.cu's split kernel, a CPU tensor runs `bf16x3_split`."""
    n, c = x.shape
    k = codebook.shape[0]
    if x.device.type == "cpu":
        def pieces(v):
            return torch.stack(bf16x3_split(torch.nn.functional.pad(v, (0, channels - c))))
        return pieces(x), pieces(codebook)
    xp = torch.empty(3, n, channels, dtype=torch.bfloat16, device=x.device)
    cp = torch.empty(3, k, channels, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = build.load_library().ffvc_vq_split(
            x.data_ptr(), codebook.data_ptr(), xp.data_ptr(), cp.data_ptr(), n, k, c, channels,
            build.stream_handle(x.device))
    build.check(err, "ffvc_vq_split")
    return xp, cp


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
    if codebook.shape[0] == 0:
        raise ValueError("vq kernel needs a codebook of at least one code")
    x = x.contiguous()
    codebook = codebook.contiguous()
    n, c = x.shape
    k = codebook.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    lib = build.load_library()
    c2 = codebook.square().sum(-1)
    plan = vq_plan(n, k, c, torch.cuda.get_device_properties(x.device).multi_processor_count)
    xp, cp = split_pieces(x, codebook, plan.channels)
    part_min = torch.empty(plan.splits, n, dtype=torch.float32, device=x.device)
    part_arg = torch.empty(plan.splits, n, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ffvc_vq_argmin(
            xp.data_ptr(), cp.data_ptr(), c2.data_ptr(), part_min.data_ptr(),
            part_arg.data_ptr(), out.data_ptr(), n, k, plan.channels, plan.splits,
            build.stream_handle(x.device),
        )
    build.check(err, "ffvc_vq_argmin")
    nearest_codebook_indices_kernel.launches += 1
    return out


nearest_codebook_indices_kernel.launches = 0

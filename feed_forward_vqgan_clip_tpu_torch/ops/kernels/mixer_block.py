"""One inference MLP-Mixer block on the card: the CUDA kernels in csrc/mixer_block.cu.

Replaces feed_forward_vqgan_clip_tpu/ops/pallas/mixer_block.py `_block_kernel`
(`fused_mixer_block` -> `_fused_mixer_block_impl`) and `_pipe_kernel`
(`_fused_mixer_block_pipe_impl`, the same function on a skewed TPU schedule at
B >= 16). Per batch element x (T, D), following `_block_math`:

    xn = LN(x)                                  f32 statistics, eps 1e-5
    g1 = gelu(t1^T xn + t1b)                    (Et, D), per-hidden-token bias
    r  = x + (t2^T g1 + t2b)                    (T, D), per-token bias
    y  = r + (gelu(LN(r) W1 + b1) W2 + b2)      channel FF over D -> Ec -> D

`mixer_block` launches two LayerNorm-rows kernels and four GEMMs with fused
bias / exact-GELU / residual epilogues: the token GEMMs batched over B with the
weights shared (batch stride 0), the channel GEMMs with the batch folded into
M = B*T rows. Where a GEMM's output tiles would leave SMs idle (small batch),
`split_k_plan` cuts K across blocks and an f32 workspace collects the ranges. The TPU-only parts of the Pallas kernel (polynomial erf, pair and
diagnostic knobs, VMEM gates) have no counterpart.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from feed_forward_vqgan_clip_tpu_torch.ops.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh DType
# (BM, BN, BK) of gemm_f32_kernel / gemm_bf16_kernel in csrc/mixer_block.cu
_TILES = {torch.float32: (64, 64, 16), torch.bfloat16: (128, 128, 32)}
_MAX_SPLITS = 16


def split_k_plan(m, n, k, batch, dtype, sms):
    """(splits, k_per_split): cut K into ranges while the output tiles alone fill
    fewer blocks than the card has SMs, keeping at least 4 K-tiles per range."""
    bm, bn, bk = _TILES[dtype]
    blocks = -(-m // bm) * -(-n // bn) * batch
    splits = 1
    while splits < _MAX_SPLITS and blocks * splits < sms and k >= 8 * bk * splits:
        splits *= 2
    k_per_split = -(-k // (splits * bk)) * bk
    return -(-k // k_per_split), k_per_split


class MixerBlockWeights(NamedTuple):
    """One block's parameters as the kernels take them: matrices in the working
    dtype, in torch's layouts (Conv1d (out, in), Linear (out, in)); norms and
    biases float32. Built by models.mappers.mixer.MixerBlock.kernel_weights."""

    ln1_w: torch.Tensor  # (D,)
    ln1_b: torch.Tensor  # (D,)
    t1: torch.Tensor     # (Et, T)
    t1b: torch.Tensor    # (Et,)
    t2: torch.Tensor     # (T, Et)
    t2b: torch.Tensor    # (T,)
    ln2_w: torch.Tensor  # (D,)
    ln2_b: torch.Tensor  # (D,)
    w1: torch.Tensor     # (Ec, D)
    b1: torch.Tensor     # (Ec,)
    w2: torch.Tensor     # (D, Ec)
    b2: torch.Tensor     # (D,)


def _layer_norm_plain(x, weight, bias):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    inv = torch.rsqrt(var.clamp_min(0.0) + 1e-5)
    return ((xf * inv - mean * inv) * weight + bias).to(x.dtype)


def mixer_block_plain(x, w: MixerBlockWeights):
    """The same block in plain PyTorch ops, for x (B, T, D) float32 or bfloat16."""
    dt = x.dtype
    xn = _layer_norm_plain(x, w.ln1_w, w.ln1_b)
    g1 = F.gelu(torch.matmul(w.t1, xn).float() + w.t1b[:, None]).to(dt)
    r = x + (torch.matmul(w.t2, g1).float() + w.t2b[:, None]).to(dt)
    rn = _layer_norm_plain(r, w.ln2_w, w.ln2_b)
    g3 = F.gelu(F.linear(rn, w.w1).float() + w.b1).to(dt)
    return r + (F.linear(g3, w.w2).float() + w.b2).to(dt)


def _check(x, w):
    if x.device.type != "cuda":
        raise ValueError(f"mixer block kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"mixer block kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, D), got {tuple(x.shape)}")
    _, t, d = x.shape
    et, ec = w.t1.shape[0], w.w1.shape[0]
    shapes = {
        "ln1_w": (d,), "ln1_b": (d,), "t1": (et, t), "t1b": (et,), "t2": (t, et),
        "t2b": (t,), "ln2_w": (d,), "ln2_b": (d,), "w1": (ec, d), "b1": (ec,),
        "w2": (d, ec), "b2": (d,),
    }
    for name, shape in shapes.items():
        v = getattr(w, name)
        want = x.dtype if name in ("t1", "t2", "w1", "w2") else torch.float32
        if tuple(v.shape) != shape or v.dtype != want or v.device != x.device:
            raise ValueError(
                f"weight {name}: {tuple(v.shape)} {v.dtype} on {v.device}, "
                f"need {shape} {want} on {x.device}"
            )
        if not v.is_contiguous():
            raise ValueError(f"weight {name} must be contiguous")


def mixer_block(x, w: MixerBlockWeights):
    """One Mixer block, x (B, T, D) -> (B, T, D) in x's dtype.

    A CUDA tensor launches the kernels; a CPU tensor runs the plain version."""
    if x.device.type == "cpu":
        return mixer_block_plain(x, w)
    _check(x, w)
    x = x.contiguous()
    b, t, d = x.shape
    et, ec = w.t1.shape[0], w.w1.shape[0]
    code = _DTYPE_CODE[x.dtype]
    lib = build.load_library()
    stream = build.stream_handle(x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count

    def ln(src, scale, bias, dst):
        err = lib.ffvc_ln_rows(src.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                               dst.data_ptr(), b * t, d, code, stream)
        build.check(err, "ffvc_ln_rows")

    def gemm(a, lda, sa, bm, ldb, sb, b_kmajor, c, ldc, sc, res, ldr, sr, bias,
             bias_mode, gelu, m, n, k, batch):
        splits, k_per_split = split_k_plan(m, n, k, batch, x.dtype, sms)
        work = None
        if splits > 1:
            work = torch.empty(batch * splits * m * n, dtype=torch.float32, device=x.device)
        err = lib.ffvc_gemm(
            a.data_ptr(), lda, sa, bm.data_ptr(), ldb, sb, b_kmajor, c.data_ptr(), ldc,
            sc, res.data_ptr() if res is not None else None, ldr, sr, bias.data_ptr(),
            bias_mode, gelu, m, n, k, batch, splits, k_per_split,
            work.data_ptr() if work is not None else None, code, stream,
        )
        build.check(err, "ffvc_gemm")

    with torch.cuda.device(x.device):
        xn = torch.empty_like(x)
        ln(x, w.ln1_w, w.ln1_b, xn)
        # token mixing, batched over B; weights shared (batch stride 0)
        g1 = torch.empty(b, et, d, dtype=x.dtype, device=x.device)
        gemm(w.t1, t, 0, xn, d, t * d, 0, g1, d, et * d, None, 0, 0, w.t1b, 1, 1,
             et, d, t, b)
        r = torch.empty_like(x)
        gemm(w.t2, et, 0, g1, d, et * d, 0, r, d, t * d, x, d, t * d, w.t2b, 1, 0,
             t, d, et, b)
        # channel mixing, batch folded into M = B*T rows; xn's buffer is reused
        ln(r, w.ln2_w, w.ln2_b, xn)
        g3 = torch.empty(b * t, ec, dtype=x.dtype, device=x.device)
        gemm(xn, d, 0, w.w1, d, 0, 1, g3, ec, 0, None, 0, 0, w.b1, 2, 1,
             b * t, ec, d, 1)
        out = torch.empty_like(x)
        gemm(g3, ec, 0, w.w2, ec, 0, 1, out, d, 0, r, d, 0, w.b2, 2, 0,
             b * t, d, ec, 1)
    mixer_block.launches += 1
    return out


mixer_block.launches = 0

"""The VQGAN decoder's residual add with its pending conv biases on the card: the
CUDA kernel in csrc/residual.cu.

Replaces no TPU kernel (the JAX decoder's adds are plain XLA, which fuses the
convolutions' biases). On the card the decoder's ResnetBlocks run their
convolutions without their biases where the kernels take them
(models/vqgan.py), and this add applies what is left: out = skip + h + vec[c],
summed in float32 in that order and rounded once, in one launch that reads
the two tensors and the vector. It reads channels-last and contiguous NCHW
operands as they lie (`residual_layout`); the decoder makes any other pair
contiguous. See the .cu file for what bounds it.
"""

import torch

from feed_forward_vqgan_clip_tpu_torch.ops.kernels import build
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.group_norm import (
    _DTYPE_CODE,
    NCHW,
    NHWC,
    autograd_records,
)

RES_VEC = 8  # elements of one vector (residual::kVec in csrc/residual.cu)
ELEMENTS = 2  # residual.cu's path 2: contiguous NCHW, one element a thread


def residual_add_plain(skip, h, vec):
    """skip + h + vec over the channels of (B, C, H, W) operands: float32 sums in
    that order, one rounding to h's dtype. vec (C,) float32."""
    out = skip.float() + h.float() + vec.reshape(1, -1, 1, 1)
    return out.to(h.dtype)


def residual_layout(skip, h):
    """How the kernel reads skip and h, of one shape and one dtype it takes: NHWC
    where both are channels-last with C a multiple of RES_VEC, NCHW where both are
    contiguous with H W a multiple of it (each at a 16-byte-aligned address), else
    ELEMENTS where both are contiguous; None otherwise."""
    if skip.shape != h.shape or skip.dtype != h.dtype or h.dim() != 4 or h.dtype not in _DTYPE_CODE:
        return None
    _, c, height, width = h.shape
    aligned = (skip.data_ptr() | h.data_ptr()) % 16 == 0
    cl = torch.channels_last
    if (aligned and c % RES_VEC == 0 and skip.is_contiguous(memory_format=cl)
            and h.is_contiguous(memory_format=cl)):
        return NHWC
    if skip.is_contiguous() and h.is_contiguous():
        return NCHW if aligned and height * width % RES_VEC == 0 else ELEMENTS
    return None


def residual_add(skip, h, vec):
    """skip + h + vec over the channels of (B, C, H, W) tensors, as
    `residual_add_plain` computes it: vec (C,) float32; out in h's dtype and
    layout.

    CPU operands take the plain form. CUDA operands launch the kernel and add 1
    to `residual_add.launches`; they raise where `residual_layout` reads no
    layout (ValueError) or autograd records a graph (RuntimeError: the kernel has
    no backward)."""
    if h.dim() != 4 or vec.shape != (h.shape[1],) or vec.dtype != torch.float32:
        raise ValueError(f"residual_add: h {tuple(h.shape)}, vec {tuple(vec.shape)} "
                         f"{vec.dtype}: need (B, C, H, W) and (C,) float32")
    if h.device.type != "cuda":
        return residual_add_plain(skip, h, vec)
    if skip.device != h.device or vec.device != h.device:
        raise ValueError(f"residual_add: skip on {skip.device}, h on {h.device}, vec on "
                         f"{vec.device}")
    path = residual_layout(skip, h)
    if path is None:
        raise ValueError(f"residual_add: skip {tuple(skip.shape)} {skip.dtype} and h "
                         f"{tuple(h.shape)} {h.dtype} in a layout the kernel does not read "
                         "(both channels-last or both contiguous, one shape, f32 or bf16)")
    if autograd_records(skip, h, vec):
        raise RuntimeError("residual_add: the kernel has no backward; autograd records here")
    out = torch.empty_like(h)  # h's layout
    if h.numel() == 0:
        return out
    vec = vec.contiguous()
    if vec.data_ptr() % 16:
        vec = vec.clone()
    _, c, height, width = h.shape
    lib = build.load_library()
    with torch.cuda.device(h.device):
        err = lib.ffvc_residual_add(skip.data_ptr(), h.data_ptr(), vec.data_ptr(),
                                    out.data_ptr(), h.numel(), c, height * width, path,
                                    _DTYPE_CODE[h.dtype],
                                    build.stream_handle(h.device))
    build.check(err, "ffvc_residual_add")
    residual_add.launches += 1
    return out


residual_add.launches = 0

"""The bilinear projective warp on the card: the CUDA kernel K9 in csrc/warp.cu.

Replaces feed_forward_vqgan_clip_tpu/ops/pallas/warp_forward.py (`_kernel`,
`_kernel_pipe`, reached through `warp_forward`). Both compute
`warp_perspective_inverse` in the image's dtype: each output pixel q of an
`out_hw` frame (the input's size unless given: the crops ask for cut_size x
cut_size) samples the input at s(q) = m(q) with the 4 bilinear taps, zeros or
border padding. The TPU kernel's row-window planner and its fallback to XLA
have no counterpart: the kernel is a direct gather that covers every draw and
every pair of frames. See the .cu file for the design and what bounds it on an
H100.
"""

import torch

from feed_forward_vqgan_clip_tpu_torch.ops.augment import warp_perspective_inverse
from feed_forward_vqgan_clip_tpu_torch.ops.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh DType
PADDING_MODES = ("zeros", "border")


def warp_forward_plain(img, m, padding_mode, out_hw=None):
    """`warp_perspective_inverse` in float32, cast to img's dtype."""
    return warp_perspective_inverse(img, m, padding_mode, out_hw).to(img.dtype)


def check_warp_args(name, x, m, padding_mode, other_hw):
    """The checks both warp wrappers make before a launch: x is the tensor the
    kernel reads, `other_hw` the (height, width) of the frame it writes."""
    if x.device.type != "cuda" or m.device != x.device:
        raise ValueError(f"{name}: tensors on {x.device} and {m.device}, need one CUDA device")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32 or bfloat16 images, got {x.dtype}")
    if x.dim() != 4 or min(x.shape[1:3]) < 2 or len(other_hw) != 2 or min(other_hw) < 2:
        raise ValueError(f"{name}: images must be (B, H, W, C) with both frames at least "
                         f"2x2, got {tuple(x.shape)} and {tuple(other_hw)}")
    if m.dtype != torch.float32 or tuple(m.shape) != (x.shape[0], 3, 3):
        raise ValueError(f"{name}: m must be ({x.shape[0]}, 3, 3) float32, got "
                         f"{tuple(m.shape)} {m.dtype}")
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"{name}: padding_mode {padding_mode!r}, need one of {PADDING_MODES}")


def warp_forward(img, m, padding_mode, out_hw=None):
    """img (B, H, W, C) f32 or bf16, m (B, 3, 3) f32 output->input maps -> the
    warped images (B, Ho, Wo, C) in img's dtype, (Ho, Wo) = out_hw or (H, W).

    A CUDA tensor launches the kernel, whatever the frames; a CPU tensor runs the
    plain version. Each launch adds one to `warp_forward.launches`, and one to
    `warp_forward.rect_launches` where (Ho, Wo) != (H, W)."""
    if img.device.type == "cpu":
        return warp_forward_plain(img, m, padding_mode, out_hw)
    b, h, w, c = img.shape
    ho, wo = (h, w) if out_hw is None else (int(out_hw[0]), int(out_hw[1]))
    check_warp_args("warp_forward", img, m, padding_mode, (ho, wo))
    img, m = img.contiguous(), m.contiguous()
    out = img.new_empty(b, ho, wo, c)
    if out.numel() == 0:
        return out
    lib = build.load_library()
    with torch.cuda.device(img.device):
        err = lib.ffvc_warp_forward(img.data_ptr(), m.data_ptr(), out.data_ptr(), b, h, w, ho,
                                    wo, c, int(padding_mode == "border"), _DTYPE_CODE[img.dtype],
                                    build.stream_handle(img.device))
    build.check(err, "ffvc_warp_forward")
    warp_forward.launches += 1
    warp_forward.rect_launches += (ho, wo) != (h, w)
    return out


warp_forward.launches = 0
warp_forward.rect_launches = 0  # the launches whose output frame is not the input's

"""The VQGAN decoder's GroupNorm with its SiLU on the card: the CUDA kernel pair in
csrc/group_norm.cu.

Replaces no TPU kernel (the JAX decoder's GroupNorm is plain XLA). In eager
PyTorch its plain form, `group_norm_silu_plain`, is 18 launches a norm over
float32 copies; the kernel is two launches: per-slice float32 (sum, sumsq)
partials, then the fold of each group's partials and the normalization, the
affine and the SiLU applied in float32 with one rounding. It reads
channels-last activations (the decoder's) and NCHW ones as they lie
(`kernel_layout`). `gn_plan` cuts each span into slices by its length alone, so
an image normalizes the same alone as in a batch. See the .cu file for the
design and what bounds it on an H100.

Both forms take an optional per-channel float32 `pre_bias`, added to x in
float32 before the statistics and the normalization: the bias of the
convolution that wrote x, which the decoder hands on to the norm in place of
the library's own bias pass (models/vqgan.py).
"""

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from feed_forward_vqgan_clip_tpu_torch.ops.kernels import build

EPS = 1e-6
GN_VEC = 8              # elements of one 16-byte load (gn::kVec in csrc/group_norm.cu)
GN_SLICE = 16384        # elements a slice holds at least, unless its span is shorter
GN_MAX_SPLITS = 64      # slices of a span at most: every CTA folds all of its span's pairs
GN_MAX_CHANNELS = 2048  # channels of a group, or of a channels-last image (gn::kMaxChannels)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh DType
NCHW, NHWC = 0, 1       # csrc/group_norm.cu gn::Path


def num_groups(channels):
    """32 groups, or one a channel where the channels are not a multiple of 32."""
    return 32 if channels % 32 == 0 else channels


def group_norm_silu_plain(x, weight, bias, *, silu=False, dtype=None, pre_bias=None):
    """GroupNorm (num_groups, eps 1e-6) of x (B, C, H, W) with float32 statistics,
    folded into one per-channel multiply-add applied in `dtype` (x's by default),
    then F.silu where `silu`. weight, bias (C,) float32. `pre_bias` (C,) float32:
    the norm of x + pre_bias, the sum taken in float32."""
    dtype = x.dtype if dtype is None else dtype
    b, c, h, w = x.shape
    groups = num_groups(c)
    xg = x.reshape(b, groups, c // groups, h * w)
    xf = xg.float()
    if pre_bias is not None:
        xg = xf = xf + pre_bias.reshape(groups, c // groups, 1)
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf.square().mean(dim=(2, 3), keepdim=True) - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + EPS)
    sc = weight.reshape(groups, c // groups, 1)
    bi = bias.reshape(groups, c // groups, 1)
    a = (inv * sc).to(dtype)
    shift = (bi - mean * inv * sc).to(dtype)
    y = (xg.to(dtype) * a + shift).reshape(b, c, h, w)
    return F.silu(y) if silu else y


def autograd_records(*tensors):
    """Whether autograd records a graph through an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class GnPlan(NamedTuple):
    """Each span of `length` elements cut into `splits` slices of `slice` (the last
    shorter): slice s is [s slice, min(length, (s + 1) slice)), and CTA i holds span
    i // splits, slice i % splits (csrc/group_norm.cu)."""

    splits: int
    slice: int

    def bounds(self, s, length):
        return s * self.slice, min(length, (s + 1) * self.slice)


@functools.lru_cache(maxsize=256)
def gn_plan(length, quantum=None):
    """The slices of a span of `length` elements: as many as leave each at least
    GN_SLICE elements, at most GN_MAX_SPLITS, each a multiple of `quantum`
    elements (default: GN_VEC where `length` is a multiple of it, else 1). The
    plan reads the span's length alone, so an image's statistics are summed in
    the same order whatever the batch; the batch multiplies the CTAs. At the
    decoder's levels, channels-last (a span an image): 8 slices at 16 x 16 x 512,
    64 from 64 x 64 x 256 up."""
    if quantum is None:
        quantum = GN_VEC if length % GN_VEC == 0 else 1
    splits = max(1, min(GN_MAX_SPLITS, length // GN_SLICE))
    size = -(-length // splits)
    size = -(-size // quantum) * quantum
    return GnPlan(-(-length // size), size)


def kernel_layout(x):
    """How the kernel reads x (B, C, H, W): NHWC where it is channels-last with C a
    power of two from GN_VEC to GN_MAX_CHANNELS at a 16-byte-aligned address, NCHW
    where it is contiguous; None where the kernel does not take it
    (`.contiguous()` makes any x NCHW)."""
    c = x.shape[1]
    if x.is_contiguous():
        return NCHW
    if (x.is_contiguous(memory_format=torch.channels_last) and GN_VEC <= c <= GN_MAX_CHANNELS
            and c & (c - 1) == 0 and x.data_ptr() % 16 == 0):
        return NHWC
    return None


def group_norm_silu(x, weight, bias, *, silu=False, pre_bias=None):
    """GroupNorm (num_groups, eps 1e-6) of x (B, C, H, W), or of x + pre_bias,
    then SiLU where `silu`, computed in x's dtype as `group_norm_silu_plain`
    computes it: weight, bias, pre_bias (C,) float32; out in x's dtype and shape.

    A CUDA tensor launches the two kernels (x float32 or bf16, laid out as
    `kernel_layout` takes it, no graph for autograd to record: the kernel has no
    backward), out in x's layout; a CPU tensor runs the plain version. Each call
    adds 2 to `group_norm_silu.launches`."""
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, weight, bias, silu=silu, pre_bias=pre_bias)
    params = (weight, bias) if pre_bias is None else (weight, bias, pre_bias)
    if x.device.type != "cuda" or any(p.device != x.device for p in params):
        raise ValueError(f"group_norm: x on {x.device}, weight, bias, pre_bias on "
                         f"{[str(p.device) for p in params]}: need one CUDA device")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"group_norm takes float32 or bfloat16 activations, got {x.dtype}")
    if any(p.dtype != torch.float32 for p in params):
        raise TypeError(f"group_norm takes float32 weight, bias and pre_bias, got "
                        f"{[p.dtype for p in params]}")
    if x.dim() != 4 or any(p.shape != (x.shape[1],) for p in params):
        raise ValueError(f"group_norm: x {tuple(x.shape)}, weight, bias, pre_bias "
                         f"{[tuple(p.shape) for p in params]}: need (B, C, H, W) and (C,)")
    path = kernel_layout(x)
    if path is None:
        raise ValueError("group_norm takes contiguous NCHW activations, or channels-last ones "
                         f"of 8 to {GN_MAX_CHANNELS} channels (a power of two) at a 16-byte-"
                         f"aligned address; got strides {x.stride()}")
    if autograd_records(x, *params):
        raise RuntimeError("group_norm has no backward: call it where autograd records no "
                           "graph, or take group_norm_silu_plain")
    b, c, h, w = x.shape
    groups = num_groups(c)
    cg, hw = c // groups, h * w
    if cg > GN_MAX_CHANNELS or c * hw >= 2**31:
        raise ValueError(f"group_norm: groups of {cg} channels, images of {c} x {hw} exceed the "
                         f"kernel's {GN_MAX_CHANNELS} channels or 2^31 elements")
    out = torch.empty_like(x)  # x's layout
    if x.numel() == 0:
        return out
    lib = build.load_library()
    if path == NHWC:  # a span an image, sliced into whole pixels
        spans, plan, pairs = b, gn_plan(c * hw, c), groups
    else:
        spans, plan, pairs = b * groups, gn_plan(cg * hw), 1
    partial = torch.empty(spans * plan.splits * pairs * 2, dtype=torch.float32, device=x.device)
    weight, bias = weight.contiguous(), bias.contiguous()
    pre_bias = None if pre_bias is None else pre_bias.contiguous()
    with torch.cuda.device(x.device):
        err = lib.ffvc_group_norm(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            None if pre_bias is None else pre_bias.data_ptr(), out.data_ptr(),
            partial.data_ptr(), spans, groups, cg, hw, plan.slice, plan.splits, EPS, int(silu),
            path, _DTYPE_CODE[x.dtype], build.stream_handle(x.device))
    build.check(err, "ffvc_group_norm")
    group_norm_silu.launches += 2
    return out


group_norm_silu.launches = 0

"""The whole MLP-Mixer block stack in one kernel launch: csrc/mixer_stream.cu (K4).

Replaces feed_forward_vqgan_clip_tpu/ops/pallas/mixer_block.py `_stream_kernel`
(`fused_mixer_stream` -> `_fused_mixer_stream_impl`): all L blocks over the
stacked, LN2-folded weights of `stack_mixer_params`, each block computing
`_block_math` (ops/kernels/mixer_block.py `mixer_block_stacked_plain`). The
TPU-only pair mode (`FFVC_MIXER_PAIR`, `_block_math_pair`) has no counterpart.

`mixer_stream` launches one persistent cooperative kernel for a CUDA tensor (its
grid is every block the card holds at once, from the occupancy calculator) and
runs the plain version, `mixer_stream_plain`, only for a CPU tensor; it counts
its launches on `.launches`. The activations ping-pong between two (B, T, D)
buffers beside the r, xn, g1 (B, Et, D) and g3 (B, T, Ec) workspaces and the
split-K partials, all allocated here on the current stream. A refused
cooperative launch (a grid that cannot be co-resident) raises.
"""

import ctypes
import functools

import torch

from feed_forward_vqgan_clip_tpu_torch.ops.kernels import build
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
    _DTYPE_CODE,
    STACKED_MATRICES,
    StackedMixerWeights,
    mixer_block_stacked_plain,
    split_k_plan,
)


def mixer_stream_plain(x, sp: StackedMixerWeights):
    """The stack in plain PyTorch: `mixer_block_stacked_plain` over the depth."""
    for i in range(sp.t1.shape[0]):
        x = mixer_block_stacked_plain(x, sp, i)
    return x


def gemm_plans(b, t, d, et, ec, dtype, sms):
    """The split-K plan (splits, k_per_split) of the kernel's four GEMMs, in the
    order token GEMM1, token GEMM2, channel GEMM1, channel GEMM2: the plan the
    per-block kernels use (ops/kernels/mixer_block.split_k_plan)."""
    return [split_k_plan(et, d, t, b, dtype, sms), split_k_plan(t, d, et, b, dtype, sms),
            split_k_plan(b * t, ec, d, 1, dtype, sms), split_k_plan(b * t, d, ec, 1, dtype, sms)]


def barriers_per_launch(layers, plans):
    """Grid-wide barriers in one launch: per block two LayerNorm phases and four
    GEMM phases, and one more for each GEMM whose split-K partials are summed."""
    return layers * (6 + sum(1 for s, _ in plans if s > 1))


@functools.lru_cache(maxsize=None)
def stream_grid(device: torch.device, dtype) -> int:
    """The kernel's grid on `device`: the blocks one SM holds at once (the
    occupancy calculator) times the SMs, so that every block is resident."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = build.load_library().ffvc_mixer_stream_blocks_per_sm(_DTYPE_CODE[dtype],
                                                                   ctypes.byref(per_sm))
    build.check(err, "ffvc_mixer_stream_blocks_per_sm")
    if per_sm.value < 1:
        raise RuntimeError("the mixer stream kernel fits no block on an SM")
    return per_sm.value * torch.cuda.get_device_properties(device).multi_processor_count


def _check(x, sp):
    if x.device.type != "cuda":
        raise ValueError(f"mixer stream kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"mixer stream kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, D), got {tuple(x.shape)}")
    _, t, d = x.shape
    layers, et, _ = sp.t1.shape
    ec = sp.w1f.shape[1]
    if layers < 1:
        raise ValueError("the stack holds no block")
    shapes = {
        "ln1_w": (d,), "ln1_b": (d,), "t1": (et, t), "t1b": (et,), "t2": (t, et),
        "t2b": (t,), "w1f": (ec, d), "b1f": (ec,), "w2": (d, ec), "b2": (d,),
    }
    for name, shape in shapes.items():
        v = getattr(sp, name)
        want = x.dtype if name in STACKED_MATRICES else torch.float32
        if tuple(v.shape) != (layers, *shape) or v.dtype != want or v.device != x.device:
            raise ValueError(
                f"stacked weight {name}: {tuple(v.shape)} {v.dtype} on {v.device}, "
                f"need {(layers, *shape)} {want} on {x.device}"
            )
        if not v.is_contiguous():
            raise ValueError(f"stacked weight {name} must be contiguous")


def mixer_stream(x, sp: StackedMixerWeights):
    """The L blocks of `sp` over x (B, T, D) -> (B, T, D) in x's dtype, in one
    kernel launch.

    A CUDA tensor launches the kernel; a CPU tensor runs the plain version."""
    if x.device.type == "cpu":
        return mixer_stream_plain(x, sp)
    _check(x, sp)
    x = x.contiguous()
    b, t, d = x.shape
    layers, et, _ = sp.t1.shape
    ec = sp.w1f.shape[1]
    grid = stream_grid(x.device, x.dtype)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plans = gemm_plans(b, t, d, et, ec, x.dtype, sms)
    # one f32 workspace serves every GEMM that splits K: (batch, splits, M, N)
    outs = ((et, d, b), (t, d, b), (b * t, ec, 1), (b * t, d, 1))
    partial_floats = max([batch * s * m * n for (s, _), (m, n, batch) in zip(plans, outs)
                          if s > 1], default=1)
    with torch.cuda.device(x.device):
        out, buf, r, xn = (torch.empty_like(x) for _ in range(4))
        g1 = torch.empty(b, et, d, dtype=x.dtype, device=x.device)
        g3 = torch.empty(b, t, ec, dtype=x.dtype, device=x.device)
        partial = torch.empty(partial_floats, dtype=torch.float32, device=x.device)
        barrier = torch.empty(1, dtype=torch.int32, device=x.device)  # zeroed by the launch
        err = build.load_library().ffvc_mixer_stream(
            x.data_ptr(), out.data_ptr(), buf.data_ptr(), r.data_ptr(), xn.data_ptr(),
            g1.data_ptr(), g3.data_ptr(), partial.data_ptr(), barrier.data_ptr(),
            *(getattr(sp, name).data_ptr() for name in StackedMixerWeights._fields),
            b, layers, t, d, et, ec, *(v for plan in plans for v in plan),
            grid, _DTYPE_CODE[x.dtype], build.stream_handle(x.device),
        )
    build.check(err, "ffvc_mixer_stream")
    mixer_stream.launches += 1
    return out


mixer_stream.launches = 0

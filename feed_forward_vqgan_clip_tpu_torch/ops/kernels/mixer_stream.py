"""The whole MLP-Mixer block stack in one kernel launch (K4):
csrc/mixer_stream_wgmma.cu in bf16 wherever TMA can read the operands,
csrc/mixer_stream.cu otherwise.

Replaces feed_forward_vqgan_clip_tpu/ops/pallas/mixer_block.py `_stream_kernel`
(`fused_mixer_stream` -> `_fused_mixer_stream_impl`): all L blocks over the
stacked, LN2-folded weights of `stack_mixer_params`, each block computing
`_block_math` (ops/kernels/mixer_block.py `mixer_block_stacked_plain`). The
TPU-only pair mode (`FFVC_MIXER_PAIR`, `_block_math_pair`) has no counterpart.

`mixer_stream` launches one persistent cooperative kernel for a CUDA tensor (its
grid is every CTA the card holds at once, from the occupancy calculator) and
runs the plain version, `mixer_stream_plain`, only for a CPU tensor; it counts
its launches on `.launches`. `stream_route` picks the kernel, a function of
dtype, shape and alignment, as `mixer_gemm_route` picks a block's tiles:

  * "wgmma" (bf16, every row length a multiple of 8, 16-byte-aligned bases):
    one CTA per SM walks each GEMM's tiles with the Hopper GEMM's TMA/wgmma
    pipeline (csrc/wgmma_gemm.cuh), its ring carried from phase to phase, a grid
    barrier after each phase; `stream_plan` cuts K where a GEMM's tiles would
    leave SMs idle;
  * "wmma" (other bf16 shapes) and "fma" (float32): the WMMA / FMA tile of
    csrc/mixer_tile.cuh in every block the card holds, with K2's split-K plan
    (`gemm_plans`).

The activations ping-pong between two (B, T, D) buffers beside the r, xn, g1
(B, Et, D) and g3 (B, T, Ec) workspaces and the split-K partials, all allocated
here on the current stream. A refused cooperative launch (a grid that cannot be
co-resident) raises.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from feed_forward_vqgan_clip_tpu_torch.ops.kernels import build, wgmma
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
    _DTYPE_CODE,
    STACKED_MATRICES,
    StackedMixerWeights,
    mixer_block_stacked_plain,
    split_k_plan,
)

STREAM_GEMMS = ("g1", "r", "g3", "out")
STREAM_BN = 128  # csrc/mixer_stream_wgmma.cu: the 128 x 128 tile of every GEMM phase
_K_STEP = 64     # K per ring stage
_MIN_K_STEPS = 8  # per split
_MAX_SPLITS = 16


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
    GEMM phases, and one more for each GEMM whose split-K partials are summed.
    `plans`: (splits, k_per_split) per GEMM (`gemm_plans`, or a StreamPlan's
    `splits` paired with anything)."""
    return layers * (6 + sum(1 for s, _ in plans if s > 1))


class StreamPlan(NamedTuple):
    """The wgmma route's launch plan, per GEMM in STREAM_GEMMS order: output
    tiles of 128 x 128 (the batch in the walk), K cut into `splits` ranges of
    `k_split` K steps of 64."""

    tiles: tuple
    splits: tuple
    k_split: tuple

    def barriers(self, layers):
        """Grid-wide barriers in one launch: per block the six phases, and a sum
        phase for g1 and g3 where they split (r's and out's ordered sums run
        inside the row phase after them)."""
        return layers * (6 + (self.splits[0] > 1) + (self.splits[2] > 1))


def stream_gemm_shapes(b, t, d, et, ec):
    """(M, N, K, batch) of g1, r, g3, out: the token GEMMs batched over B with the
    weight shared, the channel GEMMs with the batch folded into M = B*T."""
    return ((et, d, t, b), (t, d, et, b), (b * t, ec, d, 1), (b * t, d, ec, 1))


def stream_plan(b, t, d, et, ec, sms):
    """The wgmma route's plan on `sms` SMs: a GEMM doubles its K splits while the
    doubled tiles still fit in one wave and each split keeps at least 8 K steps
    of 64 (at the flagship, B=1: r 2 splits, g3 2, out 8; B=4: r and out 2; on
    one SM every K stays whole)."""
    tiles, splits, k_split = [], [], []
    for m, n, k, batch in stream_gemm_shapes(b, t, d, et, ec):
        n_tiles = wgmma.wgmma_tiles(m, n, STREAM_BN, batch)
        k_steps = -(-k // _K_STEP)
        cut = 1
        while (cut < _MAX_SPLITS and n_tiles * cut * 2 <= sms
               and k_steps >= _MIN_K_STEPS * cut * 2):
            cut *= 2
        per = -(-k_steps // cut)
        tiles.append(n_tiles)
        splits.append(-(-k_steps // per))
        k_split.append(per)
    return StreamPlan(tuple(tiles), tuple(splits), tuple(k_split))


def stream_partial_floats(plan: StreamPlan, b, t, d, et, ec) -> int:
    """float32 elements of the split-K partials under `plan`: the largest
    (splits, batch, M, N) of the GEMMs whose K is cut, 0 where none is."""
    shapes = stream_gemm_shapes(b, t, d, et, ec)
    return max([s * m * n * batch for s, (m, n, _, batch) in zip(plan.splits, shapes) if s > 1],
               default=0)


def stream_route(x, sp: StackedMixerWeights):
    """The kernel K4 takes for x on `sp`: "fma" in float32, "wgmma" in bf16 where
    TMA can read every operand (`wgmma.tma_ok`: T, D, Et, Ec multiples of 8 and
    16-byte-aligned bases), else "wmma". A function of dtype, shape and alignment."""
    if x.dtype == torch.float32:
        return "fma"
    _, t, d = x.shape
    et, ec = sp.t1.shape[1], sp.w1f.shape[1]
    if wgmma.tma_ok((t, d, et, ec), (x, *(getattr(sp, n) for n in STACKED_MATRICES))):
        return "wgmma"
    return "wmma"


@functools.lru_cache(maxsize=None)
def stream_grid(device: torch.device, dtype, route="wmma") -> int:
    """The kernel's grid on `device`: the CTAs one SM holds at once (the
    occupancy calculator) times the SMs, so that every CTA is resident."""
    per_sm = ctypes.c_int(0)
    lib = build.load_library()
    with torch.cuda.device(device):
        if route == "wgmma":
            err = lib.ffvc_mixer_stream_wgmma_blocks_per_sm(ctypes.byref(per_sm))
        else:
            err = lib.ffvc_mixer_stream_blocks_per_sm(_DTYPE_CODE[dtype], ctypes.byref(per_sm))
    build.check(err, "ffvc_mixer_stream_blocks_per_sm")
    if per_sm.value < 1:
        raise RuntimeError("the mixer stream kernel fits no CTA on an SM")
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
    route = stream_route(x, sp)
    with torch.cuda.device(x.device):
        if route == "wgmma":
            out = _launch_wgmma(x, sp)
        else:
            out = _launch_tile(x, sp)
    mixer_stream.launches += 1
    return out


def _workspaces(x, et, ec, partial_floats):
    b, t, _ = x.shape
    out, buf, r, xn = (torch.empty_like(x) for _ in range(4))
    g1 = torch.empty(b, et, x.shape[2], dtype=x.dtype, device=x.device)
    g3 = torch.empty(b, t, ec, dtype=x.dtype, device=x.device)
    partial = torch.empty(max(partial_floats, 4), dtype=torch.float32, device=x.device)
    barrier = torch.empty(1, dtype=torch.int32, device=x.device)  # zeroed by the launch
    return out, buf, r, xn, g1, g3, partial, barrier


def _launch_wgmma(x, sp, plan=None):
    """One launch of the wgmma route under `plan` (default `stream_plan`'s), on
    the current device; x contiguous, checked by `_check`."""
    b, t, d = x.shape
    layers, et, _ = sp.t1.shape
    ec = sp.w1f.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = plan or stream_plan(b, t, d, et, ec, sms)
    out, buf, r, xn, g1, g3, partial, barrier = _workspaces(
        x, et, ec, stream_partial_floats(plan, b, t, d, et, ec))
    ints = ctypes.c_int * 4
    err = build.load_library().ffvc_mixer_stream_wgmma(
        x.data_ptr(), out.data_ptr(), buf.data_ptr(), r.data_ptr(), xn.data_ptr(),
        g1.data_ptr(), g3.data_ptr(), partial.data_ptr(), barrier.data_ptr(),
        *(getattr(sp, name).data_ptr() for name in StackedMixerWeights._fields),
        b, layers, t, d, et, ec, ints(*plan.splits), ints(*plan.k_split),
        stream_grid(x.device, x.dtype, "wgmma"), build.stream_handle(x.device),
    )
    build.check(err, "ffvc_mixer_stream_wgmma")
    return out


def _launch_tile(x, sp):
    b, t, d = x.shape
    layers, et, _ = sp.t1.shape
    ec = sp.w1f.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plans = gemm_plans(b, t, d, et, ec, x.dtype, sms)
    # one f32 workspace serves every GEMM that splits K: (batch, splits, M, N)
    outs = ((et, d, b), (t, d, b), (b * t, ec, 1), (b * t, d, 1))
    partial_floats = max([batch * s * m * n for (s, _), (m, n, batch) in zip(plans, outs)
                          if s > 1], default=1)
    out, buf, r, xn, g1, g3, partial, barrier = _workspaces(x, et, ec, partial_floats)
    err = build.load_library().ffvc_mixer_stream(
        x.data_ptr(), out.data_ptr(), buf.data_ptr(), r.data_ptr(), xn.data_ptr(),
        g1.data_ptr(), g3.data_ptr(), partial.data_ptr(), barrier.data_ptr(),
        *(getattr(sp, name).data_ptr() for name in StackedMixerWeights._fields),
        b, layers, t, d, et, ec, *(v for plan in plans for v in plan),
        stream_grid(x.device, x.dtype), _DTYPE_CODE[x.dtype], build.stream_handle(x.device),
    )
    build.check(err, "ffvc_mixer_stream")
    return out


mixer_stream.launches = 0

"""The decoder's GroupNorm + SiLU on the CPU: the plain form the kernel pair of
csrc/group_norm.cu is held to, the route `GroupNorm32` takes, the layouts the
kernel reads, and the plan that cuts the spans into slices.

The plain form must equal the decoder's earlier GroupNorm followed by F.silu
bit for bit (`_earlier_norm_silu` is that code). The kernel itself runs only on
the card: tests/test_torch_gpu.py holds it to the plain form.
"""

import pytest
import torch
import torch.nn.functional as F

from feed_forward_vqgan_clip_tpu_torch.models import vqgan
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import GroupNorm32
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.group_norm import (
    GN_MAX_SPLITS,
    GN_SLICE,
    GN_VEC,
    NCHW,
    NHWC,
    autograd_records,
    gn_plan,
    group_norm_silu,
    group_norm_silu_plain,
    kernel_layout,
)

H100_SMS = 132
# (channels, side) of every GroupNorm in the f16-16384 decoder, 16 x 16 latent
DECODER_SHAPES = [(512, 16), (512, 32), (256, 32), (256, 64), (256, 128), (128, 128),
                  (128, 256)]
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


def _earlier_norm_silu(x, weight, bias, dtype, silu):
    """The decoder's GroupNorm32.forward as it was, then F.silu where asked."""
    b, c, h, w = x.shape
    groups = 32 if c % 32 == 0 else c
    xg = x.reshape(b, groups, c // groups, h * w)
    xf = xg.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf.square().mean(dim=(2, 3), keepdim=True) - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + 1e-6)
    sc = weight.reshape(groups, c // groups, 1)
    bi = bias.reshape(groups, c // groups, 1)
    a = (inv * sc).to(dtype)
    shift = (bi - mean * inv * sc).to(dtype)
    y = (xg.to(dtype) * a + shift).reshape(b, c, h, w)
    return F.silu(y) if silu else y


def _case(b, c, h, w, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, c, h, w, generator=g) * 1.5
         + torch.randn(1, c, 1, 1, generator=g)).to(dtype)
    weight = 1.0 + 0.1 * torch.randn(c, generator=g)
    bias = 0.1 * torch.randn(c, generator=g)
    return x, weight, bias


@DTYPES
@pytest.mark.parametrize("silu", [False, True], ids=["norm", "norm_silu"])
@pytest.mark.parametrize("c,h,w", [(64, 8, 8), (20, 5, 7), (8, 4, 4)],
                         ids=["groups32", "per_channel_ragged", "per_channel"])
def test_plain_form_is_the_earlier_norm_bitwise(c, h, w, silu, dtype):
    x, weight, bias = _case(2, c, h, w, dtype)
    want = _earlier_norm_silu(x, weight, bias, dtype, silu)
    assert torch.equal(group_norm_silu_plain(x, weight, bias, silu=silu), want)
    norm = GroupNorm32(c, dtype=dtype)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
        assert torch.equal(norm(x, silu=silu), want)
        # a float32 input to a bf16 norm: statistics of the float32 values
        xf = x.float()
        assert torch.equal(norm(xf, silu=silu), _earlier_norm_silu(xf, weight, bias, dtype, silu))
    assert torch.equal(group_norm_silu(x, weight, bias, silu=silu), want)  # CPU: plain


def test_autograd_records_only_with_grad_mode_and_a_tensor_that_requires_it():
    x = torch.ones(2)
    p = torch.ones(2, requires_grad=True)
    assert not autograd_records(x, x)
    assert autograd_records(x, p)
    assert autograd_records(p.detach().requires_grad_(True))
    with torch.no_grad():
        assert not autograd_records(x, p)
    with torch.inference_mode():
        assert not autograd_records(p)


def test_group_norm_route_on_the_cpu_and_where_autograd_records(monkeypatch):
    """takes_kernel: only a CUDA tensor with no graph to record. On the CPU the
    forward never reaches the kernel wrapper, with or without a graph; with a graph
    its gradient reaches x and the parameters through the plain form."""
    def refuse(*a, **k):
        raise AssertionError("the kernel route was taken")

    monkeypatch.setattr(vqgan, "group_norm_silu", refuse)
    norm = GroupNorm32(64)
    x, _, _ = _case(2, 64, 4, 4, torch.float32)
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            xx = x.clone().requires_grad_(grad)
            assert not norm.takes_kernel(xx)
            y = norm(xx, silu=True)
    y.sum().backward()
    assert xx.grad is not None and norm.weight.grad is not None
    frozen = GroupNorm32(64).requires_grad_(False)
    meta = torch.empty(2, 64, 4, 4, device="meta")
    assert not frozen.takes_kernel(meta)  # not a CUDA tensor


def test_kernel_route_refuses_another_dtype_and_keeps_the_layouts_it_reads(monkeypatch):
    """Where takes_kernel holds, the forward hands the kernel x as it is: in the
    compute dtype (another raises), channels-last where the kernel reads it, else
    made contiguous."""
    seen = []

    def kernel(x, weight, bias, *, silu=False, pre_bias=None):
        seen.append((x.dtype, x.is_contiguous(), silu))
        assert pre_bias is None
        return x

    monkeypatch.setattr(vqgan, "group_norm_silu", kernel)
    monkeypatch.setattr(GroupNorm32, "takes_kernel", lambda self, x: True)
    norm = GroupNorm32(64, dtype=torch.bfloat16)
    x = torch.randn(2, 64, 4, 4)
    with pytest.raises(TypeError):
        norm(x)
    norm(x.to(torch.bfloat16), silu=True)
    norm(x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last))
    GroupNorm32(96)(torch.randn(2, 96, 4, 4).contiguous(memory_format=torch.channels_last))
    assert seen == [(torch.bfloat16, True, True), (torch.bfloat16, False, False),
                    (torch.float32, True, False)]


def test_kernel_layout_reads_channels_last_powers_of_two_and_nchw():
    x = torch.empty(2, 64, 4, 4)
    assert kernel_layout(x) == NCHW
    assert kernel_layout(torch.empty(2, 64, 3, 5)) == NCHW
    assert kernel_layout(torch.empty(2 * 64 * 16 + 1)[1:].view(2, 64, 4, 4)) == NCHW
    assert kernel_layout(x.to(memory_format=torch.channels_last)) == NHWC
    cl = torch.empty(2, 96, 4, 4).to(memory_format=torch.channels_last)
    assert kernel_layout(cl) is None and kernel_layout(cl.contiguous()) == NCHW
    odd = torch.empty(2 * 64 * 16 + 1)[1:].view(2, 4, 4, 64).permute(0, 3, 1, 2)
    assert kernel_layout(odd) is None  # channels-last one element past 16 bytes
    assert kernel_layout(x.transpose(2, 3)) is None


@pytest.mark.parametrize("b", [1, 8, 256])
@pytest.mark.parametrize("c,side", DECODER_SHAPES)
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_gn_plan_at_the_decoder_levels(layout, b, c, side):
    """Slices cover each span once; the spans x splits CTAs fill the SMs where the
    spans hold GN_SLICE elements for each; NCHW slices are multiples of 8 where L
    is, channels-last ones whole pixels. The plan reads the span alone."""
    if layout == "nchw":
        spans, length, quantum = b * 32, (c // 32) * side * side, GN_VEC
        plan = gn_plan(length)
    else:
        spans, length, quantum = b, c * side * side, c
        plan = gn_plan(length, quantum)
    starts = [plan.bounds(s, length) for s in range(plan.splits)]
    assert starts[0][0] == 0 and starts[-1][1] == length
    assert all(e0 == s1 and s0 < e0 for (s0, e0), (s1, _) in zip(starts, starts[1:]))
    assert starts[-1][0] < starts[-1][1]
    assert plan.slice % quantum == 0 and plan.splits <= GN_MAX_SPLITS
    if spans * min(GN_MAX_SPLITS, length // GN_SLICE) >= H100_SMS:
        assert spans * plan.splits >= H100_SMS
    assert plan.slice >= min(length, GN_SLICE)
    if b == 256:  # every level fills the card's 132 SMs for several waves
        assert spans * plan.splits >= 4 * H100_SMS


@pytest.mark.parametrize("length", [1, 7, 30, 4096, 16400, 262144, 1 << 20])
@pytest.mark.parametrize("quantum", [None, 1, 64, 512])
def test_gn_plan_covers_ragged_spans(quantum, length):
    plan = gn_plan(length, quantum)
    assert plan.slice * (plan.splits - 1) < length <= plan.slice * plan.splits
    assert plan.slice % (quantum or (GN_VEC if length % GN_VEC == 0 else 1)) == 0

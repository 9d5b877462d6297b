"""The decoder's conv biases handed on to the hand-written passes, on the CPU.

On the card, where the decoder's norms take the kernel route, a conv whose
output a ResnetBlock reads next runs without its bias, and the pass that reads
the output adds it in float32: the GroupNorm pair as its pre-bias, the residual
add (csrc/residual.cu) in its per-channel vector. Here the plain forms those
kernels are held to on the card (tests/test_torch_gpu.py): the norm of x +
pre_bias, the residual add's float32 sum with one rounding, the 1x1 shortcut
carrying a pending bias through exactly, and the whole decoder with the biases
handed on (the route forced by monkeypatching `GroupNorm32.takes_kernel`)
against the decoder whose convs add their own, float32 within 1e-5 of max
|library|; the count of biases handed on and left to the library, held to
what each conv was called with; the operands the block hands the residual
add, in a layout the kernel reads.
"""

import pytest
import torch

from feed_forward_vqgan_clip_tpu_torch.models import vqgan
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import (
    Conv2d,
    Decoder,
    GroupNorm32,
    ResnetBlock,
    Upsample,
    make_vqgan,
)
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.group_norm import (
    NCHW,
    NHWC,
    autograd_records,
    group_norm_silu,
    group_norm_silu_plain,
)
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.residual import (
    ELEMENTS,
    residual_add,
    residual_add_plain,
    residual_layout,
)
from feed_forward_vqgan_clip_tpu_torch.registry import VQGAN_CONFIGS

TINY = dict(n_embed=32, embed_dim=8, z_channels=8, ch=8, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(4,), resolution=8)
TINY32 = dict(n_embed=64, embed_dim=16, z_channels=32, ch=32, ch_mult=(1, 2),
              num_res_blocks=1, attn_resolutions=(4,), resolution=8)
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


def _draw(*shape, seed=0, scale=1.0):
    return scale * torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("silu", [False, True], ids=["norm", "norm_silu"])
@pytest.mark.parametrize("c,h,w", [(64, 8, 8), (20, 5, 7)], ids=["groups32", "per_channel"])
def test_pre_bias_normalizes_x_plus_the_bias(c, h, w, silu):
    """The plain form with a pre-bias is the plain form of x + pre_bias, float32
    within 1e-6 of max |that|; GroupNorm32 and the wrapper on the CPU give the
    same; without one the result is what it was."""
    x = _draw(2, c, h, w, seed=1) * 1.5 + _draw(1, c, 1, 1, seed=2)
    weight, bias = 1.0 + _draw(c, seed=3, scale=0.1), _draw(c, seed=4, scale=0.1)
    pre_bias = _draw(c, seed=5, scale=0.5)
    want = group_norm_silu_plain(x + pre_bias.reshape(1, c, 1, 1), weight, bias, silu=silu)
    got = group_norm_silu_plain(x, weight, bias, silu=silu, pre_bias=pre_bias)
    assert _rel(got, want) <= 1e-6
    assert torch.equal(group_norm_silu(x, weight, bias, silu=silu, pre_bias=pre_bias), got)
    norm = GroupNorm32(c)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
        assert torch.equal(norm(x, silu=silu, pre_bias=pre_bias), got)
    assert torch.equal(group_norm_silu_plain(x, weight, bias, silu=silu, pre_bias=None),
                       group_norm_silu_plain(x, weight, bias, silu=silu))


@DTYPES
@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last],
                         ids=["nchw", "nhwc"])
def test_residual_plain_form_is_skip_plus_h_plus_vec(layout, dtype):
    """float32 sums in the order skip + h + vec, one rounding to the dtype; in
    float32 that is the plain expression bit for bit. The wrapper on the CPU runs
    it and counts no launch; the output keeps the operands' layout."""
    skip, h = (_draw(2, 16, 4, 4, seed=s).to(dtype).contiguous(memory_format=layout)
               for s in (1, 2))
    vec = _draw(16, seed=3)
    want = (skip.float() + h.float() + vec.reshape(1, -1, 1, 1)).to(dtype)
    got = residual_add_plain(skip, h, vec)
    assert torch.equal(got, want) and got.dtype == dtype
    if dtype == torch.float32:
        assert torch.equal(got, skip + h + vec.reshape(1, -1, 1, 1))
    before = residual_add.launches
    out = residual_add(skip, h, vec)
    assert torch.equal(out, want) and residual_add.launches == before
    assert out.is_contiguous(memory_format=layout)


def test_residual_layout_reads_one_layout_in_vectors_of_eight():
    """Vectors of eight in either layout; contiguous NCHW element by element where
    the vectors do not fit; nothing for two layouts, two dtypes or float16."""
    cl = torch.channels_last
    x = torch.empty(2, 16, 4, 4)
    assert residual_layout(x, x.clone()) == NCHW
    assert residual_layout(x.to(memory_format=cl), x.to(memory_format=cl)) == NHWC
    assert residual_layout(x, x.to(memory_format=cl)) is None  # two layouts
    assert residual_layout(x, x.to(torch.bfloat16)) is None  # two dtypes
    assert residual_layout(x.half(), x.half()) is None
    ragged = torch.empty(2, 16, 3, 5)
    assert residual_layout(ragged, ragged) == ELEMENTS  # H W = 15
    assert residual_layout(ragged.to(memory_format=cl), ragged.to(memory_format=cl)) == NHWC
    odd = torch.empty(2, 12, 4, 4).to(memory_format=cl)
    assert residual_layout(odd, odd) is None  # C = 12, channels-last
    assert residual_layout(odd.contiguous(), odd.contiguous()) == NCHW
    shifted = torch.empty(x.numel() + 1)[1:].view(x.shape)
    assert residual_layout(x, shifted) == ELEMENTS  # 4 bytes past 16
    with pytest.raises(ValueError):
        residual_add(x, x, torch.zeros(8))


def test_nin_shortcut_carries_a_pending_bias_through_exactly():
    """nin(x + b) = nin(x) + W b for the 1x1 conv, float32 within 1e-6 of max."""
    nin = Conv2d(16, 8, 1)
    with torch.no_grad():
        nin.weight.copy_(_draw(8, 16, 1, 1, seed=1, scale=0.25))
        nin.bias.copy_(_draw(8, seed=2))
    x, b = _draw(2, 16, 5, 5, seed=3), _draw(16, seed=4)
    with torch.no_grad():
        want = nin(x + b.reshape(1, -1, 1, 1))
        got = nin(x, bias=False) + (nin.bias + nin.bias_through(b)).reshape(1, -1, 1, 1)
    assert _rel(got, want) <= 1e-6


def _random_vqgan(cfg, seed):
    """Every parameter drawn, conv biases and norm shifts included: matrices
    N(0, 1/fan_in), vectors N(0, 0.1) (norm scales 1 + that)."""
    m = make_vqgan(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=g)
            else:
                p.normal_(0.0, 0.1, generator=g)
                if "norm" in name and name.endswith("weight"):
                    p.add_(1.0)
    return m.eval().requires_grad_(False)


def _the_card_route(monkeypatch):
    """takes_kernel as on the card, the device left out: no graph to record."""
    monkeypatch.setattr(GroupNorm32, "takes_kernel",
                        lambda self, x: not autograd_records(x, self.weight, self.bias))


@pytest.mark.parametrize("cfg", [TINY, TINY32], ids=["groups_per_channel", "groups32"])
def test_decoder_with_biases_handed_on_matches_library_biases(cfg, monkeypatch):
    """A decoder with a 1x1 shortcut, an upsample and an attention block: the
    biases handed on to the norms and the residual adds against every conv adding
    its own, float32 within 1e-5 of max |library|."""
    m = _random_vqgan(cfg, seed=7)
    z = _draw(2, 4, 4, cfg["embed_dim"], seed=8)
    assert any(hasattr(b, "nin_shortcut") for b in m.modules() if isinstance(b, ResnetBlock))
    with torch.no_grad():
        want = m.decode_latent(z)
        _the_card_route(monkeypatch)
        assert m.decoder.hands_biases_on(z.permute(0, 3, 1, 2))
        folded = Decoder.folded
        got = m.decode_latent(z)
        assert Decoder.folded - folded == m.decoder.foldable > 0
    assert _rel(got, want) <= 1e-5


def test_resnet_block_takes_a_pending_bias_only_where_it_folds():
    block = ResnetBlock(16, 8)
    with pytest.raises(ValueError):
        block(torch.zeros(1, 16, 4, 4), torch.zeros(16), False)


def _bias_calls(module):
    """Hooks on `module`'s convs and Upsamples recording, call by call, whether
    each ran with its bias -> (that list, the hooks' handles)."""
    calls, hooks = [], []
    for m in module.modules():
        if isinstance(m, (Conv2d, Upsample)):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args, kwargs: calls.append(kwargs.get("bias", True)),
                with_kwargs=True))
    return calls, hooks


@pytest.mark.parametrize("route", ["kernel", "autograd_records"])
def test_bias_counter_on_the_256px_decoder(route, monkeypatch):
    """The f16-16384 decoder (a 1 x 1 latent: the count reads no pixel): 41 conv
    biases handed on and 17 left to the library on the kernel route (the 16
    attention 1x1 convs and conv_out; post_quant_conv, outside the decoder, keeps
    its own); 0 and 58 where autograd records a graph through the decode. The
    counts are what the convs were called with."""
    m = make_vqgan(VQGAN_CONFIGS["vqgan_imagenet_f16_16384"]).eval().requires_grad_(False)
    _the_card_route(monkeypatch)
    z = torch.zeros(1, 1, 1, 256, requires_grad=route == "autograd_records")
    calls, hooks = _bias_calls(m.decoder)
    counts = Decoder.folded, Decoder.library
    with torch.set_grad_enabled(route == "autograd_records"):
        m.decode_latent(z)
    for hook in hooks:
        hook.remove()
    got = Decoder.folded - counts[0], Decoder.library - counts[1]
    assert got == ((41, 17) if route == "kernel" else (0, 58))
    assert got == (calls.count(False), calls.count(True))


def test_kernel_route_hands_the_biases_to_the_norms_and_the_adds(monkeypatch):
    """Where the block folds, the wrappers see the pending bias as norm1's
    pre-bias, conv1's as norm2's, and conv2's plus the skip path's as the
    residual vector (the 1x1 shortcut's bias plus W b)."""
    block = ResnetBlock(16, 8)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(_draw(*p.shape, seed=p.numel(), scale=0.2))
    seen = {}

    def norm(x, weight, bias, *, silu=False, pre_bias=None):
        seen.setdefault("pre_bias", []).append(pre_bias)
        return group_norm_silu_plain(x, weight, bias, silu=silu, pre_bias=pre_bias)

    def add(skip, h, vec):
        seen["vec"] = vec
        return residual_add_plain(skip, h, vec)

    monkeypatch.setattr(vqgan, "group_norm_silu", norm)
    monkeypatch.setattr(vqgan, "residual_add", add)
    monkeypatch.setattr(GroupNorm32, "takes_kernel", lambda self, x: True)
    pending = _draw(16, seed=9)
    calls, _ = _bias_calls(block)
    with torch.no_grad():
        block(_draw(1, 16, 4, 4, seed=10), pending, True)
        nin = block.nin_shortcut
        want = block.conv2.bias + (nin.bias + nin.weight.flatten(1) @ pending)
    assert seen["pre_bias"][0] is pending and seen["pre_bias"][1] is block.conv1.bias
    assert torch.equal(seen["vec"], want)
    assert calls == [False, False, False]  # conv1, conv2, the shortcut


@pytest.mark.parametrize("c,side,layout,want", [
    (16, 3, torch.channels_last, NHWC), (12, 3, torch.channels_last, ELEMENTS),
    (16, 4, torch.contiguous_format, NCHW), (16, 3, torch.contiguous_format, ELEMENTS)],
    ids=["nhwc", "nhwc_c12", "nchw", "nchw_ragged"])
def test_the_block_hands_the_add_a_layout_the_kernel_reads(c, side, layout, want, monkeypatch):
    """On the kernel route the residual add gets operands `residual_layout` reads:
    as they lie where it reads them, else made contiguous (as GroupNorm32 does),
    and the block's output is the plain form's."""
    block = ResnetBlock(c, c)
    seen = []

    def add(skip, h, vec):
        seen.append(residual_layout(skip, h))
        return residual_add_plain(skip, h, vec)

    monkeypatch.setattr(vqgan, "residual_add", add)
    _the_card_route(monkeypatch)
    x = _draw(2, c, side, side, seed=11).contiguous(memory_format=layout)
    with torch.no_grad():
        got = block(x, None, True)
        ref = block(x)
    assert seen == [want]
    assert _rel(got, ref) <= 1e-5

"""VQGAN decoder (taming-transformers architecture).

Port of feed_forward_vqgan_clip_tpu/models/vqgan.py. Module attributes carry
taming's state-dict names (io/torch_import.convert_vqgan documents them):
`quantize.embedding.weight`, `post_quant_conv`, `decoder.conv_in`,
`decoder.mid.{block_1,attn_1,block_2}`, `decoder.up.{level}.{block,attn}.{i}`,
`decoder.up.{level}.upsample.conv`, `decoder.norm_out`, `decoder.conv_out`.
Parameters are float32; `dtype` is the compute dtype. The decoder's tensors
are (B, C, H, W) inside; its public layouts are the JAX package's NHWC. On the
card they lie channels-last: cuDNN keeps the layout of the permuted NHWC
latent through every conv, and the GroupNorm kernel keeps its input's.

The JAX decoder has no Pallas kernel. Everything here is plain PyTorch
(F.conv2d, matmul + softmax attention) but the GroupNorm with its SiLU, which
takes the kernel pair of csrc/group_norm.cu on the card where autograd records
nothing (`GroupNorm32`), and, on that route, the ResnetBlocks' residual add
(csrc/residual.cu). On that route the decoder also hands its conv biases on:
a conv whose output a ResnetBlock reads next (`conv_in`, each Upsample, the
block's own convs and 1x1 shortcut) runs without its bias, and the
hand-written pass that reads the output next adds it in float32 (the norm as
its pre-bias, the residual add in its vector), so the library's separate bias
pass over the output never runs (`Decoder.hands_biases_on`). Upsample runs the
JAX package's default form, the transposed conv (its mode 2); the reference
graph (NN-2x then a 3x3 conv, mode 0) is what the tests hold it to. The JAX
package's phase-decomposed upsample (mode 1) is a TPU relayout form and is not
here.
`load_vqgan` builds the config's VQGAN and loads a taming checkpoint with
`load_state_dict`, or draws random weights from a seed.
"""

import logging
import os

import torch
import torch.nn.functional as F
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.config import TrainConfig, vqgan_arch_config
from feed_forward_vqgan_clip_tpu_torch.tracing import span
from feed_forward_vqgan_clip_tpu_torch.io import msgpack
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import (
    migrate_groupnorm_layout,
    numpy_leaves,
    vqgan_state_dict,
)
from feed_forward_vqgan_clip_tpu_torch.ops.grad_ops import clamp_with_grad
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.group_norm import (
    autograd_records,
    group_norm_silu,
    group_norm_silu_plain,
    kernel_layout,
)
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.residual import residual_add, residual_layout
from feed_forward_vqgan_clip_tpu_torch.ops.quantize import vector_quantize

log = logging.getLogger(__name__)

# NN-2x + 3x3 conv over tap space: row a of the 4-tap kernel sums these 3x3 rows
_UPSAMPLE_FOLD = ((1.0, 0.0, 0.0), (1.0, 1.0, 0.0), (0.0, 1.0, 1.0), (0.0, 0.0, 1.0))


class GroupNorm32(nn.Module):
    """GroupNorm(32 groups, eps=1e-6) with f32 statistics over NCHW input; per-channel
    groups when C is not a multiple of 32 (tiny test configs). The normalization is
    folded into one per-channel multiply-add applied in the compute dtype; `silu`
    applies the SiLU that follows it in the decoder.

    Two routes, on what the call can observe: a CPU tensor, or a call through which
    autograd records a graph (the train step, whose decoder input carries the
    mapper's gradient), takes the plain form `group_norm_silu_plain`; any other
    CUDA tensor (rendering, serving, the bench under no_grad) takes the kernel
    pair of csrc/group_norm.cu, which has no backward, in the layout it reads
    (`kernel_layout`; any other is made contiguous first). The kernel computes in
    x's dtype, so on that route x must come in the compute dtype, as every
    decoder layer hands it on; the plain form takes any float x. `pre_bias` (C,)
    float32, on either route: the norm of x + pre_bias."""

    def __init__(self, channels, *, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def takes_kernel(self, x):
        return x.device.type == "cuda" and not autograd_records(x, self.weight, self.bias)

    def forward(self, x, silu=False, pre_bias=None):
        if self.takes_kernel(x):
            if x.dtype != self.dtype:
                raise TypeError(f"GroupNorm32 on the card takes {self.dtype} input, got "
                                f"{x.dtype}")
            if kernel_layout(x) is None:
                x = x.contiguous()
            return group_norm_silu(x, self.weight, self.bias, silu=silu, pre_bias=pre_bias)
        return group_norm_silu_plain(x, self.weight, self.bias, silu=silu, dtype=self.dtype,
                                     pre_bias=pre_bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in the compute dtype with float32 parameters.
    `bias=False` leaves the bias out, for a later pass to add."""

    def __init__(self, cin, cout, kernel, *, dtype=torch.float32, device=None):
        super().__init__(cin, cout, kernel, padding=kernel // 2, device=device)
        self.dtype = dtype

    def forward(self, x, bias=True):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype) if bias else None, padding=self.padding)

    def bias_through(self, b):
        """What a per-channel bias b (cin,), pending on a 1x1 conv's input, adds to
        its output: conv(x + b) = conv(x) + W b, in float32."""
        return self.weight.flatten(1) @ b


class ResnetBlock(nn.Module):
    def __init__(self, in_ch, out_ch, dropout=0.0, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = GroupNorm32(in_ch, **kw)
        self.conv1 = Conv2d(in_ch, out_ch, 3, **kw)
        self.norm2 = GroupNorm32(out_ch, **kw)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = Conv2d(out_ch, out_ch, 3, **kw)
        if in_ch != out_ch:
            self.nin_shortcut = Conv2d(in_ch, out_ch, 1, **kw)

    def forward(self, x, pre_bias=None, fold=False):
        """x + the block of x. `fold` (the kernel route, `Decoder.hands_biases_on`):
        the convs run without their biases, norm2 takes conv1's as its pre-bias,
        and the residual add takes conv2's and the skip path's; `pre_bias` (C,)
        float32 is a bias still pending on x (its conv's), taken the same way."""
        if pre_bias is not None and not fold:
            raise ValueError("a pending bias is handed on only where the block folds")
        nin = getattr(self, "nin_shortcut", None)
        with span("decode.norm"):
            h = self.norm1(x, silu=True, pre_bias=pre_bias)
        with span("decode.conv"):
            h = self.conv1(h, bias=not fold)
        with span("decode.norm"):
            h = self.dropout(self.norm2(h, silu=True, pre_bias=self.conv1.bias if fold else None))
        with span("decode.conv"):
            h = self.conv2(h, bias=not fold)
            if nin is not None:
                x = nin(x, bias=not fold)
        if not fold:
            return x + h
        skip_bias = pre_bias
        if nin is not None:
            skip_bias = nin.bias if pre_bias is None else nin.bias + nin.bias_through(pre_bias)
        vec = self.conv2.bias if skip_bias is None else self.conv2.bias + skip_bias
        if residual_layout(x, h) is None:  # a layout the kernel does not read
            x, h = x.contiguous(), h.contiguous()
        return residual_add(x, h, vec)


class AttnBlock(nn.Module):
    """Single-head self-attention over the HxW grid: matmul, f32 softmax, matmul."""

    def __init__(self, channels, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.norm = GroupNorm32(channels, **kw)
        self.q = Conv2d(channels, channels, 1, **kw)
        self.k = Conv2d(channels, channels, 1, **kw)
        self.v = Conv2d(channels, channels, 1, **kw)
        self.proj_out = Conv2d(channels, channels, 1, **kw)

    def forward(self, x):
        with span("decode.attn"):  # its norm and 1x1 convs inside, whole
            b, c, h, w = x.shape
            hn = self.norm(x)
            q = self.q(hn).reshape(b, c, h * w).transpose(1, 2)  # (b, hw, c)
            k = self.k(hn).reshape(b, c, h * w)                  # (b, c, hw)
            v = self.v(hn).reshape(b, c, h * w).transpose(1, 2)
            attn = torch.bmm(q, k) * (c ** -0.5)
            attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
            out = torch.bmm(attn, v).transpose(1, 2).reshape(b, c, h, w)
            return x + self.proj_out(out)


class Upsample(nn.Module):
    """Nearest-neighbour 2x upsample then a 3x3 conv (taming's Upsample), as a
    transposed conv (JAX `Upsample`, mode 2): the duplicated pixels let each
    output phase read 2 distinct input pixels a dimension, so the taps are
    folded in float32, before the cast, into a 4x4 kernel K4 = F K F^T over tap
    space (F = _UPSAMPLE_FOLD), and one F.conv_transpose2d (stride 2, padding 1)
    takes K4 flipped with its channel axes swapped: 16 multiply-adds an output
    pixel per channel pair where NN-2x + 3x3 conv does 36. Its input gradient is
    autograd's stride-2 conv, the adjoint JAX's `_dilated_up_bwd` writes by
    hand. The parameters are taming's (`conv.weight`, `conv.bias`); in bf16 the
    pre-summed taps round once where the reference graph rounds each."""

    def __init__(self, channels, *, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv2d(channels, channels, 3, dtype=dtype, device=device)
        self.register_buffer("fold", torch.tensor(_UPSAMPLE_FOLD, device=device),
                             persistent=False)

    def forward(self, x, bias=True):
        """`bias=False`: without `conv.bias`, which a later pass adds."""
        with span("decode.conv"):  # the weight fold included
            k4 = self.fold @ self.conv.weight.float() @ self.fold.t()  # (O, I, 4, 4)
            # conv_transpose2d's weight is (I, O, kh, kw) and slides flipped
            wt = k4.flip(2, 3).transpose(0, 1).to(self.dtype)
            return F.conv_transpose2d(x.to(self.dtype), wt,
                                      self.conv.bias.to(self.dtype) if bias else None,
                                      stride=2, padding=1)


class _UpLevel(nn.Module):
    """One decoder resolution level: `block`, `attn` and optional `upsample`."""

    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class Decoder(nn.Module):
    """taming's Decoder: z (B, z_channels, S, S) -> image (B, out_ch, 16S, 16S), NCHW.

    `Decoder.folded` and `Decoder.library` count, over every decode, the convs
    whose bias was handed on to a hand-written pass and those whose bias the
    library's conv added (`hands_biases_on`)."""

    folded = 0
    library = 0

    def __init__(self, ch=128, out_ch=3, ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2,
                 attn_resolutions=(16,), resolution=256, z_channels=256, dropout=0.0,
                 *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        num_levels = len(ch_mult)
        block_in = ch * ch_mult[-1]
        # attention placement derives from the config (taming), not from the latent
        # size: with vq_image_size=32 the trained attention blocks still run
        curr_res = resolution // 2 ** (num_levels - 1)
        self.conv_in = Conv2d(z_channels, block_in, 3, **kw)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, dropout, **kw)
        self.mid.attn_1 = AttnBlock(block_in, **kw)
        self.mid.block_2 = ResnetBlock(block_in, block_in, dropout, **kw)
        levels = {}
        for i_level in reversed(range(num_levels)):
            up = _UpLevel()
            block_out = ch * ch_mult[i_level]
            for _ in range(num_res_blocks + 1):
                up.block.append(ResnetBlock(block_in, block_out, dropout, **kw))
                block_in = block_out
                if curr_res in attn_resolutions:
                    up.attn.append(AttnBlock(block_in, **kw))
            if i_level != 0:
                up.upsample = Upsample(block_in, **kw)
                curr_res *= 2
            levels[i_level] = up
        self.up = nn.ModuleList([levels[i] for i in range(num_levels)])
        self.norm_out = GroupNorm32(block_in, **kw)
        self.conv_out = Conv2d(block_in, out_ch, 3, **kw)
        # the convs a decode runs, and those whose bias it can hand on: conv_in's, each
        # Upsample's, and each ResnetBlock's two and its 1x1 shortcut's
        self.convs = sum(isinstance(m, nn.Conv2d) for m in self.modules())
        blocks = [m for m in self.modules() if isinstance(m, ResnetBlock)]
        upsamples = [m for m in self.modules() if isinstance(m, Upsample)]
        self.foldable = 1 + len(upsamples) + sum(2 + hasattr(b, "nin_shortcut") for b in blocks)

    def hands_biases_on(self, z):
        """Whether a decode of z hands its conv biases on to the hand-written passes:
        where its norms take the kernel route (a CUDA tensor, no graph for autograd
        to record), read from what the call can observe. Then `conv_in`, each
        Upsample and every ResnetBlock conv run without their biases
        (`self.foldable`: in the f16-16384 decoder 41 of its 58 convs); else all
        keep them."""
        return self.norm_out.takes_kernel(z)

    def forward(self, z):
        fold = self.hands_biases_on(z)
        folded = self.foldable if fold else 0
        Decoder.folded += folded
        Decoder.library += self.convs - folded
        with span("decode.conv"):
            h = self.conv_in(z, bias=not fold)
        h = self.mid.block_1(h, self.conv_in.bias if fold else None, fold)
        h = self.mid.block_2(self.mid.attn_1(h), fold=fold)
        pending = None  # an Upsample's bias, for the block that reads its output
        for i_level in reversed(range(len(self.up))):
            up = self.up[i_level]
            for i_block, block in enumerate(up.block):
                h = block(h, pending, fold)
                pending = None
                if len(up.attn) > 0:
                    h = up.attn[i_block](h)
            if hasattr(up, "upsample"):
                h = up.upsample(h, bias=not fold)
                pending = up.upsample.conv.bias if fold else None
        with span("decode.norm"):
            h = self.norm_out(h, silu=True)
        with span("decode.conv"):
            return self.conv_out(h)


class _Quantize(nn.Module):
    """`quantize.embedding`: the codebook table."""

    def __init__(self, n_embed, embed_dim, device=None):
        super().__init__()
        self.embedding = nn.Embedding(n_embed, embed_dim, device=device)


class VQGAN(nn.Module):
    """Codebook + post_quant_conv + decoder: the decode path the reference uses."""

    def __init__(self, n_embed=16384, embed_dim=256, ch=128, out_ch=3,
                 ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2, attn_resolutions=(16,),
                 resolution=256, z_channels=256, dropout=0.0, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.n_embed = n_embed
        self.quantize = _Quantize(n_embed, embed_dim, device=device)
        self.post_quant_conv = Conv2d(embed_dim, z_channels, 1, dtype=dtype, device=device)
        self.decoder = Decoder(ch, out_ch, tuple(ch_mult), num_res_blocks,
                               tuple(attn_resolutions), resolution, z_channels, dropout,
                               dtype=dtype, device=device)

    def codebook(self):
        return self.quantize.embedding.weight

    def decode_latent(self, z_q):
        """z_q (B, S, S, embed_dim) NHWC -> image (B, 16S, 16S, out_ch) NHWC in (-1, 1)."""
        with span("decode.conv"):
            h = self.post_quant_conv(z_q.permute(0, 3, 1, 2))
        return self.decoder(h).permute(0, 2, 3, 1)

    forward = decode_latent

    @torch.no_grad()
    def init_random_(self, generator):
        """The JAX module's init from a torch.Generator: codebook uniform in
        [0, 2/n_embed), lecun-normal convs, zero biases, unit norms."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
                m.bias.zero_()
            elif isinstance(m, GroupNorm32):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.codebook().uniform_(0.0, 2.0 / self.n_embed, generator=generator)
        return self


def make_vqgan(config: dict, dtype=torch.float32, device=None) -> VQGAN:
    """Build a VQGAN from a `ddconfig`-style dict (registry.VQGAN_CONFIGS preset)."""
    return VQGAN(
        n_embed=int(config["n_embed"]),
        embed_dim=int(config["embed_dim"]),
        ch=int(config.get("ch", 128)),
        out_ch=int(config.get("out_ch", 3)),
        ch_mult=tuple(config.get("ch_mult", (1, 1, 2, 2, 4))),
        num_res_blocks=int(config.get("num_res_blocks", 2)),
        attn_resolutions=tuple(config.get("attn_resolutions", (16,))),
        resolution=int(config.get("resolution", 256)),
        z_channels=int(config.get("z_channels", 256)),
        dropout=float(config.get("dropout", 0.0)),
        dtype=dtype,
        device=device,
    )


def synth(vqgan: VQGAN, z):
    """z (B, S, S, C) latent -> image (B, 16S, 16S, 3) in [0, 1].

    The reference's synth: vector_quantize (straight-through) -> decode ->
    (x + 1) / 2 -> clamp_with_grad. The JAX package's fold_pqc=False graph.
    Spans: `decode` over it all, `vq` over the search and gather, and in the
    decoder `decode.norm` (a GroupNorm with its SiLU), `decode.conv` (a
    convolution, Upsample's weight fold included) and `decode.attn` (an
    AttnBlock whole), disjoint; residual adds, the scaling and the clamp lie
    outside all four. Called under no other span, `decode` times them all on
    the device; else its root decides."""
    with span("decode", device=True):
        with span("vq"):
            z_q = vector_quantize(z, vqgan.codebook())
        x = vqgan.decode_latent(z_q)
        return clamp_with_grad((x + 1.0) / 2.0, 0.0, 1.0)


def latent_bounds(vqgan: VQGAN):
    """Scalar codebook min and max, the latent clamp bounds (0-d tensors)."""
    cb = vqgan.codebook()
    return cb.min(), cb.max()


def load_vqgan(cfg: TrainConfig, dtype=torch.bfloat16, *, device="cuda", seed: int = 0) -> VQGAN:
    """The config's VQGAN (`vqgan_arch_config`), frozen, in eval mode: the
    weights of the taming checkpoint at `vqgan_checkpoint` (a `.ckpt` or state
    dict; Lightning's {"state_dict": ...} wrapper, a Net2NetTransformer's
    `first_stage_model.` prefix and GumbelVQ's `quantize.embed` name are taken
    as the JAX package takes them) or of the JAX package's directory there
    (`params.msgpack`'s "params", the older nested GroupNorm layout
    flattened), else random from `seed`. Port of JAX train/loop.py
    `load_vqgan`."""
    vq = make_vqgan(vqgan_arch_config(cfg), dtype=dtype, device=device)
    path = cfg.get("vqgan_checkpoint")
    keys = set(vq.state_dict())  # the decode path: no encoder, no loss
    if path and os.path.isdir(path):
        tree = msgpack.load(os.path.join(path, "params.msgpack"))["params"]
        sd = vqgan_state_dict(migrate_groupnorm_layout(numpy_leaves(tree)))
        vq.load_state_dict({k: v for k, v in sd.items() if k in keys})
    elif path:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
            obj = obj["state_dict"]
        if any(k.startswith("first_stage_model.") for k in obj):
            obj = {k[len("first_stage_model."):]: v for k, v in obj.items()
                   if k.startswith("first_stage_model.")}
        if "quantize.embed.weight" in obj and "quantize.embedding.weight" not in obj:
            obj = {**obj, "quantize.embedding.weight": obj["quantize.embed.weight"]}
        vq.load_state_dict({k: v.float() for k, v in obj.items() if k in keys})
    else:
        log.warning("No VQGAN weights — random init (smoke/bench only).")
        vq.init_random_(torch.Generator(device=vq.codebook().device).manual_seed(seed))
    return vq.eval().requires_grad_(False)

"""VQGAN decoder (taming-transformers architecture).

Port of feed_forward_vqgan_clip_tpu/models/vqgan.py. Module attributes carry
taming's state-dict names (io/torch_import.convert_vqgan documents them):
`quantize.embedding.weight`, `post_quant_conv`, `decoder.conv_in`,
`decoder.mid.{block_1,attn_1,block_2}`, `decoder.up.{level}.{block,attn}.{i}`,
`decoder.up.{level}.upsample.conv`, `decoder.norm_out`, `decoder.conv_out`.
Parameters are float32; `dtype` is the compute dtype. The decoder runs NCHW
inside; its public layouts are the JAX package's NHWC.

The JAX decoder has no Pallas kernel, so everything here is plain PyTorch
(F.conv2d, matmul + softmax attention). Upsample is the reference graph (NN-2x
then a 3x3 conv, the JAX package's mode 0); mode 2 is an XLA rewrite (ROADMAP
A17). `load_vqgan` builds the config's VQGAN and loads a taming checkpoint with
`load_state_dict`, or draws random weights from a seed.
"""

import logging
import os

import torch
import torch.nn.functional as F
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.config import TrainConfig, vqgan_arch_config
from feed_forward_vqgan_clip_tpu_torch.io import msgpack
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import (
    migrate_groupnorm_layout,
    numpy_leaves,
    vqgan_state_dict,
)
from feed_forward_vqgan_clip_tpu_torch.ops.grad_ops import clamp_with_grad
from feed_forward_vqgan_clip_tpu_torch.ops.quantize import vector_quantize

log = logging.getLogger(__name__)


class GroupNorm32(nn.Module):
    """GroupNorm(32 groups, eps=1e-6) with f32 statistics over NCHW input; per-channel
    groups when C is not a multiple of 32 (tiny test configs). The normalization is
    folded into one per-channel multiply-add applied in the compute dtype."""

    def __init__(self, channels, *, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        b, c, h, w = x.shape
        groups = 32 if c % 32 == 0 else c
        xg = x.reshape(b, groups, c // groups, h * w)
        xf = xg.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = (xf.square().mean(dim=(2, 3), keepdim=True) - mean.square()).clamp_min(0.0)
        inv = torch.rsqrt(var + 1e-6)
        sc = self.weight.reshape(groups, c // groups, 1)
        bi = self.bias.reshape(groups, c // groups, 1)
        a = (inv * sc).to(self.dtype)
        shift = (bi - mean * inv * sc).to(self.dtype)
        return (xg.to(self.dtype) * a + shift).reshape(b, c, h, w)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in the compute dtype with float32 parameters."""

    def __init__(self, cin, cout, kernel, *, dtype=torch.float32, device=None):
        super().__init__(cin, cout, kernel, padding=kernel // 2, device=device)
        self.dtype = dtype

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype), padding=self.padding)


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

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(self.dropout(F.silu(self.norm2(h))))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


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
    """Nearest-neighbour 2x upsample then a 3x3 conv (taming's Upsample)."""

    def __init__(self, channels, *, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, dtype=dtype, device=device)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _UpLevel(nn.Module):
    """One decoder resolution level: `block`, `attn` and optional `upsample`."""

    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class Decoder(nn.Module):
    """taming's Decoder: z (B, z_channels, S, S) -> image (B, out_ch, 16S, 16S), NCHW."""

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

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i_level in reversed(range(len(self.up))):
            up = self.up[i_level]
            for i_block, block in enumerate(up.block):
                h = block(h)
                if len(up.attn) > 0:
                    h = up.attn[i_block](h)
            if hasattr(up, "upsample"):
                h = up.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


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
    (x + 1) / 2 -> clamp_with_grad. The JAX package's fold_pqc=False graph."""
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

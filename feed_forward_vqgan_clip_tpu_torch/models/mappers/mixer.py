"""MLP-Mixer mapper: CLIP embedding (+noise) -> VQGAN latent grid.

Port of feed_forward_vqgan_clip_tpu/models/mappers/mixer.py. Attribute names are
the reference's mlp_mixer_pytorch state-dict keys (io/torch_import.convert_mixer
documents them): `proj`; `mixer.0` the token rearrange (no parameters);
`mixer.1` Linear(C -> dim); `mixer.{2+i}` a block of two pre-norm residuals,
`.0` token mixing through size-1 Conv1d layers `.0.fn.0` / `.0.fn.3` and `.1`
channel mixing through Linear layers `.1.fn.0` / `.1.fn.3`; `mixer.{2+depth}`
the final LayerNorm; `final_proj`. Parameters are float32; `dtype` is the
compute dtype each forward casts to, as in the JAX modules.

The forward here is the module path: on the card the mapper's blocks go through
the kernel instead (models/mappers/fused.py).
"""

import contextlib
import contextvars
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import MixerBlockWeights


def lean_layer_norm(x, weight, bias, dtype):
    """LayerNorm(eps=1e-5) with f32 statistics and compute-dtype activations:
    the per-row scale and shift are folded in f32, then applied once in `dtype`."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + 1e-5)
    a = (inv * weight).to(dtype)
    b = (bias - mean * inv * weight).to(dtype)
    return x.to(dtype) * a + b


class LeanLayerNorm(nn.Module):
    """LayerNorm(eps=1e-5) over the last axis, f32 statistics (lean_layer_norm)."""

    def __init__(self, dim, *, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return lean_layer_norm(x, self.weight, self.bias, self.dtype)


class _GlobalRows(NamedTuple):
    index: torch.Tensor  # this rank's rows of the global batch
    total: int  # the global batch's rows


_GLOBAL_ROWS: contextvars.ContextVar = contextvars.ContextVar("ffvc_dropout_rows",
                                                              default=None)


@contextlib.contextmanager
def global_rows(index: torch.Tensor, total: int):
    """While the block runs, every Dropout draws its mask at the global batch's
    `total` rows and keeps the rows `index`: a rank of a data-parallel step then
    draws what a single device draws for those rows of the global batch."""
    token = _GLOBAL_ROWS.set(_GlobalRows(index, int(total)))
    try:
        yield
    finally:
        _GLOBAL_ROWS.reset(token)


class Dropout(nn.Module):
    """flax's nn.Dropout with its mask drawn from the torch.Generator the forward
    is given: each element kept with probability 1 - p and scaled by 1 / (1 - p).
    With no generator (inference, and the kernel paths) it is the identity, as a
    flax forward with deterministic=True. No parameters, so the state-dict keys
    stay those of the reference's nn.Dropout.

    The mask is drawn at the shape of the whole tensor and cut down to the part
    this forward holds: the rows of `global_rows`, and with `shard=(axis, index,
    parts)` (a tensor-parallel hidden layer) part `index` along `axis`; so a
    sharded step draws the single device's masks."""

    def __init__(self, p=0.0):
        super().__init__()
        self.p = p

    def forward(self, x, generator=None, shard=None):
        if generator is None or self.p == 0:
            return x
        shape, rows = list(x.shape), _GLOBAL_ROWS.get()
        if rows is not None:
            shape[0] = rows.total
        if shard is not None:
            shape[shard[0]] *= shard[2]
        u = torch.rand(shape, generator=generator, device=x.device)
        if rows is not None:
            u = u[rows.index]
        if shard is not None:
            axis, index, _ = shard
            u = u.narrow(axis, index * x.shape[axis], x.shape[axis])
        keep = u < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))


class PreNormResidual(nn.Module):
    """Parameter container with the reference's `norm` / `fn` names; MixerBlock runs it."""

    def __init__(self, dim, fn, *, dtype, device):
        super().__init__()
        self.norm = LeanLayerNorm(dim, dtype=dtype, device=device)
        self.fn = fn


class MixerBlock(nn.Sequential):
    """Token mixing then channel mixing, each a pre-LN feed-forward with a residual.

    x (B, T, D): the token FF contracts the token axis (t1 (Et, T) then t2 (T, Et),
    biases per hidden token / per token, broadcast over D), the channel FF the
    feature axis (D -> Ec -> D). Exact GELU. Dropout after each GELU and each
    second matmul, where the forward is given a generator (the JAX module's
    deterministic=False)."""

    def __init__(self, tokens, dim, expansion=4, dropout=0.0, *, dtype=torch.float32,
                 device=None):
        et, ec = tokens * expansion, dim * expansion
        token_fn = nn.Sequential(
            nn.Conv1d(tokens, et, 1, device=device), nn.GELU(), Dropout(dropout),
            nn.Conv1d(et, tokens, 1, device=device), Dropout(dropout),
        )
        channel_fn = nn.Sequential(
            nn.Linear(dim, ec, device=device), nn.GELU(), Dropout(dropout),
            nn.Linear(ec, dim, device=device), Dropout(dropout),
        )
        super().__init__(
            PreNormResidual(dim, token_fn, dtype=dtype, device=device),
            PreNormResidual(dim, channel_fn, dtype=dtype, device=device),
        )
        self.dtype = dtype

    def forward(self, x, generator=None):
        dt = self.dtype
        tok, ch = self[0], self[1]
        t1, t2 = tok.fn[0], tok.fn[3]
        h = tok.norm(x)
        # h[b, e, d] = sum_t t1[e, t] h[b, t, d]   (JAX: einsum 'btd,te->bed')
        h = torch.matmul(t1.weight[:, :, 0].to(dt), h) + t1.bias.to(dt)[:, None]
        h = tok.fn[2](F.gelu(h), generator)
        h = torch.matmul(t2.weight[:, :, 0].to(dt), h) + t2.bias.to(dt)[:, None]
        x = x + tok.fn[4](h, generator)

        c1, c2 = ch.fn[0], ch.fn[3]
        h = ch.norm(x)
        h = F.linear(h, c1.weight.to(dt), c1.bias.to(dt))
        h = ch.fn[2](F.gelu(h), generator)
        h = F.linear(h, c2.weight.to(dt), c2.bias.to(dt))
        return x + ch.fn[4](h, generator)

    def train_weights(self):
        """This block's float32 parameters in the kernels' layout as differentiable
        views, for ops/kernels/mixer_block.MixerBlockTrain (which casts the
        matrices to the compute dtype inside its forward, so grads reach these
        parameters in float32)."""
        tok, ch = self[0], self[1]
        return MixerBlockWeights(
            ln1_w=tok.norm.weight, ln1_b=tok.norm.bias,
            t1=tok.fn[0].weight[:, :, 0], t1b=tok.fn[0].bias,
            t2=tok.fn[3].weight[:, :, 0], t2b=tok.fn[3].bias,
            ln2_w=ch.norm.weight, ln2_b=ch.norm.bias,
            w1=ch.fn[0].weight, b1=ch.fn[0].bias,
            w2=ch.fn[3].weight, b2=ch.fn[3].bias,
        )

    def kernel_weights(self, dtype):
        """This block's parameters in the layout ops/kernels/mixer_block takes,
        detached: the inference path."""
        tok, ch = self[0], self[1]
        f32 = lambda p: p.detach().float().contiguous()  # noqa: E731
        mat = lambda p: p.detach().to(dtype).contiguous()  # noqa: E731
        return MixerBlockWeights(
            ln1_w=f32(tok.norm.weight), ln1_b=f32(tok.norm.bias),
            t1=mat(tok.fn[0].weight[:, :, 0]), t1b=f32(tok.fn[0].bias),
            t2=mat(tok.fn[3].weight[:, :, 0]), t2b=f32(tok.fn[3].bias),
            ln2_w=f32(ch.norm.weight), ln2_b=f32(ch.norm.bias),
            w1=mat(ch.fn[0].weight), b1=f32(ch.fn[0].bias),
            w2=mat(ch.fn[3].weight), b2=f32(ch.fn[3].bias),
        )


class ChannelMajorTokens(nn.Module):
    """`mixer.0`: the proj output viewed channel-major (B, C, S, S), rearranged to
    S*S tokens of C features (mlp_mixer_pytorch's view quirk, kept exactly so
    converted released checkpoints reproduce)."""

    def __init__(self, image_size, channels):
        super().__init__()
        self.image_size, self.channels = image_size, channels

    def forward(self, h):
        s, c = self.image_size, self.channels
        return h.reshape(h.shape[0], c, s, s).permute(0, 2, 3, 1).reshape(h.shape[0], s * s, c)


class Mixer(nn.Module):
    """x (B, input_dim) -> latent (B, S, S, C) NHWC."""

    def __init__(self, input_dim, image_size, channels, dim, depth, expansion=4,
                 dropout=0.0, *, dtype=torch.float32, device=None):
        super().__init__()
        self.input_dim, self.image_size, self.channels = input_dim, image_size, channels
        self.dim, self.depth, self.expansion = dim, depth, expansion
        self.dropout, self.dtype = dropout, dtype
        s = image_size
        self.proj = nn.Linear(input_dim, s * s * channels, device=device)
        self.mixer = nn.Sequential(
            ChannelMajorTokens(s, channels),
            nn.Linear(channels, dim, device=device),
            *[MixerBlock(s * s, dim, expansion, dropout, dtype=dtype, device=device)
              for _ in range(depth)],
            LeanLayerNorm(dim, dtype=dtype, device=device),
        )
        self.final_proj = nn.Linear(dim, channels, device=device)

    @property
    def blocks(self):
        return [self.mixer[2 + i] for i in range(self.depth)]

    def embed(self, x):
        """proj -> channel-major tokens -> Linear(C -> dim): (B, input_dim) -> (B, T, dim)."""
        dt = self.dtype
        h = F.linear(x.to(dt), self.proj.weight.to(dt), self.proj.bias.to(dt))
        h = self.mixer[0](h)
        emb = self.mixer[1]
        return F.linear(h, emb.weight.to(dt), emb.bias.to(dt))

    def head(self, h):
        """final LayerNorm -> Linear(dim -> C) -> (B, S, S, C)."""
        dt = self.dtype
        h = self.mixer[2 + self.depth](h)
        h = F.linear(h, self.final_proj.weight.to(dt), self.final_proj.bias.to(dt))
        s = self.image_size
        return h.reshape(h.shape[0], s, s, self.channels)

    def forward(self, x, generator=None):
        """`generator` draws the dropout masks (the JAX module's
        deterministic=False with a dropout rng); without it the forward is
        deterministic."""
        h = self.embed(x)
        for block in self.blocks:
            h = block(h, generator)
        return self.head(h)

    @torch.no_grad()
    def init_random_(self, generator):
        """The JAX module's init from a torch.Generator: lecun-normal matrices
        (std 1/sqrt(fan_in)), zero biases, unit norms."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                m.bias.zero_()
            elif isinstance(m, LeanLayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self

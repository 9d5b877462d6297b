"""VitGAN mapper family: self-modulated-LayerNorm transformer generators.

Port of feed_forward_vqgan_clip_tpu/models/mappers/vitgan.py, with the
reference's quirks kept for checkpoint parity:

  * SLN(hl, w) = gamma * w * LN(hl) + beta * w with SCALAR gamma and beta
    (shape (1, 1, 1)), the LN in float32;
  * the attention scale is dim**-0.5 (not head_dim**-0.5), and the packed qkv
    projection unpacks as '(d k h)', the head index fastest; the inner width is
    heads * (dim // heads), which need not be dim;
  * the blocks thread (x, hl): x is the SLN modulation input and passes through
    unchanged, hl accumulates the residuals;
  * Generator's head Linear(dim -> T*C) output (B, T, T*C) is viewed
    channel-major as (B, C, T, T), T = initialize_size * 8 tokens;
    SimpleGenerator's `inp` embedding is viewed dim-major as (B, dim, T).

Attribute names are the reference's state-dict keys (the JAX converter
io/torch_import.convert_vitgan_generator reads them): `pos_emb1D`, `mlp`,
`Transformer_Encoder.blocks.{i}.{norm1, norm2}.{gamma, beta, ln}`,
`...attn.to_qkv`, `...attn.w_out`, `...mlp.linear1`, `...mlp.linear2`,
`sln_norm`, `w_out.0`, and SimpleGenerator's `inp`. Parameters are float32;
`dtype` is the compute dtype. Outputs are NHWC latents (B, S, S, C). The
mappers have no kernel of their own: on every device they run as modules
(models/mappers/fused.fused_supported).

The auxiliary classes (SineLayer, the L2-attention Discriminator) are not on
the reference's train path; they are here because the JAX package has them.
"""

import torch
import torch.nn.functional as F
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import LayerNorm, Linear, init_blocks_
from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import Dropout


def _unpack_qkv(qkv, heads):
    """(b, t, 3*h*dh) packed '(d k h)' -> q, k, v (b, h, t, dh)."""
    b, t, _ = qkv.shape
    qkv = qkv.reshape(b, t, -1, 3, heads).permute(3, 0, 4, 1, 2)
    return qkv[0], qkv[1], qkv[2]


def _merge_heads(out):
    """(b, h, t, dh) -> (b, t, h*dh)."""
    b, h, t, dh = out.shape
    return out.transpose(1, 2).reshape(b, t, h * dh)


class SLN(nn.Module):
    """Self-modulated LayerNorm with scalar gamma and beta."""

    def __init__(self, dim, *, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.gamma = nn.Parameter(torch.ones(1, 1, 1, device=device))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, device=device))
        self.ln = LayerNorm(dim, dtype=dtype, device=device)

    def forward(self, hl, w):
        dt = self.dtype
        return self.gamma.to(dt) * w * self.ln(hl) + self.beta.to(dt) * w


class VitGANAttention(nn.Module):
    """Softmax attention over the packed '(d k h)' qkv, scale dim**-0.5, f32 softmax."""

    def __init__(self, dim, num_heads, *, dtype=torch.float32, device=None):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, num_heads, dtype
        inner = num_heads * (dim // num_heads)
        self.to_qkv = Linear(dim, 3 * inner, bias=False, dtype=dtype, device=device)
        self.w_out = Linear(inner, dim, dtype=dtype, device=device)

    def forward(self, x):
        q, k, v = _unpack_qkv(self.to_qkv(x), self.heads)
        attn = torch.matmul(q, k.transpose(-1, -2)) * (self.dim ** -0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
        return self.w_out(_merge_heads(torch.matmul(attn, v)))


class VitGANMLP(nn.Module):
    """linear1 -> exact GELU -> dropout -> linear2 -> dropout."""

    def __init__(self, dim, hidden, dropout=0.0, *, dtype=torch.float32, device=None):
        super().__init__()
        self.linear1 = Linear(dim, hidden, dtype=dtype, device=device)
        self.linear2 = Linear(hidden, dim, dtype=dtype, device=device)
        self.dropout = Dropout(dropout)

    def forward(self, x, generator=None):
        h = self.dropout(F.gelu(self.linear1(x)), generator)
        return self.dropout(self.linear2(h), generator)


class GEncoderBlock(nn.Module):
    def __init__(self, dim, num_heads, dropout=0.0, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = SLN(dim, **kw)
        self.attn = VitGANAttention(dim, num_heads, **kw)
        self.norm2 = SLN(dim, **kw)
        self.mlp = VitGANMLP(dim, dim * 4, dropout, **kw)
        self.dropout = Dropout(dropout)

    def forward(self, hl, x, generator=None):
        """-> (x, hl): x unchanged, hl plus the block's two residuals."""
        hl = self.dropout(self.attn(self.norm1(hl, x)), generator) + hl
        return x, self.mlp(self.norm2(hl, x), generator) + hl


class TransformerEncoder(nn.Module):
    """The reference's `Transformer_Encoder`: a ModuleList `blocks`."""

    def __init__(self, dim, blocks, num_heads, dropout=0.0, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            GEncoderBlock(dim, num_heads, dropout, dtype=dtype, device=device)
            for _ in range(blocks))

    def forward(self, hl, x, generator=None):
        for block in self.blocks:
            x, hl = block(hl, x, generator)
        return x, hl


class _GeneratorBase(nn.Module):
    """What Generator and SimpleGenerator share: `mlp` (the SLN input x), the
    position table, the encoder, `sln_norm` and the `w_out.0` head."""

    def __init__(self, tokens, input_dim, dim, blocks, num_heads, dropout, head_out, *,
                 dtype, device):
        super().__init__()
        self.tokens, self.input_dim, self.dim, self.dtype = tokens, input_dim, dim, dtype
        kw = dict(dtype=dtype, device=device)
        self.pos_emb1D = nn.Parameter(torch.zeros(tokens, dim, device=device))
        self.mlp = Linear(input_dim, tokens * dim, **kw)
        self.Transformer_Encoder = TransformerEncoder(dim, blocks, num_heads, dropout, **kw)
        self.sln_norm = SLN(dim, **kw)
        self.w_out = nn.Sequential(Linear(dim, head_out, **kw))

    def _head(self, z, hl, generator):
        """The blocks and the head over modulation input mlp(z): -> (B, T, head_out)."""
        x = self.mlp(z).reshape(z.shape[0], self.tokens, self.dim)
        x, hl = self.Transformer_Encoder(hl, x, generator)
        return self.w_out(self.sln_norm(hl, x))

    @torch.no_grad()
    def init_random_(self, generator):
        """The JAX module's init from a torch.Generator: lecun-normal matrices
        (std 1/sqrt(fan_in)), zero biases, unit LN scales; positions and the SLN
        scalars N(0, 1)."""
        init_blocks_(self, generator=generator)
        self.pos_emb1D.normal_(0.0, 1.0, generator=generator)
        for m in self.modules():
            if isinstance(m, SLN):
                m.gamma.normal_(0.0, 1.0, generator=generator)
                m.beta.normal_(0.0, 1.0, generator=generator)
        return self


class Generator(_GeneratorBase):
    """VitGAN Generator: z (B, input_dim) -> latent (B, T, T, C) NHWC with
    T = initialize_size * 8 tokens."""

    def __init__(self, initialize_size, input_dim, dim=384, blocks=6, num_heads=6, dropout=0.0,
                 out_channels=256, *, dtype=torch.float32, device=None):
        t = initialize_size * 8
        super().__init__(t, input_dim, dim, blocks, num_heads, dropout, t * out_channels,
                         dtype=dtype, device=device)
        self.initialize_size, self.out_channels = initialize_size, out_channels

    def forward(self, z, generator=None):
        b, t = z.shape[0], self.tokens
        hl = self.pos_emb1D.to(self.dtype).expand(b, t, self.dim)
        x = self._head(z, hl, generator)
        # the channel-major view: (B, T, T*C) -> (B, C, T, T) -> NHWC
        return x.reshape(b, self.out_channels, t, t).permute(0, 2, 3, 1)


class SimpleGenerator(_GeneratorBase):
    """VitGAN SimpleGenerator: size^2 tokens, a per-token head -> (B, S, S, C)."""

    def __init__(self, size, input_dim, dim=384, blocks=6, num_heads=6, dropout=0.0,
                 out_channels=256, *, dtype=torch.float32, device=None):
        super().__init__(size * size, input_dim, dim, blocks, num_heads, dropout, out_channels,
                         dtype=dtype, device=device)
        self.size, self.out_channels = size, out_channels
        self.inp = Linear(input_dim, size * size * dim, dtype=dtype, device=device)

    def forward(self, z, generator=None):
        b, t, s = z.shape[0], self.tokens, self.size
        # the dim-major view: (B, dim, T) -> (B, T, dim)
        hl = self.inp(z).reshape(b, self.dim, t).transpose(1, 2) + self.pos_emb1D.to(self.dtype)
        return self._head(z, hl, generator).reshape(b, s, s, self.out_channels)


class SineLayer(nn.Module):
    """SIREN layer: sin(omega_0 * (x W^T + b)); key `linear`."""

    def __init__(self, in_features, out_features, is_first=False, omega_0=30.0, bias=True, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.is_first, self.omega_0 = is_first, omega_0
        self.linear = Linear(in_features, out_features, bias=bias, dtype=dtype, device=device)

    def forward(self, x):
        return torch.sin(self.omega_0 * self.linear(x))

    @torch.no_grad()
    def init_random_(self, generator):
        """The SIREN init: weight U(-1/in, 1/in) on a first layer, else
        U(-sqrt(6/in)/omega_0, sqrt(6/in)/omega_0); bias torch Linear's
        U(-1/sqrt(in), 1/sqrt(in))."""
        fan_in = self.linear.in_features
        bound = 1.0 / fan_in if self.is_first else (6.0 / fan_in) ** 0.5 / self.omega_0
        self.linear.weight.uniform_(-bound, bound, generator=generator)
        if self.linear.bias is not None:
            self.linear.bias.uniform_(-fan_in ** -0.5, fan_in ** -0.5, generator=generator)
        return self


class DiscriminatorAttention(nn.Module):
    """L2 attention for Lipschitz discriminators: softmax over dim**-0.5 times
    the (non-squared) euclidean distances between queries and keys, with the qkv
    weight scaled to `init_spect_norm` / sigma_max(weight) on every forward.

    `init_spect_norm` is a buffer, not a state-dict key: the reference captures
    it from its random init, which no file records, so it is set from the
    weight loaded (`init_discriminator_spectral_norms`), as the JAX converter
    sets it."""

    def __init__(self, dim, num_heads, *, dtype=torch.float32, device=None):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, num_heads, dtype
        inner = num_heads * (dim // num_heads)
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False, device=device)
        self.w_out = Linear(inner, dim, dtype=dtype, device=device)
        self.register_buffer("init_spect_norm", torch.ones((), device=device), persistent=False)

    def forward(self, x):
        w = self.to_qkv.weight
        sigma = torch.linalg.svdvals(w)[0]
        w = (w * (self.init_spect_norm / sigma)).to(self.dtype)
        q, k, v = _unpack_qkv(F.linear(x.to(self.dtype), w), self.heads)
        d2 = (q.square().sum(-1, keepdim=True) + k.square().sum(-1)[:, :, None, :]
              - 2.0 * torch.matmul(q, k.transpose(-1, -2)))
        attn = torch.sqrt(d2.float().clamp_min(0.0)) * (self.dim ** -0.5)
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        return self.w_out(_merge_heads(torch.matmul(attn, v)))


class DEncoderBlock(nn.Module):
    """Discriminator block: pre-LN L2 attention and MLP residuals."""

    def __init__(self, dim, num_heads, dropout=0.0, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(dim, **kw)
        self.attn = DiscriminatorAttention(dim, num_heads, **kw)
        self.norm2 = LayerNorm(dim, **kw)
        self.mlp = VitGANMLP(dim, dim * 4, dropout, **kw)
        self.dropout = Dropout(dropout)

    def forward(self, x, generator=None):
        x = x + self.dropout(self.attn(self.norm1(x)), generator)
        return x + self.mlp(self.norm2(x), generator)


class DEncoder(nn.Module):
    """The discriminator's `Transformer_Encoder`."""

    def __init__(self, dim, blocks, num_heads, dropout=0.0, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            DEncoderBlock(dim, num_heads, dropout, dtype=dtype, device=device)
            for _ in range(blocks))

    def forward(self, x, generator=None):
        for block in self.blocks:
            x = block(x, generator)
        return x


class Discriminator(nn.Module):
    """VitGAN Discriminator: overlapping patches, a cls token, L2-attention
    blocks and a sigmoid head; images NHWC (B, H, W, in_channels) -> (B, 1).

    The reference's quirks, as the JAX module keeps them: the patch stride is
    (H - p)//8 + 1 per axis (p = patch_size + 2*extend_size); the patches
    (B, C, nH, nW, p, p) are flattened in that order into tokens of C*p*p values
    (channel and row slices mixed, the reference's `.view`); the position table
    has token_dim + 1 rows, of which the first tokens + 1 are used. Keys:
    `project_patches`, `cls_token`, `pos_emb1D`, `Transformer_Encoder.blocks.{i}`,
    `mlp_head.0` (LayerNorm), `mlp_head.1`."""

    def __init__(self, in_channels=3, patch_size=8, extend_size=2, dim=384, blocks=6,
                 num_heads=6, dropout=0.0, *, dtype=torch.float32, device=None):
        super().__init__()
        self.p = patch_size + 2 * extend_size
        self.dim, self.dtype = dim, dtype
        token_dim = in_channels * self.p * self.p
        kw = dict(dtype=dtype, device=device)
        self.project_patches = Linear(token_dim, dim, **kw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        self.pos_emb1D = nn.Parameter(torch.zeros(token_dim + 1, dim, device=device))
        self.Transformer_Encoder = DEncoder(dim, blocks, num_heads, dropout, **kw)
        self.mlp_head = nn.Sequential(LayerNorm(dim, **kw), Linear(dim, 1, **kw))
        self.dropout = Dropout(dropout)

    def forward(self, img, generator=None):
        p, dt = self.p, self.dtype
        b, hh, ww, _ = img.shape
        sh, sw = (hh - p) // 8 + 1, (ww - p) // 8 + 1
        patches = img.permute(0, 3, 1, 2).unfold(2, p, sh).unfold(3, p, sw)  # (b, c, nh, nw, p, p)
        tokens = patches.shape[2] * patches.shape[3]
        emb = self.project_patches(patches.reshape(b, tokens, -1))
        emb = torch.cat([self.cls_token.to(dt).expand(b, 1, self.dim), emb], dim=1)
        emb = self.dropout(emb + self.pos_emb1D[:tokens + 1].to(dt), generator)
        emb = self.Transformer_Encoder(emb, generator)
        logits = self.mlp_head(emb[:, 0, :])
        return torch.sigmoid(logits.float()).to(dt)

    @torch.no_grad()
    def init_random_(self, generator):
        """The JAX module's init: lecun-normal matrices, zero biases, unit LN
        scales, cls token and positions N(0, 1); then each attention's
        `init_spect_norm` from its weight."""
        init_blocks_(self, generator=generator)
        self.cls_token.normal_(0.0, 1.0, generator=generator)
        self.pos_emb1D.normal_(0.0, 1.0, generator=generator)
        return init_discriminator_spectral_norms(self)


@torch.no_grad()
def init_discriminator_spectral_norms(module):
    """Set every DiscriminatorAttention's `init_spect_norm` in `module` to the
    largest singular value of its current `to_qkv` weight (call after loading
    weights). Returns `module`."""
    for m in module.modules():
        if isinstance(m, DiscriminatorAttention):
            m.init_spect_norm.copy_(torch.linalg.svdvals(m.to_qkv.weight.float())[0])
    return module

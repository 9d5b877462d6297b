"""XTransformer mapper: a causal decoder transformer over the latent token grid.

Port of feed_forward_vqgan_clip_tpu/models/mappers/xtransformer.py: the
reference's wrapper around lucidrains' x-transformers 0.19.1
`ContinuousTransformerWrapper` + `Decoder`, with its three input modes:

  * initial_proj=True: Linear(input_dim -> S^2*dim) seeds all tokens;
  * initial_proj=False, add_input=True: the input broadcast to all S^2 tokens;
  * initial_proj=False, add_input=False: the input prepended as token 0 to S^2
    zero tokens, dropped from the output.

`project_in` is always there (dim -> dim in the first mode), then learned
absolute positions, pre-LN blocks of causal attention (bias-free to_q/k/v,
dim_head 64 whatever dim is, scale dim_head**-0.5) and a feed-forward
(Linear -> exact GELU -> dropout -> Linear), the wrapper's final LayerNorm and
`project_out`.

Attribute names are the x-transformers 0.19.1 state-dict keys (the JAX converter
io/torch_import.convert_xtransformer reads them): `proj`; `transformer.project_in`,
`transformer.pos_emb.emb`, `transformer.attn_layers.layers.{2i}.{0: LayerNorm,
1: to_q, to_k, to_v, to_out}`, `transformer.attn_layers.layers.{2i+1}.{0:
LayerNorm, 1.net.0.0, 1.net.2}`, `transformer.norm`, `transformer.project_out`.
The position table has n + (0 if add_input else 1) rows in every mode, as the
reference sizes it: with initial_proj and not add_input its last row is never
used. Attention is `F.scaled_dot_product_attention` (causal), whose softmax
runs in float32. Outputs are NHWC latents (B, S, S, C).

While tracing is on (tracing.py) a forward records disjoint spans: `mapper.proj`
(proj, project_in and the positions), per block `mapper.attn` (LayerNorm, q, k,
v, the attention and to_out; inside it `mapper.sdpa`, the SDPA call alone, with
its batch, tokens, heads, dim_head and causal) and `mapper.ff` (LayerNorm and
the feed-forward), and `mapper.out` (the final LayerNorm and project_out); the
residual adds lie outside them all.
"""

import torch
import torch.nn.functional as F
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import LayerNorm, Linear, init_blocks_
from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import Dropout
from feed_forward_vqgan_clip_tpu_torch.tracing import span


class XAttention(nn.Module):
    def __init__(self, dim, heads, dim_head=64, *, dtype=torch.float32, device=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        kw = dict(dtype=dtype, device=device)
        self.to_q = Linear(dim, inner, bias=False, **kw)
        self.to_k = Linear(dim, inner, bias=False, **kw)
        self.to_v = Linear(dim, inner, bias=False, **kw)
        self.to_out = Linear(inner, dim, **kw)

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = (p(x).reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for p in (self.to_q, self.to_k, self.to_v))
        with span("mapper.sdpa", batch=b, tokens=n, heads=self.heads, dim_head=self.dim_head,
                  causal=True):
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class XFeedForward(nn.Module):
    """`net` = (Sequential(Linear, GELU), Dropout, Linear): keys net.0.0, net.2."""

    def __init__(self, dim, mult=4, dropout=0.0, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.net = nn.Sequential(nn.Sequential(Linear(dim, dim * mult, **kw), nn.GELU()),
                                 Dropout(dropout), Linear(dim * mult, dim, **kw))

    def forward(self, x, generator=None):
        return self.net[2](self.net[1](self.net[0](x), generator))


class _PositionTable(nn.Module):
    def __init__(self, rows, dim, *, device=None):
        super().__init__()
        self.emb = nn.Embedding(rows, dim, device=device)


class _AttnLayers(nn.Module):
    """`layers`: [LayerNorm, XAttention] then [LayerNorm, XFeedForward] per block."""

    def __init__(self, dim, depth, heads, dim_head, dropout, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        layers = []
        for _ in range(depth):
            layers.append(nn.ModuleList([LayerNorm(dim, **kw),
                                         XAttention(dim, heads, dim_head, **kw)]))
            layers.append(nn.ModuleList([LayerNorm(dim, **kw),
                                         XFeedForward(dim, dropout=dropout, **kw)]))
        self.layers = nn.ModuleList(layers)

    def forward(self, h, generator=None):
        for i in range(0, len(self.layers), 2):
            ln, attn = self.layers[i]
            with span("mapper.attn"):
                a = attn(ln(h))
            h = h + a
            ln, ff = self.layers[i + 1]
            with span("mapper.ff"):
                f = ff(ln(h), generator)
            h = h + f
        return h


class _Wrapper(nn.Module):
    """ContinuousTransformerWrapper: project_in, positions, blocks, norm, project_out."""

    def __init__(self, dim_in, dim_out, rows, dim, depth, heads, dim_head, dropout, *, dtype,
                 device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.project_in = Linear(dim_in, dim, **kw)
        self.pos_emb = _PositionTable(rows, dim, device=device)
        self.attn_layers = _AttnLayers(dim, depth, heads, dim_head, dropout, **kw)
        self.norm = LayerNorm(dim, **kw)
        self.project_out = Linear(dim, dim_out, **kw)


class XTransformer(nn.Module):
    """z (B, input_dim) -> latent (B, S, S, C) NHWC."""

    def __init__(self, input_dim, image_size, channels, dim, depth, heads=6, dim_head=64,
                 initial_proj=True, add_input=False, dropout=0.0, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.input_dim, self.image_size, self.channels = input_dim, image_size, channels
        self.dim, self.depth = dim, depth
        self.initial_proj, self.add_input, self.dtype = initial_proj, add_input, dtype
        n = image_size * image_size
        if initial_proj:
            self.proj = Linear(input_dim, n * dim, dtype=dtype, device=device)
        self.transformer = _Wrapper(dim if initial_proj else input_dim, channels,
                                    n + (0 if add_input else 1), dim, depth, heads, dim_head,
                                    dropout, dtype=dtype, device=device)

    def forward(self, z, generator=None):
        b, s, dt = z.shape[0], self.image_size, self.dtype
        n = s * s
        z = z.to(dt)
        t = self.transformer
        with span("mapper.proj"):
            if self.initial_proj:
                h = self.proj(z).reshape(b, n, self.dim)
            elif self.add_input:
                h = z[:, None, :].expand(b, n, self.input_dim)
            else:
                h = torch.cat([z[:, None, :], z.new_zeros(b, n, self.input_dim)], dim=1)
            h = t.project_in(h)
            h = h + t.pos_emb.emb.weight[:h.shape[1]].to(dt)
        h = t.attn_layers(h, generator)
        with span("mapper.out"):
            h = t.project_out(t.norm(h))
        if not self.initial_proj and not self.add_input:
            h = h[:, 1:]
        return h.reshape(b, s, s, self.channels)

    @torch.no_grad()
    def init_random_(self, generator):
        """The JAX module's init from a torch.Generator: lecun-normal matrices
        (std 1/sqrt(fan_in)), zero biases, unit LN scales, positions N(0, 0.02)."""
        init_blocks_(self, generator=generator)
        self.transformer.pos_emb.emb.weight.normal_(0.0, 0.02, generator=generator)
        return self

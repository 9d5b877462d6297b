"""CLIP ViT text tower (the `encode_text` half of OpenAI CLIP).

Port of the text half of feed_forward_vqgan_clip_tpu/models/clip_vit.py.
Attributes carry OpenAI CLIP's state-dict names (io/torch_import.convert_clip_vit
documents them): `token_embedding`, `positional_embedding`,
`transformer.resblocks.{i}.{ln_1, attn.in_proj_weight, attn.in_proj_bias,
attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}`, `ln_final`, `text_projection`.
Parameters are float32; `dtype` is the compute dtype. Attention is plain
matmul + f32 softmax (the JAX MHSA has no kernel either). The image tower is
slice 2 (ROADMAP A7).
"""

import torch
import torch.nn.functional as F
from torch import nn

from feed_forward_vqgan_clip_tpu.registry import CLIP_VIT_CONFIGS


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class LayerNorm(nn.LayerNorm):
    """LayerNorm(eps=1e-5) computed in float32, cast back to the compute dtype."""

    def __init__(self, dim, *, dtype=torch.float32, device=None):
        super().__init__(dim, eps=1e-5, device=device)
        self.dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.dtype)


class MHSA(nn.Module):
    """Multi-head self-attention with torch.nn.MultiheadAttention's parameters
    (packed `in_proj_weight` / `in_proj_bias`, `out_proj`)."""

    def __init__(self, dim, heads, *, dtype=torch.float32, device=None):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim, device=device))
        self.out_proj = nn.Linear(dim, dim, device=device)

    def forward(self, x, mask=None):
        b, t, d = x.shape
        dt, dh = self.dtype, d // self.heads
        qkv = F.linear(x, self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        q, k, v = (p.reshape(b, t, self.heads, dh).transpose(1, 2) for p in qkv.chunk(3, -1))
        attn = torch.matmul(q, k.transpose(-1, -2)) * (dh ** -0.5)
        if mask is not None:
            attn = attn + mask.to(attn.dtype)
        attn = torch.softmax(attn.float(), dim=-1).to(dt)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, d)
        return F.linear(out, self.out_proj.weight.to(dt), self.out_proj.bias.to(dt))


class MLP(nn.Module):
    """`mlp.c_fc` -> activation -> `mlp.c_proj`."""

    def __init__(self, dim, act, *, dtype=torch.float32, device=None):
        super().__init__()
        self.act, self.dtype = act, dtype
        self.c_fc = nn.Linear(dim, 4 * dim, device=device)
        self.c_proj = nn.Linear(4 * dim, dim, device=device)

    def forward(self, x):
        dt = self.dtype
        h = F.linear(x, self.c_fc.weight.to(dt), self.c_fc.bias.to(dt))
        h = quick_gelu(h) if self.act == "quick_gelu" else F.gelu(h)
        return F.linear(h, self.c_proj.weight.to(dt), self.c_proj.bias.to(dt))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, dim, heads, act="quick_gelu", *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ln_1 = LayerNorm(dim, **kw)
        self.attn = MHSA(dim, heads, **kw)
        self.ln_2 = LayerNorm(dim, **kw)
        self.mlp = MLP(dim, act, **kw)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width, layers, heads, act="quick_gelu", *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, act, dtype=dtype, device=device)
            for _ in range(layers)
        )

    def forward(self, x, mask=None):
        for block in self.resblocks:
            x = block(x, mask)
        return x


class TextTransformer(nn.Module):
    """tokens int (B, context) -> (B, embed_dim) float32; EOT pooling at argmax(tokens)."""

    def __init__(self, context_length=77, vocab_size=49408, width=512, layers=12, heads=8,
                 embed_dim=512, act="quick_gelu", *, dtype=torch.float32, device=None):
        super().__init__()
        self.context_length, self.width, self.embed_dim = context_length, width, embed_dim
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, width, device=device)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width, device=device))
        self.transformer = Transformer(width, layers, heads, act, dtype=dtype, device=device)
        self.ln_final = LayerNorm(width, dtype=dtype, device=device)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim, device=device))

    def forward(self, tokens):
        dt = self.dtype
        h = self.token_embedding.weight[tokens].to(dt) + self.positional_embedding.to(dt)
        t = tokens.shape[1]
        mask = torch.full((t, t), float("-inf"), device=tokens.device).triu(1)
        h = self.ln_final(self.transformer(h, mask))
        # the EOT token has the highest id in each sequence
        pooled = h[torch.arange(h.shape[0], device=h.device), tokens.argmax(-1)]
        return (pooled @ self.text_projection.to(dt)).float()

    encode_text = forward

    @torch.no_grad()
    def init_random_(self, generator):
        """The JAX module's init from a torch.Generator: embeddings N(0, 0.02),
        positions N(0, 0.01), projection N(0, width^-1/2), lecun-normal dense
        kernels, zero biases, unit norms."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, m.weight.shape[1] ** -0.5, generator=generator)
                m.bias.zero_()
            elif isinstance(m, MHSA):
                m.in_proj_weight.normal_(0.0, m.in_proj_weight.shape[1] ** -0.5,
                                         generator=generator)
                m.in_proj_bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        self.text_projection.normal_(0.0, self.width ** -0.5, generator=generator)
        return self


def make_clip_from_config(cfg: dict, act: str = "quick_gelu", dtype=torch.float32,
                          device=None) -> TextTransformer:
    """The text tower of a CLIP ViT from a CLIP_VIT_CONFIGS-schema dict."""
    return TextTransformer(
        context_length=cfg["context_length"], vocab_size=cfg["vocab_size"],
        width=cfg["text_width"], layers=cfg["text_layers"], heads=cfg["text_heads"],
        embed_dim=cfg["embed_dim"], act=act, dtype=dtype, device=device,
    )


def make_clip(name: str, dtype=torch.float32, device=None) -> TextTransformer:
    """The text tower of a CLIP ViT from a backbone name ('ViT-B/32',
    'openclip/ViT-B-32/<tag>'; non-quickgelu OpenCLIP tags use exact GELU)."""
    act = "quick_gelu"
    arch = name
    if name.startswith("openclip/"):
        _, arch, _tag = name.split("/", 2)
        act = "quick_gelu" if arch.endswith("-quickgelu") else "gelu"
        parts = arch.replace("-quickgelu", "").split("-")  # ViT-B-32 -> ViT-B/32
        arch = f"ViT-{parts[1]}/{parts[2]}" if len(parts) == 3 and parts[0] == "ViT" else arch
    if arch not in CLIP_VIT_CONFIGS:
        raise ValueError(f"unknown CLIP ViT arch {arch!r} (from {name!r}); known archs: "
                         f"{sorted(CLIP_VIT_CONFIGS)}")
    return make_clip_from_config(CLIP_VIT_CONFIGS[arch], act=act, dtype=dtype, device=device)

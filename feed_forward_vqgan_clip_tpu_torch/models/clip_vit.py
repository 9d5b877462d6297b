"""CLIP ViT text and image towers (OpenAI CLIP's `encode_text` / `encode_image`).

Port of feed_forward_vqgan_clip_tpu/models/clip_vit.py. Attributes carry OpenAI
CLIP's state-dict names (io/torch_import.convert_clip_vit documents them): the
text tower at the top level (`token_embedding`, `positional_embedding`,
`transformer.resblocks.{i}.{ln_1, attn.in_proj_weight, attn.in_proj_bias,
attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}`, `ln_final`, `text_projection`), the
image tower under `visual.` (`conv1.weight`, `class_embedding`,
`positional_embedding`, `ln_pre`, `transformer.resblocks.{i}...`, `ln_post`,
`proj`), and `logit_scale`. Parameters are float32; `dtype` is the compute
dtype. Attention is plain matmul + f32 softmax (the JAX MHSA has no kernel
either). Images are NHWC at the public functions, as in the JAX package; the
patchify is the reference's stride-p Conv2d (the JAX matmul patchify was a TPU
lowering fix computing the same function).
"""

import torch
import torch.nn.functional as F
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.registry import CLIP_VIT_CONFIGS


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


class Linear(nn.Linear):
    """nn.Linear with float32 parameters computed in `dtype`: input, weight and
    bias cast to it (flax's Dense with a `dtype`)."""

    def __init__(self, in_features, out_features, bias=True, *, dtype=torch.float32,
                 device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


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
        init_blocks_(self.transformer, self.ln_final, generator=generator)
        self.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        self.text_projection.normal_(0.0, self.width ** -0.5, generator=generator)
        return self


@torch.no_grad()
def init_blocks_(*modules, generator):
    """lecun-normal dense and conv kernels (std fan_in^-1/2), zero biases, unit
    norms (flax defaults)."""
    for module in modules:
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, MHSA):
                m.in_proj_weight.normal_(0.0, m.in_proj_weight.shape[1] ** -0.5,
                                         generator=generator)
                m.in_proj_bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


class VisionTransformer(nn.Module):
    """images (B, H, W, 3) NHWC, CLIP-normalised -> (B, embed_dim) float32: stride-p
    patchify, class token, positions, pre-LN transformer, LN of the class token,
    projection."""

    def __init__(self, image_size=224, patch_size=32, width=768, layers=12, heads=12,
                 embed_dim=512, act="quick_gelu", *, dtype=torch.float32, device=None):
        super().__init__()
        self.patch_size, self.width, self.embed_dim = patch_size, width, embed_dim
        self.dtype = dtype
        grid = image_size // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False,
                               device=device)
        self.class_embedding = nn.Parameter(torch.empty(width, device=device))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width,
                                                             device=device))
        self.ln_pre = LayerNorm(width, dtype=dtype, device=device)
        self.transformer = Transformer(width, layers, heads, act, dtype=dtype, device=device)
        self.ln_post = LayerNorm(width, dtype=dtype, device=device)
        self.proj = nn.Parameter(torch.empty(width, embed_dim, device=device))

    def embed(self, x):
        """Patchify, class token, positions, ln_pre: (B, H, W, 3) -> (B, T, width)."""
        dt = self.dtype
        h = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.conv1.weight.to(dt),
                     stride=self.patch_size)
        h = h.flatten(2).transpose(1, 2)  # (B, grid*grid, width), patches row-major
        cls = self.class_embedding.to(dt).expand(h.shape[0], 1, self.width)
        return self.ln_pre(torch.cat([cls, h], dim=1) + self.positional_embedding.to(dt))

    def head(self, h):
        """ln_post of the class token, projection: (B, T, width) -> (B, embed_dim) f32."""
        return (self.ln_post(h[:, 0, :]) @ self.proj.to(self.dtype)).float()

    def forward(self, x):
        return self.head(self.transformer(self.embed(x)))

    @torch.no_grad()
    def init_random_(self, generator):
        """The JAX module's init: lecun-normal patch kernel and dense kernels, class
        token N(0, 0.02), positions N(0, 0.01), projection N(0, width^-1/2)."""
        init_blocks_(self.transformer, self.ln_pre, self.ln_post, generator=generator)
        self.conv1.weight.normal_(0.0, self.conv1.weight[0].numel() ** -0.5,
                                  generator=generator)
        self.class_embedding.normal_(0.0, 0.02, generator=generator)
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        self.proj.normal_(0.0, self.width ** -0.5, generator=generator)
        return self


class CLIP(TextTransformer):
    """Both towers and `logit_scale`: the text tower's attributes at the top level
    and the image tower under `visual`, as in OpenAI CLIP's state dict."""

    def __init__(self, cfg: dict, act="quick_gelu", *, dtype=torch.float32, device=None):
        super().__init__(
            context_length=cfg["context_length"], vocab_size=cfg["vocab_size"],
            width=cfg["text_width"], layers=cfg["text_layers"], heads=cfg["text_heads"],
            embed_dim=cfg["embed_dim"], act=act, dtype=dtype, device=device,
        )
        self.visual = VisionTransformer(
            image_size=cfg["image_size"], patch_size=cfg["patch_size"],
            width=cfg["vision_width"], layers=cfg["vision_layers"],
            heads=cfg["vision_heads"], embed_dim=cfg["embed_dim"], act=act, dtype=dtype,
            device=device,
        )
        self.logit_scale = nn.Parameter(torch.full((), 4.6052, device=device))

    def encode_image(self, x):
        return self.visual(x)

    @torch.no_grad()
    def init_random_(self, generator):
        """Text tower first (the same draws as a text-only tower from the same
        generator), then the image tower."""
        super().init_random_(generator)
        self.visual.init_random_(generator)
        self.logit_scale.fill_(4.6052)
        return self


def make_clip_from_config(cfg: dict, act: str = "quick_gelu", dtype=torch.float32,
                          device=None, image: bool = False) -> TextTransformer:
    """A CLIP ViT from a CLIP_VIT_CONFIGS-schema dict: both towers (`CLIP`) with
    `image`, else the text tower alone."""
    if image:
        return CLIP(cfg, act, dtype=dtype, device=device)
    return TextTransformer(
        context_length=cfg["context_length"], vocab_size=cfg["vocab_size"],
        width=cfg["text_width"], layers=cfg["text_layers"], heads=cfg["text_heads"],
        embed_dim=cfg["embed_dim"], act=act, dtype=dtype, device=device,
    )


def parse_openclip(name: str):
    """'openclip/<arch>/<tag>' -> (arch as the registry names it, activation):
    ViT-B-32 becomes ViT-B/32, RN archs stay as they are; exact GELU unless the
    arch ends in -quickgelu."""
    parts = name.split("/", 2)
    if len(parts) < 3:
        raise ValueError(f"openclip perceptor name {name!r} must look like "
                         "'openclip/<arch>/<pretrained_tag>'")
    arch = parts[1]
    act = "quick_gelu" if arch.endswith("-quickgelu") else "gelu"
    arch = arch.replace("-quickgelu", "")
    pieces = arch.split("-")
    if len(pieces) == 3 and pieces[0] == "ViT":
        arch = f"ViT-{pieces[1]}/{pieces[2]}"
    return arch, act


def make_clip(name: str, dtype=torch.float32, device=None,
              image: bool = False) -> TextTransformer:
    """A CLIP ViT from a backbone name ('ViT-B/32', 'openclip/ViT-B-32/<tag>';
    non-quickgelu OpenCLIP tags use exact GELU): both towers with `image`, else
    the text tower alone."""
    arch, act = parse_openclip(name) if name.startswith("openclip/") else (name, "quick_gelu")
    if arch not in CLIP_VIT_CONFIGS:
        raise ValueError(f"unknown CLIP ViT arch {arch!r} (from {name!r}); known archs: "
                         f"{sorted(CLIP_VIT_CONFIGS)}")
    return make_clip_from_config(CLIP_VIT_CONFIGS[arch], act=act, dtype=dtype, device=device,
                                 image=image)

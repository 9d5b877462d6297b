"""CLIP ModifiedResNet image tower with the CLIP text transformer.

Port of feed_forward_vqgan_clip_tpu/models/clip_resnet.py: OpenAI CLIP's RN
backbones (RN50, RN101, RN50x4, RN50x16) and the ml-jku CLOOB RN50 / RN50x4,
which reimplement the same architecture. A three-conv stem, an average pool,
four stages of Bottlenecks whose stride lives in an average pool before conv3
(and before the shortcut's conv), and an attention pool whose only query is
the mean token. BatchNorm is frozen: the running statistics of the weights
loaded, never updated.

Attribute names are OpenAI CLIP's RN state-dict keys (the JAX converter
io/torch_import.convert_clip_resnet reads them): the text tower at the top level
as in models/clip_vit.py, the image tower under `visual.` (`conv1..3`,
`bn1..3`, `layer{1-4}.{i}.{conv1..3, bn1..3, downsample.0, downsample.1}`,
`attnpool.{positional_embedding, q_proj, k_proj, v_proj, c_proj}`), and
`logit_scale`. BatchNorm's `num_batches_tracked` is not kept (the reader drops
it). Images are NHWC at `encode_image`, NCHW inside; the convolutions and
pools are cuDNN's (the JAX tower has no Pallas kernel either).
"""

import torch
import torch.nn.functional as F
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import Linear, TextTransformer, init_blocks_


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm2d (eps 1e-5) over NCHW channels: the affine
    folded from the running statistics in float32, applied in `dtype`."""

    def __init__(self, features, *, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + 1e-5)
        shift = self.bias - self.running_mean * inv
        dt = self.dtype
        return x * inv.to(dt)[:, None, None] + shift.to(dt)[:, None, None]


def _conv(cin, cout, k, *, device, stride=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False, device=device)


def _apply_conv(conv, x, dtype):
    return F.conv2d(x, conv.weight.to(dtype), stride=conv.stride, padding=conv.padding)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, *, dtype=torch.float32, device=None):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        out = planes * self.expansion
        kw = dict(dtype=dtype, device=device)
        self.conv1 = _conv(inplanes, planes, 1, device=device)
        self.bn1 = FrozenBatchNorm(planes, **kw)
        self.conv2 = _conv(planes, planes, 3, device=device)
        self.bn2 = FrozenBatchNorm(planes, **kw)
        self.conv3 = _conv(planes, out, 1, device=device)
        self.bn3 = FrozenBatchNorm(out, **kw)
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(_conv(inplanes, out, 1, device=device),
                                            FrozenBatchNorm(out, **kw))
        else:
            self.downsample = None

    def forward(self, x):
        dt = self.dtype
        h = F.relu(self.bn1(_apply_conv(self.conv1, x, dt)))
        h = F.relu(self.bn2(_apply_conv(self.conv2, h, dt)))
        if self.stride > 1:
            h = F.avg_pool2d(h, self.stride)
        h = self.bn3(_apply_conv(self.conv3, h, dt))
        sc = x
        if self.downsample is not None:
            if self.stride > 1:
                sc = F.avg_pool2d(sc, self.stride)
            sc = self.downsample[1](_apply_conv(self.downsample[0], sc, dt))
        return F.relu(h + sc)


class AttentionPool2d(nn.Module):
    """Attention pooling with the mean token as the only query: positions over
    HW + 1 tokens, q/k/v/c projections, f32 softmax."""

    def __init__(self, spacial_dim, embed_dim, heads, output_dim, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        kw = dict(dtype=dtype, device=device)
        self.positional_embedding = nn.Parameter(
            torch.zeros(spacial_dim ** 2 + 1, embed_dim, device=device))
        self.k_proj = Linear(embed_dim, embed_dim, **kw)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.c_proj = Linear(embed_dim, output_dim, **kw)

    def forward(self, x):
        """x (B, C, H, W) -> (B, output_dim)."""
        b, c = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)  # (B, HW, C), row-major
        tokens = torch.cat([tokens.mean(1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(self.dtype)
        h, dh = self.heads, c // self.heads
        q = self.q_proj(tokens[:, :1]).reshape(b, 1, h, dh).transpose(1, 2)
        k = self.k_proj(tokens).reshape(b, -1, h, dh).transpose(1, 2)
        v = self.v_proj(tokens).reshape(b, -1, h, dh).transpose(1, 2)
        attn = torch.matmul(q, k.transpose(-1, -2)) * (dh ** -0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
        return self.c_proj(torch.matmul(attn, v).reshape(b, c))


class ModifiedResNet(nn.Module):
    """images (B, H, W, 3) NHWC, CLIP-normalised -> (B, output_dim) float32."""

    def __init__(self, layers, output_dim, heads, input_resolution=224, width=64, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.conv1 = _conv(3, width // 2, 3, stride=2, device=device)
        self.bn1 = FrozenBatchNorm(width // 2, **kw)
        self.conv2 = _conv(width // 2, width // 2, 3, device=device)
        self.bn2 = FrozenBatchNorm(width // 2, **kw)
        self.conv3 = _conv(width // 2, width, 3, device=device)
        self.bn3 = FrozenBatchNorm(width, **kw)
        inplanes = width
        for i, n in enumerate(layers):
            planes, stride = width * 2 ** i, 1 if i == 0 else 2
            blocks = []
            for j in range(n):
                blocks.append(Bottleneck(inplanes, planes, stride if j == 0 else 1, **kw))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32, heads, output_dim,
                                        **kw)

    def forward(self, x):
        dt = self.dtype
        h = x.to(dt).permute(0, 3, 1, 2)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            h = F.relu(bn(_apply_conv(conv, h, dt)))
        h = F.avg_pool2d(h, 2)
        h = self.layer4(self.layer3(self.layer2(self.layer1(h))))
        return self.attnpool(h).float()


class CLIPResNet(TextTransformer):
    """The RN image tower under `visual`, the text tower at the top level and
    `logit_scale`, as in OpenAI CLIP's state dict. `cfg`: a
    registry.CLIP_RESNET_CONFIGS entry."""

    def __init__(self, cfg: dict, act="quick_gelu", *, dtype=torch.float32, device=None):
        super().__init__(
            context_length=cfg["context_length"], vocab_size=cfg["vocab_size"],
            width=cfg["text_width"], layers=cfg["text_layers"], heads=cfg["text_heads"],
            embed_dim=cfg["embed_dim"], act=act, dtype=dtype, device=device,
        )
        width = cfg["vision_width"]
        self.visual = ModifiedResNet(cfg["vision_layers"], cfg["embed_dim"], width * 32 // 64,
                                     cfg["image_size"], width, dtype=dtype, device=device)
        self.logit_scale = nn.Parameter(torch.full((), 4.6052, device=device))

    def encode_image(self, x):
        return self.visual(x)

    @torch.no_grad()
    def init_random_(self, generator):
        """The JAX module's init from a torch.Generator, the text tower first:
        lecun-normal conv and dense kernels, zero biases, BatchNorm of unit scale
        and variance and zero shift and mean, attention-pool positions
        N(0, C^-1/2)."""
        super().init_random_(generator)
        init_blocks_(self.visual, generator=generator)
        for m in self.visual.modules():
            if isinstance(m, FrozenBatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        pos = self.visual.attnpool.positional_embedding
        pos.normal_(0.0, pos.shape[1] ** -0.5, generator=generator)
        self.logit_scale.fill_(4.6052)
        return self

"""crowsonkb's CLOOB ViTs (`cloob_laion_400m_vit_b_16_{16,32}_epochs`).

Port of feed_forward_vqgan_clip_tpu/models/cloob.py `CrowsonCLOOB`: a pre-LN
ViT-B/16 image tower and a text transformer, each pooling token 0, projecting
with a bias and L2-normalising inside the encoder. Details the port keeps:

  * LayerNorm (eps 1e-5, float32) inside each sublayer: x + attn(LN(x)),
    x + ff(LN(x)); no ln_pre, no ln_post. q, k, v and out projections with
    bias, scale dh^-0.5, softmax in float32, exact GELU.
  * The text padding mask, (cumsum(tokens == eot) == 0) | (tokens == eot) with
    eot = vocab - 1, sits on the QUERY axis (upstream cloob_crowsonkb.py:55-57):
    a padded query's row of logits is filled with -1e30, and tokens past eot
    still reach the valid queries through the keys. Plain matmul and softmax,
    so the fill is the JAX module's.
  * The image patch convolution has no bias; `class_embed` is prepended and
    `pos_embed` has one row per patch plus one.
  * `logit_scale` is a fixed 4.6052 (CLOOB has no CLIP temperature; only the
    evaluation's CLIP score reads it).

The released weights are haiku pickles {"params": (image_tree, text_tree)};
`haiku_state_dict` maps them onto this module's names (haiku `w` is (in, out):
a Linear weight is its transpose; the patch `embed/w` is HWIO, made OIHW;
`offset` is the LayerNorm bias). A leaf pickled as a JAX array is rebuilt as
the numpy array it holds by an unpickler that names only numpy, the containers
and JAX's array rebuilders: the port imports no JAX. It builds numpy's
classes, so the pickle must be trusted, as for `pickle.load`.
Parameters are float32; `dtype` is the compute dtype. Images NHWC.
"""

import logging
import pickle
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import LayerNorm, Linear, init_blocks_

log = logging.getLogger(__name__)

# the public cloob-training config json values (a copy of the JAX package's)
CROWSON_CONFIGS = {
    "cloob_laion_400m_vit_b_16_16_epochs": dict(
        d_embed=512, image_layers=12, image_d_model=768, image_heads=12,
        image_size=224, patch_size=16, text_layers=12, text_d_model=512,
        text_heads=8, text_size=77, vocab_size=49408,
    ),
    "cloob_laion_400m_vit_b_16_32_epochs": dict(
        d_embed=512, image_layers=12, image_d_model=768, image_heads=12,
        image_size=224, patch_size=16, text_layers=12, text_d_model=512,
        text_heads=8, text_size=77, vocab_size=49408,
    ),
}
LOGIT_SCALE = 4.6052


class PreLNBlock(nn.Module):
    """x + out(attn(LN(x))); x + linear_1(gelu(linear_0(LN(x))))."""

    def __init__(self, d, heads, *, dtype=torch.float32, device=None):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        kw = dict(dtype=dtype, device=device)
        self.attn_norm = LayerNorm(d, **kw)
        self.query = Linear(d, d, **kw)
        self.key = Linear(d, d, **kw)
        self.value = Linear(d, d, **kw)
        self.out = Linear(d, d, **kw)
        self.ff_norm = LayerNorm(d, **kw)
        self.linear_0 = Linear(d, 4 * d, **kw)
        self.linear_1 = Linear(4 * d, d, **kw)

    def forward(self, x, padding_mask=None):
        b, t, d = x.shape
        dh = d // self.heads
        h = self.attn_norm(x)
        q, k, v = (lin(h).reshape(b, t, self.heads, dh).transpose(1, 2)
                   for lin in (self.query, self.key, self.value))
        logits = torch.matmul(q, k.transpose(-1, -2)) / (dh ** 0.5)
        if padding_mask is not None:  # on the query axis, as upstream
            logits = torch.where(padding_mask[:, None, :, None], logits,
                                 torch.tensor(-1e30, dtype=logits.dtype, device=x.device))
        weights = torch.softmax(logits.float(), dim=-1).to(self.dtype)
        attn = torch.matmul(weights, v).transpose(1, 2).reshape(b, t, d)
        x = x + self.out(attn)
        h = self.linear_1(F.gelu(self.linear_0(self.ff_norm(x))))
        return x + h


def _pool(proj, h):
    """Token 0, projected, L2-normalised in float32."""
    h = proj(h[:, 0]).float()
    return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)


class CrowsonTextEncoder(nn.Module):
    def __init__(self, d_embed, layers, d_model, seq_len, heads, vocab_size, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.vocab_size, self.dtype = vocab_size, dtype
        self.embed = nn.Embedding(vocab_size, d_model, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(seq_len, d_model, device=device))
        self.layers = nn.ModuleList(PreLNBlock(d_model, heads, dtype=dtype, device=device)
                                    for _ in range(layers))
        self.proj = Linear(d_model, d_embed, dtype=dtype, device=device)

    def forward(self, tokens):
        eot = tokens == self.vocab_size - 1
        padding_mask = (torch.cumsum(eot.int(), dim=-1) == 0) | eot
        h = self.embed.weight[tokens].to(self.dtype) + self.pos_embed.to(self.dtype)
        for layer in self.layers:
            h = layer(h, padding_mask)
        return _pool(self.proj, h)


class CrowsonViTImageEncoder(nn.Module):
    def __init__(self, d_embed, layers, d_model, heads, patch_size, image_size, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.patch_size, self.d_model, self.dtype = patch_size, d_model, dtype
        grid = image_size // patch_size
        self.embed = nn.Conv2d(3, d_model, patch_size, stride=patch_size, bias=False,
                               device=device)
        self.class_embed = nn.Parameter(torch.zeros(d_model, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(grid * grid + 1, d_model, device=device))
        self.layers = nn.ModuleList(PreLNBlock(d_model, heads, dtype=dtype, device=device)
                                    for _ in range(layers))
        self.proj = Linear(d_model, d_embed, dtype=dtype, device=device)

    def forward(self, x):
        dt = self.dtype
        h = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.embed.weight.to(dt),
                     stride=self.patch_size)
        h = h.flatten(2).transpose(1, 2)  # (B, grid*grid, d), patches row-major
        cls = self.class_embed.to(dt).expand(h.shape[0], 1, self.d_model)
        h = torch.cat([cls, h], dim=1) + self.pos_embed.to(dt)
        for layer in self.layers:
            h = layer(h)
        return _pool(self.proj, h)


class CrowsonCLOOB(nn.Module):
    """Both towers (the text tower alone with `image=False`) and the fixed
    `logit_scale`; `encode_text` and `encode_image` give unit (B, d_embed)
    float32 rows."""

    def __init__(self, cfg: dict, *, dtype=torch.float32, device=None, image: bool = True):
        super().__init__()
        self.cfg = dict(cfg)
        kw = dict(dtype=dtype, device=device)
        self.text_encoder = CrowsonTextEncoder(
            cfg["d_embed"], cfg["text_layers"], cfg["text_d_model"], cfg["text_size"],
            cfg["text_heads"], cfg["vocab_size"], **kw)
        self.image_encoder = CrowsonViTImageEncoder(
            cfg["d_embed"], cfg["image_layers"], cfg["image_d_model"], cfg["image_heads"],
            cfg["patch_size"], cfg["image_size"], **kw) if image else None
        self.logit_scale = nn.Parameter(torch.full((), LOGIT_SCALE, device=device))

    def encode_text(self, tokens):
        return self.text_encoder(tokens)

    def encode_image(self, x):
        return self.image_encoder(x)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """The JAX module's init: embeddings N(0, 0.02), text positions N(0, 1),
        class token N(0, d^-1/2), image positions N(0, 1), lecun-normal dense and
        patch kernels, zero biases, unit norms."""
        towers = [self.text_encoder] + ([self.image_encoder] if self.image_encoder else [])
        for tower in towers:
            init_blocks_(tower, generator=generator)
            tower.pos_embed.normal_(0.0, 1.0, generator=generator)
        self.text_encoder.embed.weight.normal_(0.0, 0.02, generator=generator)
        if self.image_encoder is not None:
            d = self.image_encoder.d_model
            self.image_encoder.class_embed.normal_(0.0, d ** -0.5, generator=generator)
        self.logit_scale.fill_(LOGIT_SCALE)
        return self


# ------------------------------------------------------------------ haiku pickles


def _rebuild_jax_array(fun, args, arr_state, *_aval_state):
    """A pickled JAX array's reconstructor, onto numpy: the numpy array it holds."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return value


class HaikuUnpickler(pickle.Unpickler):
    """numpy's and the containers' classes for real, numpy's array rebuilding, a
    pickled JAX array as its numpy array, haiku's old FlatMap containers as
    dicts; nothing else."""

    SAFE_BUILTINS = frozenset({"dict", "list", "tuple", "set", "frozenset", "complex", "slice"})
    REBUILD_MODULES = ("numpy.core.multiarray", "numpy._core.multiarray", "numpy.core.numeric",
                       "numpy._core.numeric", "copyreg", "_codecs")

    def find_class(self, module, name):
        root = module.split(".")[0]
        if module in self.REBUILD_MODULES:
            return super().find_class(module, name)
        if root in ("numpy", "collections"):
            cls = super().find_class(module, name)
            if isinstance(cls, type):
                return cls
        if module == "builtins" and name in self.SAFE_BUILTINS:
            return super().find_class(module, name)
        if root in ("jax", "jaxlib") and name in ("_reconstruct_array",
                                                  "reconstruct_device_array"):
            return _rebuild_jax_array
        if root == "haiku" and name.startswith("FlatMap"):
            return dict
        raise pickle.UnpicklingError(f"CLOOB pickle: {module}.{name} is not allowed")


def _haiku_layers(tree: dict, base: str, n: int, prefix: str, sd: dict) -> None:
    def g(i, name):
        return {k: np.asarray(v, np.float32) for k, v in tree[f"{base}/layer_{i}/{name}"].items()}

    for i in range(n):
        pre = f"{prefix}.layers.{i}"
        for port, haiku in (("attn_norm", "self_attention/layer_norm"),
                            ("ff_norm", "feed_forward/layer_norm")):
            p = g(i, haiku)
            sd[f"{pre}.{port}.weight"], sd[f"{pre}.{port}.bias"] = p["scale"], p["offset"]
        for port, haiku in (("query", "self_attention/multi_head_attention/query"),
                            ("key", "self_attention/multi_head_attention/key"),
                            ("value", "self_attention/multi_head_attention/value"),
                            ("out", "self_attention/multi_head_attention/linear"),
                            ("linear_0", "feed_forward/linear_0"),
                            ("linear_1", "feed_forward/linear_1")):
            p = g(i, haiku)
            sd[f"{pre}.{port}.weight"], sd[f"{pre}.{port}.bias"] = p["w"].T, p["b"]


def haiku_state_dict(payload: dict, cfg: dict) -> dict:
    """The released haiku pickle's {"params": (image_tree, text_tree)} -> this
    module's state dict (float32 tensors)."""
    img, txt = payload["params"]
    a = lambda v: np.asarray(v, np.float32)  # noqa: E731
    ib, tb = "vi_t_image_encoder", "text_encoder"
    sd = {
        "image_encoder.embed.weight": a(img[f"{ib}/embed"]["w"]).transpose(3, 2, 0, 1),
        "image_encoder.class_embed": a(img[ib]["class_embed"]),
        "image_encoder.pos_embed": a(img[f"{ib}/pos_embed"]["w"]),
        "image_encoder.proj.weight": a(img[f"{ib}/proj"]["w"]).T,
        "image_encoder.proj.bias": a(img[f"{ib}/proj"]["b"]),
        "text_encoder.embed.weight": a(txt[f"{tb}/embed"]["embeddings"]),
        "text_encoder.pos_embed": a(txt[f"{tb}/pos_embed"]["w"]),
        "text_encoder.proj.weight": a(txt[f"{tb}/proj"]["w"]).T,
        "text_encoder.proj.bias": a(txt[f"{tb}/proj"]["b"]),
        "logit_scale": np.float32(LOGIT_SCALE),
    }
    _haiku_layers(img, ib, cfg["image_layers"], "image_encoder", sd)
    _haiku_layers(txt, tb, cfg["text_layers"], "text_encoder", sd)
    return {k: torch.from_numpy(np.array(v, np.float32, order="C")) for k, v in sd.items()}


def read_haiku_pickle(path: str) -> dict:
    with open(path, "rb") as fd:
        return HaikuUnpickler(fd).load()


def load_cloob(name: str, path: Optional[str] = None, *, dtype=torch.float32, device="cuda",
               seed: int = 0, image: bool = True) -> CrowsonCLOOB:
    """A frozen crowsonkb CLOOB ViT: the haiku pickle at `path`, else random from
    `seed`. `image=False` builds the text tower alone."""
    if name not in CROWSON_CONFIGS:
        raise ValueError(f"unknown CLOOB model {name!r}")
    cfg = CROWSON_CONFIGS[name]
    module = CrowsonCLOOB(cfg, dtype=dtype, device=device, image=image)
    if path:
        sd = haiku_state_dict(read_haiku_pickle(path), cfg)
        keys = set(module.state_dict())
        module.load_state_dict({k: v for k, v in sd.items() if k in keys})
    else:
        log.warning("No weights for CLOOB %s — random init (smoke/bench only).", name)
        module.init_random_(torch.Generator(device=module.logit_scale.device).manual_seed(seed))
    return module.eval().requires_grad_(False)

"""The plain reference: the published models' forward passes in float32 with
TF32 off, written from the architectures' descriptions, over a state dict in
the published checkpoints' key names (OpenAI CLIP, mlp_mixer_pytorch, the
VitGAN generator of feed_forward_vqgan_clip, taming-transformers' VQGAN).

Every product goes through `Precision.q` (precision.py), so the same code
computes the control at a lower precision. No kernels, no caches, no fused or
folded layers: the upsample is taming's nearest-neighbour 2x then a 3x3
convolution, attention is a product, a softmax and a product.

`*_spec(cfg)` lists each tensor of a model by key with its shape and its
initial distribution; the harness draws the weights from them
(harness/weights.py) and hands the same tensors to the program and here.

A mapper family is a module of its own, `reference/mappers/<model_type>.py`
(the contract is in that package's docstring), found by the configuration's
`mapper.model_type` (`family`).
"""

import importlib
import re
from pathlib import Path

import torch
import torch.nn.functional as F

from perfbench.reference.precision import EXACT, Precision


# -- specs: key -> (shape, (kind, *args)) -------------------------------------

def _normal(std):
    return ("normal", float(std))


BIAS = _normal(0.02)


def _norm_pair(prefix, dim, spec):
    """A LayerNorm's or GroupNorm's scale near 1 and shift near 0."""
    spec[prefix + "weight"] = ((dim,), ("normal1", 0.02))
    spec[prefix + "bias"] = ((dim,), BIAS)


def _dense(prefix, dout, din, spec, bias=True, extra=()):
    spec[prefix + "weight"] = ((dout, din, *extra), _normal(din ** -0.5))
    if bias:
        spec[prefix + "bias"] = ((dout,), BIAS)


def clip_text_spec(c):
    """CLIP's text tower (OpenAI key names, at the top level)."""
    w, spec = c["text_width"], {}
    spec["token_embedding.weight"] = ((c["vocab_size"], w), _normal(0.02))
    spec["positional_embedding"] = ((c["context_length"], w), _normal(0.01))
    for i in range(c["text_layers"]):
        p = f"transformer.resblocks.{i}."
        _norm_pair(p + "ln_1.", w, spec)
        spec[p + "attn.in_proj_weight"] = ((3 * w, w), _normal(w ** -0.5))
        spec[p + "attn.in_proj_bias"] = ((3 * w,), BIAS)
        _dense(p + "attn.out_proj.", w, w, spec)
        _norm_pair(p + "ln_2.", w, spec)
        _dense(p + "mlp.c_fc.", 4 * w, w, spec)
        _dense(p + "mlp.c_proj.", w, 4 * w, spec)
    _norm_pair("ln_final.", w, spec)
    spec["text_projection"] = ((w, c["embed_dim"]), _normal(w ** -0.5))
    return spec


MAPPERS = Path(__file__).resolve().parent / "mappers"


def family(model_type: str):
    """The module of the mapper family `model_type`: reference/mappers/<model_type>.py."""
    path = MAPPERS / f"{model_type}.py"
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", model_type) or not path.is_file():
        raise ValueError(f"no reference for mapper family {model_type!r}: add {path} with "
                         "spec(m, clip_dim, channels) and forward(sd, x, m, channels, P)")
    return importlib.import_module(f"{__package__}.mappers.{model_type}")


def mapper_spec(m, clip_dim, channels):
    return family(m["model_type"]).spec(m, clip_dim, channels)


def _levels(v):
    """taming's Decoder layout: per level (index, block channels (in, out) list,
    attention?, upsample?), from the lowest resolution up."""
    ch, mult, nres = v["ch"], v["ch_mult"], v["num_res_blocks"]
    block_in = ch * mult[-1]
    res = v["resolution"] // 2 ** (len(mult) - 1)
    out = []
    for lev in reversed(range(len(mult))):
        blocks = []
        for _ in range(nres + 1):
            blocks.append((block_in, ch * mult[lev]))
            block_in = ch * mult[lev]
        out.append((lev, blocks, res in v["attn_resolutions"], lev != 0))
        if lev != 0:
            res *= 2
    return out, block_in


def vqgan_spec(v):
    """taming's VQModel decode path: codebook, post_quant_conv, decoder."""
    spec = {"quantize.embedding.weight": ((v["n_embed"], v["embed_dim"]), _normal(1.0))}
    zc = v["z_channels"]

    def conv(p, cout, cin, k):
        _dense(p, cout, cin * k * k, spec)
        spec[p + "weight"] = ((cout, cin, k, k), _normal((cin * k * k) ** -0.5))

    def resblock(p, cin, cout):
        _norm_pair(p + "norm1.", cin, spec)
        conv(p + "conv1.", cout, cin, 3)
        _norm_pair(p + "norm2.", cout, spec)
        conv(p + "conv2.", cout, cout, 3)
        if cin != cout:
            conv(p + "nin_shortcut.", cout, cin, 1)

    def attn(p, c):
        _norm_pair(p + "norm.", c, spec)
        for n in ("q", "k", "v", "proj_out"):
            conv(p + n + ".", c, c, 1)

    conv("post_quant_conv.", zc, v["embed_dim"], 1)
    top = v["ch"] * v["ch_mult"][-1]
    conv("decoder.conv_in.", top, zc, 3)
    resblock("decoder.mid.block_1.", top, top)
    attn("decoder.mid.attn_1.", top)
    resblock("decoder.mid.block_2.", top, top)
    levels, last = _levels(v)
    for lev, blocks, has_attn, has_up in levels:
        for i, (cin, cout) in enumerate(blocks):
            resblock(f"decoder.up.{lev}.block.{i}.", cin, cout)
            if has_attn:
                attn(f"decoder.up.{lev}.attn.{i}.", cout)
        if has_up:
            conv(f"decoder.up.{lev}.upsample.conv.", blocks[-1][1], blocks[-1][1], 3)
    _norm_pair("decoder.norm_out.", last, spec)
    conv("decoder.conv_out.", v["out_ch"], last, 3)
    return spec


# -- forward passes -------------------------------------------------------------

def linear(x, w, b, P: Precision):
    y = P.q(x) @ P.q(w).t()
    return y if b is None else y + b.float()


def conv2d(x, w, b, P: Precision, padding=0):
    return F.conv2d(P.q(x), P.q(w), b.float(), padding=padding)


def layer_norm(x, w, b, eps=1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def group_norm(x, w, b):
    c = x.shape[1]
    return F.group_norm(x, 32 if c % 32 == 0 else c, w.float(), b.float(), eps=1e-6)


def quick_gelu(h):
    return h * torch.sigmoid(1.702 * h)


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


def clip_act(cfg) -> str:
    """The CLIP towers' MLP activation, by OpenCLIP's naming rule on the
    configuration's `clip_model`: exact GELU for 'openclip/<arch>/<tag>' unless
    <arch> ends in -quickgelu; QuickGELU for those and for OpenAI's models."""
    name = cfg["clip_model"]
    if name.startswith("openclip/") and not name.split("/", 2)[1].endswith("-quickgelu"):
        return "gelu"
    return "quick_gelu"


def clip_text(sd, tokens, c, P: Precision = EXACT, *, act: str):
    """tokens int (B, 77) -> (B, embed_dim): causal pre-LN transformer with the
    activation `act` (`clip_act`), the EOT position (the highest id of each
    row) through ln_final and the projection."""
    act = ACTIVATIONS[act]
    with P.matmul_mode():
        w, heads = c["text_width"], c["text_heads"]
        x = sd["token_embedding.weight"][tokens].float() + sd["positional_embedding"].float()
        b, t, _ = x.shape
        mask = torch.full((t, t), float("-inf"), device=x.device).triu(1)
        dh = w // heads
        for i in range(c["text_layers"]):
            p = f"transformer.resblocks.{i}."
            h = layer_norm(x, sd[p + "ln_1.weight"], sd[p + "ln_1.bias"])
            qkv = linear(h, sd[p + "attn.in_proj_weight"], sd[p + "attn.in_proj_bias"], P)
            q, k, v = (z.reshape(b, t, heads, dh).transpose(1, 2) for z in qkv.chunk(3, -1))
            att = torch.softmax(P.q(q) @ P.q(k).transpose(-1, -2) * dh ** -0.5 + mask, -1)
            o = (P.q(att) @ P.q(v)).transpose(1, 2).reshape(b, t, w)
            x = x + linear(o, sd[p + "attn.out_proj.weight"], sd[p + "attn.out_proj.bias"], P)
            h = layer_norm(x, sd[p + "ln_2.weight"], sd[p + "ln_2.bias"])
            h = linear(h, sd[p + "mlp.c_fc.weight"], sd[p + "mlp.c_fc.bias"], P)
            h = act(h)
            x = x + linear(h, sd[p + "mlp.c_proj.weight"], sd[p + "mlp.c_proj.bias"], P)
        x = layer_norm(x, sd["ln_final.weight"], sd["ln_final.bias"])
        pooled = x[torch.arange(b, device=x.device), tokens.argmax(-1)]
        return P.q(pooled) @ P.q(sd["text_projection"])


def mapper(sd, x, m, channels, P: Precision = EXACT):
    return family(m["model_type"]).forward(sd, x, m, channels, P)


def codebook_indices(z, codebook, P: Precision = EXACT, rows: int = 4096):
    """argmin_k |z - c_k|^2 over the last axis of z (..., C), first minimum, in
    blocks of `rows` vectors."""
    flat = z.reshape(-1, z.shape[-1]).float()
    cb = codebook.float()
    c2 = cb.square().sum(-1)
    out = []
    with P.matmul_mode():
        for i in range(0, len(flat), rows):
            x = flat[i:i + rows]
            d = x.square().sum(-1, keepdim=True) + c2 - 2.0 * (P.q(x) @ P.q(cb).t())
            out.append(d.argmin(-1))
    return torch.cat(out).reshape(z.shape[:-1])


def vqgan_decode(sd, zq, v, P: Precision = EXACT):
    """Quantized latents (B, S, S, embed_dim) NHWC -> the decoder's output
    (B, 16S, 16S, out_ch) NHWC, before (x + 1) / 2."""
    with P.matmul_mode():
        def conv(p, x, pad):
            return conv2d(x, sd[p + "weight"], sd[p + "bias"], P, pad)

        def norm(p, x):
            return F.silu(group_norm(x, sd[p + "weight"], sd[p + "bias"]))

        def resblock(p, x):
            h = conv(p + "conv1.", norm(p + "norm1.", x), 1)
            h = conv(p + "conv2.", norm(p + "norm2.", h), 1)
            if p + "nin_shortcut.weight" in sd:
                x = conv(p + "nin_shortcut.", x, 0)
            return x + h

        def attn(p, x):
            b, c, hh, ww = x.shape
            hn = group_norm(x, sd[p + "norm.weight"], sd[p + "norm.bias"])
            q = conv(p + "q.", hn, 0).reshape(b, c, hh * ww).transpose(1, 2)
            k = conv(p + "k.", hn, 0).reshape(b, c, hh * ww)
            val = conv(p + "v.", hn, 0).reshape(b, c, hh * ww).transpose(1, 2)
            a = torch.softmax(P.q(q) @ P.q(k) * c ** -0.5, -1)
            o = (P.q(a) @ P.q(val)).transpose(1, 2).reshape(b, c, hh, ww)
            return x + conv(p + "proj_out.", o, 0)

        h = conv("post_quant_conv.", zq.permute(0, 3, 1, 2).float(), 0)
        h = conv("decoder.conv_in.", h, 1)
        h = resblock("decoder.mid.block_1.", h)
        h = attn("decoder.mid.attn_1.", h)
        h = resblock("decoder.mid.block_2.", h)
        levels, _ = _levels(v)
        for lev, blocks, has_attn, has_up in levels:
            for i in range(len(blocks)):
                h = resblock(f"decoder.up.{lev}.block.{i}.", h)
                if has_attn:
                    h = attn(f"decoder.up.{lev}.attn.{i}.", h)
            if has_up:
                h = conv(f"decoder.up.{lev}.upsample.conv.",
                         F.interpolate(h, scale_factor=2.0, mode="nearest"), 1)
        h = F.silu(group_norm(h, sd["decoder.norm_out.weight"], sd["decoder.norm_out.bias"]))
        return conv("decoder.conv_out.", h, 1).permute(0, 2, 3, 1)


def rel_l2(a, b):
    """||a - b|| / ||b|| of each row (leading axis) -> float32 (B,)."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    return (a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-30)


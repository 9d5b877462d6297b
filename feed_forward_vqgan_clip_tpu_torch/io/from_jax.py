"""JAX parameter pytrees -> state dicts of the port's modules.

The inverse of the JAX package's torch converters (io/torch_import.py) for the
modules of the served path: the MLP-Mixer mapper, the VQGAN decoder and the CLIP
text tower. Parity tests use these to run the JAX module and its port on the
same weights. Inputs are the pytrees as the JAX modules' `init` returns them
(with or without the top-level 'params'), leaves as numpy arrays (or anything
np.asarray takes). Layouts:

  * Dense kernel (in, out)      -> Linear weight (out, in)
  * conv kernel HWIO            -> Conv2d weight OIHW
  * token t1 (T, Et), t2 (Et, T) -> Conv1d weight (Et, T, 1), (T, Et, 1)
  * norm {scale, bias}          -> {weight, bias}
"""

import re

import numpy as np
import torch


def _params(tree):
    return tree["params"] if "params" in tree else tree


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _norm(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def mixer_state_dict(tree):
    """models.mappers.mixer.Mixer params -> the port's Mixer state dict."""
    p = _params(tree)
    depth = sum(1 for k in p if k.startswith("block_"))
    sd = {}
    _linear(sd, "proj", p["proj"])
    _linear(sd, "mixer.1", p["embed"])
    for i in range(depth):
        b, pre = p[f"block_{i}"], f"mixer.{2 + i}"
        _norm(sd, f"{pre}.0.norm", b["token_norm"])
        sd[f"{pre}.0.fn.0.weight"] = _t(np.asarray(b["token_fc1"]).T[:, :, None])
        sd[f"{pre}.0.fn.0.bias"] = _t(b["token_fc1_bias"])
        sd[f"{pre}.0.fn.3.weight"] = _t(np.asarray(b["token_fc2"]).T[:, :, None])
        sd[f"{pre}.0.fn.3.bias"] = _t(b["token_fc2_bias"])
        _norm(sd, f"{pre}.1.norm", b["channel_norm"])
        _linear(sd, f"{pre}.1.fn.0", b["channel_fc1"])
        _linear(sd, f"{pre}.1.fn.3", b["channel_fc2"])
    _norm(sd, f"mixer.{2 + depth}", p["final_norm"])
    _linear(sd, "final_proj", p["final_proj"])
    return sd


def _resnet_block(sd, prefix, p):
    for name in ("norm1", "norm2"):
        _norm(sd, f"{prefix}.{name}", p[name])
    for name in ("conv1", "conv2", "nin_shortcut"):
        if name in p:
            _conv(sd, f"{prefix}.{name}", p[name])


def _attn_block(sd, prefix, p):
    _norm(sd, f"{prefix}.norm", p["norm"])
    for name in ("q", "k", "v", "proj_out"):
        _conv(sd, f"{prefix}.{name}", p[name])


def vqgan_state_dict(tree):
    """models.vqgan.VQGAN params -> the port's VQGAN state dict (taming names)."""
    p = _params(tree)
    dec = p["decoder"]
    sd = {"quantize.embedding.weight": _t(p["codebook"])}
    _conv(sd, "post_quant_conv", p["post_quant_conv"])
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    _resnet_block(sd, "decoder.mid.block_1", dec["mid_block_1"])
    _attn_block(sd, "decoder.mid.attn_1", dec["mid_attn_1"])
    _resnet_block(sd, "decoder.mid.block_2", dec["mid_block_2"])
    for name, sub in dec.items():
        m = re.fullmatch(r"up_(\d+)_(block|attn)_(\d+)", name)
        if m:
            level, kind, i = m.groups()
            fn = _resnet_block if kind == "block" else _attn_block
            fn(sd, f"decoder.up.{level}.{kind}.{i}", sub)
        m = re.fullmatch(r"up_(\d+)_upsample", name)
        if m:
            _conv(sd, f"decoder.up.{m.group(1)}.upsample.conv", sub["conv"])
    _norm(sd, "decoder.norm_out", dec["norm_out"])
    _conv(sd, "decoder.conv_out", dec["conv_out"])
    return sd


def clip_text_state_dict(tree):
    """models.clip_vit.CLIP params -> the port's TextTransformer state dict
    (OpenAI CLIP names)."""
    p = _params(tree)
    text = p["text"] if "text" in p else p
    sd = {
        "token_embedding.weight": _t(text["token_embedding"]),
        "positional_embedding": _t(text["positional_embedding"]),
        "text_projection": _t(text["text_projection"]),
    }
    _norm(sd, "ln_final", text["ln_final"]["LayerNorm_0"])
    for name, blk in text["transformer"].items():
        i = int(name.split("_")[1])
        pre = f"transformer.resblocks.{i}"
        _norm(sd, f"{pre}.ln_1", blk["ln_1"]["LayerNorm_0"])
        _norm(sd, f"{pre}.ln_2", blk["ln_2"]["LayerNorm_0"])
        attn = blk["attn"]
        sd[f"{pre}.attn.in_proj_weight"] = _t(
            np.concatenate([np.asarray(attn[n]["kernel"]).T for n in ("q", "k", "v")])
        )
        sd[f"{pre}.attn.in_proj_bias"] = _t(
            np.concatenate([np.asarray(attn[n]["bias"]) for n in ("q", "k", "v")])
        )
        _linear(sd, f"{pre}.attn.out_proj", attn["out"])
        _linear(sd, f"{pre}.mlp.c_fc", blk["c_fc"])
        _linear(sd, f"{pre}.mlp.c_proj", blk["c_proj"])
    return sd

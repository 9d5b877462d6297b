"""JAX parameter pytrees -> state dicts of the port's modules.

The inverse of the JAX package's torch converters (io/torch_import.py) for the
mappers (MLP-Mixer, the VitGAN generators and their SineLayer and
Discriminator, the x-transformer; `mapper_state_dict` by model_type), the VQGAN
decoder, the CLIP towers (ViT and ModifiedResNet), crowsonkb's CLOOB ViT, the
Inception trunks and NIMA, and the flow prior (whose variables hold 'buffers'
beside 'params'). Parity tests use these to run the JAX module and its port on
the same weights, and the loaders of the JAX package's checkpoint directories
(io/checkpoint.py, models/vqgan.py, models/perceptor.py, models/flow.py) read
its trees through them; `mixer_tree` goes the other way, for writing such a
directory. Inputs are the pytrees as the JAX modules' `init` returns them (with
or without the top-level 'params'), leaves as numpy arrays (`numpy_leaves`
turns msgpack's bfloat16 tensors into them). Layouts:

  * Dense kernel (in, out)      -> Linear weight (out, in)
  * conv kernel HWIO            -> Conv2d weight OIHW
  * token t1 (T, Et), t2 (Et, T) -> Conv1d weight (Et, T, 1), (T, Et, 1)
  * norm {scale, bias}          -> {weight, bias}
"""

import re

import numpy as np
import torch

from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import StackedMixerWeights


def _params(tree):
    return tree["params"] if "params" in tree else tree


def numpy_leaves(tree):
    """`tree` with its torch tensor leaves (msgpack's bfloat16 arrays) as float32
    numpy arrays: exact, bf16 widens to f32 without rounding."""
    if isinstance(tree, dict):
        return {k: numpy_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return tree


def mapper_state_dict(tree, cfg):
    """A JAX mapper's parameter tree -> the port's state dict, by the config's
    `model_type` (the JAX package's `convert_mapper_state_dict`, inverted)."""
    mt = cfg.get("model_type")
    if mt == "mlp_mixer":
        return mixer_state_dict(tree)
    if mt in ("vitgan", "simple_vitgan"):
        return vitgan_generator_state_dict(tree)
    if mt == "xtransformer":
        return xtransformer_state_dict(tree, add_input=bool(cfg.get("add_input", False)))
    raise NotImplementedError(f"no converter for model_type={mt!r}")


def migrate_groupnorm_layout(tree):
    """The older nested {'GroupNorm_0': {scale, bias}} GroupNorm layout of the
    JAX package's VQGAN directories flattened to {scale, bias} (JAX
    train/loop.py `_migrate_groupnorm_layout`)."""
    if isinstance(tree, dict):
        if set(tree) == {"GroupNorm_0"}:
            return dict(tree["GroupNorm_0"])
        return {k: migrate_groupnorm_layout(v) for k, v in tree.items()}
    return tree


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
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


def _sorted(tree):
    """Dicts in sorted key order, as jax.tree.map leaves them in a saved tree."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def mixer_tree(sd):
    """The port's Mixer state dict -> the JAX Mixer's {"params": ...} tree, float32
    numpy leaves, keys sorted: the inverse of mixer_state_dict, for writing a
    JAX checkpoint directory without JAX."""
    a = {k: v.detach().float().cpu().numpy() for k, v in sd.items()}
    depth = sum(1 for k in a if k.endswith(".0.fn.0.weight"))

    def dense(prefix):
        return {"kernel": np.ascontiguousarray(a[f"{prefix}.weight"].T),
                "bias": a[f"{prefix}.bias"]}

    def norm(prefix):
        return {"scale": a[f"{prefix}.weight"], "bias": a[f"{prefix}.bias"]}

    p = {"proj": dense("proj"), "embed": dense("mixer.1"),
         "final_norm": norm(f"mixer.{2 + depth}"), "final_proj": dense("final_proj")}
    for i in range(depth):
        pre = f"mixer.{2 + i}"
        p[f"block_{i}"] = {
            "token_norm": norm(f"{pre}.0.norm"),
            "token_fc1": np.ascontiguousarray(a[f"{pre}.0.fn.0.weight"][:, :, 0].T),
            "token_fc1_bias": a[f"{pre}.0.fn.0.bias"],
            "token_fc2": np.ascontiguousarray(a[f"{pre}.0.fn.3.weight"][:, :, 0].T),
            "token_fc2_bias": a[f"{pre}.0.fn.3.bias"],
            "channel_norm": norm(f"{pre}.1.norm"),
            "channel_fc1": dense(f"{pre}.1.fn.0"), "channel_fc2": dense(f"{pre}.1.fn.3"),
        }
    return _sorted({"params": p})


def stacked_mixer_weights(sp, dtype=torch.float32):
    """The JAX package's `stack_mixer_params` dict -> the port's
    StackedMixerWeights: matrices moved to torch's (out, in) layouts in `dtype`
    (the values as they are: bf16 arrays arrive exactly), norms and biases
    float32 with their singleton axes dropped."""
    def a(name):
        return np.asarray(sp[name], dtype=np.float32)

    def mat(name):  # (L, in, out) -> (L, out, in)
        return _t(np.swapaxes(a(name), 1, 2)).to(dtype).contiguous()

    def vec(name):
        v = a(name)
        return _t(v.reshape(v.shape[0], -1))

    return StackedMixerWeights(
        ln1_w=vec("ln1s"), ln1_b=vec("ln1b"), t1=mat("t1"), t1b=vec("t1b"), t2=mat("t2"),
        t2b=vec("t2b"), w1f=mat("w1f"), b1f=vec("b1f"), w2=mat("w2"), b2=vec("b2"),
    )


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


def _clip_resblocks(sd, prefix, blocks):
    for name, blk in blocks.items():
        pre = f"{prefix}transformer.resblocks.{int(name.split('_')[1])}"
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
    _clip_resblocks(sd, "", text["transformer"])
    return sd


def clip_image_state_dict(tree):
    """models.clip_vit.CLIP params -> the port's image-tower entries (`visual.*`,
    OpenAI CLIP names). The JAX patch kernel (p, p, 3, width) HWIO becomes the
    Conv2d weight (width, 3, p, p)."""
    vis = _params(tree)["visual"]
    sd = {
        "visual.conv1.weight": _t(np.transpose(np.asarray(vis["conv1"]["kernel"]), (3, 2, 0, 1))),
        "visual.class_embedding": _t(vis["class_embedding"]),
        "visual.positional_embedding": _t(vis["positional_embedding"]),
        "visual.proj": _t(vis["proj"]),
    }
    _norm(sd, "visual.ln_pre", vis["ln_pre"]["LayerNorm_0"])
    _norm(sd, "visual.ln_post", vis["ln_post"]["LayerNorm_0"])
    _clip_resblocks(sd, "visual.", vis["transformer"])
    return sd


def clip_state_dict(tree):
    """models.clip_vit.CLIP params (both towers) -> the port's CLIP state dict."""
    sd = {**clip_text_state_dict(tree), **clip_image_state_dict(tree)}
    sd["logit_scale"] = _t(_params(tree)["logit_scale"]).reshape(())
    return sd


def _depth(p):
    return sum(1 for k in p if k.startswith("block_"))


def _sln(sd, prefix, p):
    sd[f"{prefix}.gamma"] = _t(p["gamma"])
    sd[f"{prefix}.beta"] = _t(p["beta"])
    _norm(sd, f"{prefix}.ln", p["ln"])


def _vitgan_mlp(sd, prefix, p):
    _linear(sd, f"{prefix}.linear1", p["linear1"])
    _linear(sd, f"{prefix}.linear2", p["linear2"])


def vitgan_generator_state_dict(tree):
    """models.mappers.vitgan.Generator or SimpleGenerator params -> the port's
    state dict (the reference's names)."""
    p = _params(tree)
    sd = {"pos_emb1D": _t(p["pos_emb1D"])}
    _linear(sd, "mlp", p["mlp"])
    if "inp" in p:  # SimpleGenerator
        _linear(sd, "inp", p["inp"])
    for i in range(_depth(p)):
        b, pre = p[f"block_{i}"], f"Transformer_Encoder.blocks.{i}"
        _sln(sd, f"{pre}.norm1", b["norm1"])
        _sln(sd, f"{pre}.norm2", b["norm2"])
        _linear(sd, f"{pre}.attn.to_qkv", b["attn"]["to_qkv"])
        _linear(sd, f"{pre}.attn.w_out", b["attn"]["w_out"])
        _vitgan_mlp(sd, f"{pre}.mlp", b["mlp"])
    _sln(sd, "sln_norm", p["sln_norm"])
    _linear(sd, "w_out.0", p["w_out"])
    return sd


def vitgan_discriminator_state_dict(tree):
    """models.mappers.vitgan.Discriminator params -> the port's state dict. Each
    attention's `init_spect_norm` is no key: the port sets it from the weight
    loaded (`init_discriminator_spectral_norms`), as the JAX converter does."""
    p = _params(tree)
    sd = {"cls_token": _t(p["cls_token"]), "pos_emb1D": _t(p["pos_emb1D"])}
    _linear(sd, "project_patches", p["project_patches"])
    for i in range(_depth(p)):
        b, pre = p[f"block_{i}"], f"Transformer_Encoder.blocks.{i}"
        _norm(sd, f"{pre}.norm1", b["norm1"])
        _norm(sd, f"{pre}.norm2", b["norm2"])
        sd[f"{pre}.attn.to_qkv.weight"] = _t(np.asarray(b["attn"]["to_qkv_kernel"]).T)
        _linear(sd, f"{pre}.attn.w_out", b["attn"]["w_out"])
        _vitgan_mlp(sd, f"{pre}.mlp", b["mlp"])
    _norm(sd, "mlp_head.0", p["head_norm"])
    _linear(sd, "mlp_head.1", p["head"])
    return sd


def sine_layer_state_dict(tree):
    """models.mappers.vitgan.SineLayer params -> the port's state dict."""
    sd = {}
    _linear(sd, "linear", _params(tree)["linear"])
    return sd


def xtransformer_state_dict(tree, *, add_input=False):
    """models.mappers.xtransformer.XTransformer params -> the port's state dict
    (x-transformers 0.19.1 names). With `proj` (initial_proj) and not
    `add_input` the reference's position table has one more row than the JAX
    module's, which no forward reads: it is added as zeros."""
    p, t = _params(tree), "transformer"
    sd = {}
    if "proj" in p:
        _linear(sd, "proj", p["proj"])
    _linear(sd, f"{t}.project_in", p["project_in"])
    pos = np.asarray(p["pos_emb"], np.float32)
    if "proj" in p and not add_input:
        pos = np.concatenate([pos, np.zeros_like(pos[:1])])
    sd[f"{t}.pos_emb.emb.weight"] = _t(pos)
    for i in range(_depth(p)):
        b = p[f"block_{i}"]
        a, f = f"{t}.attn_layers.layers.{2 * i}", f"{t}.attn_layers.layers.{2 * i + 1}"
        _norm(sd, f"{a}.0", b["ln_attn"]["LayerNorm_0"])
        for name in ("to_q", "to_k", "to_v", "to_out"):
            _linear(sd, f"{a}.1.{name}", b["attn"][name])
        _norm(sd, f"{f}.0", b["ln_ff"]["LayerNorm_0"])
        _linear(sd, f"{f}.1.net.0.0", b["ff1"])
        _linear(sd, f"{f}.1.net.2", b["ff2"])
    _norm(sd, f"{t}.norm", p["final_norm"]["LayerNorm_0"])
    _linear(sd, f"{t}.project_out", p["project_out"])
    return sd


def _frozen_bn(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])
    sd[f"{prefix}.running_mean"] = _t(p["mean"])
    sd[f"{prefix}.running_var"] = _t(p["var"])


def clip_resnet_state_dict(tree):
    """models.clip_resnet.CLIPResNet params (both towers) -> the port's
    CLIPResNet state dict (OpenAI CLIP RN names)."""
    p = _params(tree)
    vis = p["visual"]
    sd = clip_text_state_dict(tree)
    for i in (1, 2, 3):
        _conv(sd, f"visual.conv{i}", vis[f"conv{i}"])
        _frozen_bn(sd, f"visual.bn{i}", vis[f"bn{i}"])
    for name, sub in vis.items():
        m = re.fullmatch(r"layer(\d)_(\d+)", name)
        if m:
            pre = f"visual.layer{m.group(1)}.{m.group(2)}"
            for i in (1, 2, 3):
                _conv(sd, f"{pre}.conv{i}", sub[f"conv{i}"])
                _frozen_bn(sd, f"{pre}.bn{i}", sub[f"bn{i}"])
            if "downsample_conv" in sub:
                _conv(sd, f"{pre}.downsample.0", sub["downsample_conv"])
                _frozen_bn(sd, f"{pre}.downsample.1", sub["downsample_bn"])
    pool = vis["attnpool"]
    sd["visual.attnpool.positional_embedding"] = _t(pool["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _linear(sd, f"visual.attnpool.{name}", pool[name])
    sd["logit_scale"] = _t(p["logit_scale"]).reshape(())
    return sd


def _basic_fc(sd, prefix, p):
    """BasicFC {fc_in, fc_0 .. fc_{depth-1}, fc_out} -> net2net's `main.N`."""
    depth = sum(1 for k in p if re.fullmatch(r"fc_\d+", k))
    _linear(sd, f"{prefix}.main.0", p["fc_in"])
    for i in range(depth):
        _linear(sd, f"{prefix}.main.{2 * (i + 1)}", p[f"fc_{i}"])
    _linear(sd, f"{prefix}.main.{2 * (depth + 1)}", p["fc_out"])


def flow_state_dict(variables):
    """models.flow.ConditionalFlatCouplingFlow variables ({params, buffers}) ->
    the port's flow state dict (net2net names), the inverse of convert_flow."""
    p, buffers = variables["params"], variables["buffers"]
    sd = {}
    _basic_fc(sd, "embedder", p["embedder"])
    n_flows = sum(1 for k in p if k.startswith("flow_"))
    for i in range(n_flows):
        blk, pre = p[f"flow_{i}"], f"sub_layers.{i}"
        sd[f"{pre}.norm_layer.loc"] = _t(blk["norm"]["loc"]).reshape(1, -1, 1, 1)
        sd[f"{pre}.norm_layer.scale"] = _t(blk["norm"]["scale"]).reshape(1, -1, 1, 1)
        sd[f"{pre}.norm_layer.initialized"] = torch.tensor(1, dtype=torch.uint8)
        for j in range(2):
            _basic_fc(sd, f"{pre}.coupling.s.{j}", blk["coupling"][f"s_{j}"])
            _basic_fc(sd, f"{pre}.coupling.t.{j}", blk["coupling"][f"t_{j}"])
        perm = torch.from_numpy(np.asarray(buffers[f"flow_{i}"]["shuffle"]).astype(np.int64))
        sd[f"{pre}.shuffle.forward_shuffle_idx"] = perm
        sd[f"{pre}.shuffle.backward_shuffle_idx"] = torch.argsort(perm)
    return sd


def _cloob_tower(sd, prefix, p):
    n = sum(1 for k in p if k.startswith("layer_"))
    for i in range(n):
        blk, pre = p[f"layer_{i}"], f"{prefix}.layers.{i}"
        _norm(sd, f"{pre}.attn_norm", blk["attn_norm"])
        _norm(sd, f"{pre}.ff_norm", blk["ff_norm"])
        for name in ("query", "key", "value", "out", "linear_0", "linear_1"):
            _linear(sd, f"{pre}.{name}", blk[name])
    sd[f"{prefix}.pos_embed"] = _t(p["pos_embed"])
    _linear(sd, f"{prefix}.proj", p["proj"])


def crowson_cloob_state_dict(tree):
    """models.cloob.CrowsonCLOOB params -> the port's CrowsonCLOOB state dict."""
    p = _params(tree)
    img, txt = p["image_encoder"], p["text_encoder"]
    sd = {"image_encoder.class_embed": _t(img["class_embed"]),
          "text_encoder.embed.weight": _t(txt["embed"]),
          "logit_scale": _t(p["logit_scale"]).reshape(())}
    _conv(sd, "image_encoder.embed", img["embed"])
    _cloob_tower(sd, "image_encoder", img)
    _cloob_tower(sd, "text_encoder", txt)
    return sd


def _inception_path(name):
    """A JAX Inception module name -> its torch path: `repeat_1_3` -> `repeat_1.3`,
    `repeat_4` -> `repeat.4`, `branch1_0` -> `branch1.0` (Cadene's Sequentials);
    torchvision's names (`Mixed_5b`, `branch3x3dbl_1`) unchanged."""
    m = re.fullmatch(r"(repeat(?:_[12])?|branch\d)_(\d+)", name)
    return f"{m.group(1)}.{m.group(2)}" if m else name


def inception_state_dict(tree):
    """models.inception.InceptionV3Features or models.inception_resnet.
    InceptionResNetV2Features params -> the port's trunk state dict (torchvision's
    or Cadene's names): each BasicConv2d's {conv, bn}, the residual blocks'
    biased `conv2d`."""
    sd = {}

    def walk(prefix, node):
        for name, sub in node.items():
            path = f"{prefix}{_inception_path(name)}"
            if name == "conv2d":
                _conv(sd, path, sub)
            elif "conv" in sub and "bn" in sub:
                _conv(sd, f"{path}.conv", sub["conv"])
                _frozen_bn(sd, f"{path}.bn", sub["bn"])
            else:
                walk(f"{path}.", sub)

    walk("", _params(tree))
    return sd


def nima_state_dict(tree):
    """models.nima.NIMA params (either trunk) -> the port's NIMA state dict."""
    p = _params(tree)
    sd = {f"backbone.{k}": v for k, v in inception_state_dict(p["backbone"]).items()}
    _linear(sd, "classifier", p["classifier"])
    return sd

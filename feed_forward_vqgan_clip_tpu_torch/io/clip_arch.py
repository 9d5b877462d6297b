"""CLIP checkpoint layouts and architectures read from a state dict's shapes.

The port's copy of feed_forward_vqgan_clip_tpu/io/torch_import.py
`_normalize_openclip_naming` and `sniff_clip_arch`. The reference hands any
`openclip/<arch>/<tag>` name to open_clip, which knows every arch by name;
here, for an arch outside the registry, the checkpoint itself carries the
architecture: the shape arithmetic OpenAI CLIP's `build_model` applies to tell
a ViT from a ModifiedResNet and recover its widths, layers and heads. Values
may be torch tensors or numpy arrays (only `.shape` is read).
"""

from typing import Dict, Tuple

PREFIXES = ("module.", "_orig_mod.", "model.")


def normalize_openclip_naming(sd: Dict) -> Dict:
    """OpenAI CLIP's key names from the OpenCLIP layouts: a DDP / torch.compile /
    export prefix (`module.`, `_orig_mod.`, `model.`) stripped when no key is at
    the top level yet; a CustomTextCLIP's text tower nested under `text.`
    (text.token_embedding, text.transformer.*, text.ln_final, ...) moved to the
    top level, where `token_embedding.weight` is not already."""
    for prefix in PREFIXES:
        if any(k.startswith(prefix) for k in sd) and not any(
                k.startswith("visual.") or k == "logit_scale" for k in sd):
            sd = {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}
    if any(k.startswith("text.") for k in sd) and "token_embedding.weight" not in sd:
        sd = {(k[len("text."):] if k.startswith("text.") else k): v for k, v in sd.items()}
    return sd


def _indices(sd, prefix: str, at: int) -> int:
    return len({k.split(".")[at] for k in sd if k.startswith(prefix)})


def sniff_clip_arch(sd: Dict) -> Tuple[str, dict]:
    """("vit" | "resnet", config) of a CLIP-layout state dict, the config in the
    CLIP_VIT_CONFIGS / CLIP_RESNET_CONFIGS schema. Heads are width // 64 (every
    released CLIP tower's head width), at least 1."""
    sd = normalize_openclip_naming(dict(sd))
    text = dict(
        embed_dim=int(sd["text_projection"].shape[1]),
        text_width=int(sd["ln_final.weight"].shape[0]),
        text_layers=_indices(sd, "transformer.resblocks.", 2),
        vocab_size=int(sd["token_embedding.weight"].shape[0]),
        context_length=int(sd["positional_embedding"].shape[0]),
    )
    text["text_heads"] = max(1, text["text_width"] // 64)
    if "visual.conv1.weight" in sd and "visual.class_embedding" in sd:  # ViT tower
        width = int(sd["visual.conv1.weight"].shape[0])
        patch = int(sd["visual.conv1.weight"].shape[-1])
        grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
        return "vit", dict(
            image_size=patch * grid, patch_size=patch, vision_width=width,
            vision_layers=_indices(sd, "visual.transformer.resblocks.", 3),
            vision_heads=max(1, width // 64), **text)
    if any(k.startswith("visual.layer1.") for k in sd):  # ModifiedResNet tower
        counts = tuple(_indices(sd, f"visual.layer{b}.", 2) for b in (1, 2, 3, 4))
        width = int(sd["visual.layer1.0.conv1.weight"].shape[0])
        out_grid = int(round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5))
        return "resnet", dict(image_size=out_grid * 32, vision_layers=counts,
                              vision_width=width, **text)
    raise ValueError(
        "state dict is neither a CLIP ViT (visual.conv1 + class_embedding) nor a "
        "ModifiedResNet (visual.layer1..4) checkpoint")

"""The system under test, built through the port's own constructors and
loaders from the benchmark's weights (harness/weights.py).

This module and the traffic generators are the harness's only importers of
`feed_forward_vqgan_clip_tpu_torch`; reference/ imports nothing of it.
"""

import torch

PORT = "feed_forward_vqgan_clip_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "feed_forward_vqgan_clip_tpu")

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def forbidden_modules(modules) -> list:
    """The names in `modules` whose top-level name (before the first dot) is
    JAX's, its libraries' or the JAX package's, compared whole."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def mapper_config(cfg) -> dict:
    """The port's config keys for the configuration's mapper: every key of its
    `mapper` object, with the CLIP model's name, the compute dtype and no dropout."""
    return dict(cfg["mapper"], clip_model=cfg["clip_model"], compute_dtype=cfg["compute_dtype"],
                dropout=0.0)


def load_kernels(device):
    """Build (first run in a checkout) or load the port's kernel library."""
    if device.type == "cuda":
        from feed_forward_vqgan_clip_tpu_torch.ops.kernels import build

        build.load_library()


def clip_act(cfg) -> str:
    """The activation the port gives the configuration's CLIP model by its name
    (`models/clip_vit.make_clip`'s rule)."""
    from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import parse_openclip

    name = cfg["clip_model"]
    return parse_openclip(name)[1] if name.startswith("openclip/") else "quick_gelu"


def text_perceptor(cfg, sd, device):
    """The port's text tower (`models/clip_vit`) holding `sd`, as a Perceptor."""
    from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip_from_config
    from feed_forward_vqgan_clip_tpu_torch.models.perceptor import Perceptor

    dtype = DTYPES[cfg["compute_dtype"]]
    module = make_clip_from_config(cfg["clip"], act=clip_act(cfg), dtype=dtype, device=device,
                                   image=False)
    module.load_state_dict(sd)
    module.eval().requires_grad_(False)
    return Perceptor(module=module, name=cfg["clip_model"], size=cfg["clip"]["image_size"],
                     dim=cfg["clip"]["embed_dim"])


def vqgan(cfg, sd, device):
    from feed_forward_vqgan_clip_tpu_torch.models.vqgan import make_vqgan

    vq = make_vqgan(cfg["vqgan"], dtype=DTYPES[cfg["compute_dtype"]], device=device)
    vq.load_state_dict(sd)
    return vq.eval().requires_grad_(False)


def mapper(cfg, sd, device):
    from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper

    m = build_mapper(mapper_config(cfg), vq_channels=cfg["vqgan"]["embed_dim"],
                     dtype=DTYPES[cfg["compute_dtype"]], device=device)
    m.load_state_dict(sd)
    return m


def generator(cfg, clip_sd, vq_sd, map_sd, device):
    """`infer.Generator`, the object `entry.entry` serves prompts -> images with,
    over the benchmark's weights."""
    from feed_forward_vqgan_clip_tpu_torch.infer import Generator

    return Generator(text_perceptor(cfg, clip_sd, device), mapper(cfg, map_sd, device),
                     vqgan(cfg, vq_sd, device), noise_dim=cfg["mapper"]["noise_dim"])

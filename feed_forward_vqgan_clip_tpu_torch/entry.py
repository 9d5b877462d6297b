"""The port's counterpart of `__graft_entry__.entry`: the flagship prompt->image
step (CLIP ViT-B/32 text encode -> MLP-Mixer 32x1024 mapper -> clamp ->
straight-through VQ -> VQGAN f16-16384 decode -> [0, 1] image) with random
weights from a seed, in bf16, on one device.
"""

import torch

from feed_forward_vqgan_clip_tpu_torch.infer import build_generator

SOT, EOT = 49406, 49407  # CLIP's start/end-of-text ids


def example_tokens(batch: int, device=None):
    """`[SOT, 320, EOT, 0, ...]` per row: the token ids `__graft_entry__` feeds."""
    tokens = torch.zeros(batch, 77, dtype=torch.long, device=device)
    tokens[:, 0], tokens[:, 1], tokens[:, 2] = SOT, 320, EOT
    return tokens


def entry(device="cuda", *, batch: int = 4, dtype=torch.bfloat16, seed: int = 0):
    """-> (prompt_to_image, (tokens,)): prompt_to_image(tokens) gives images
    (B, 256, 256, 3) float32 in [0, 1]."""
    gen = build_generator(dtype=dtype, device=device, seed=seed)

    def prompt_to_image(tokens):
        return gen.render(gen.encode_tokens(tokens))

    return prompt_to_image, (example_tokens(batch, device),)

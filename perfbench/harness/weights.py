"""Seeded weights, drawn on the device in a few large calls.

Every model's tensors (reference/models.py `*_spec`) come out of one float32
normal draw from a `torch.Generator` seeded with the run's seed and a number
for the model: one `randn` over all the model's elements, sliced, scaled by
each tensor's standard deviation and shifted by its mean. The program and the
reference are given the same tensors.
"""

import math

import torch


def draw(spec: dict, seed: int, stream: int, device) -> dict:
    """{key: float32 tensor} for `spec` ({key: (shape, (kind, std))}, kind
    "normal" around 0 or "normal1" around 1), from generator seed (seed, stream)."""
    gen = torch.Generator(device=device).manual_seed(mix(seed, stream))
    total = sum(math.prod(shape) for shape, _ in spec.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for key, (shape, (kind, std)) in spec.items():
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        t.mul_(std)
        if kind == "normal1":
            t.add_(1.0)
        out[key] = t
    return out


def mix(seed: int, stream: int) -> int:
    """A 63-bit generator seed from the run's seed (any size) and a stream number."""
    return (int(seed) * 1_000_003 + int(stream) * 7_919) % (2 ** 63 - 1)

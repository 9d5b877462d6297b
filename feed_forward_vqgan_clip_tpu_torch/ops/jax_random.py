"""JAX's default random draws, reproduced in numpy: `jax.random.uniform` and
`jax.random.normal` of a `PRNGKey(seed)`, float32.

The threefry2x32 counter hash (20 rounds, Salmon et al. 2011, as
jax._src.prng implements it) over the flat element index split into two 32-bit
words (JAX's partitionable bit layout, its default), the two output words
XOR-ed into 32 random bits; the uniform keeps the top 23 bits as the mantissa of
a float in [1, 2) and subtracts 1, then maps [0, 1) onto [minval, maxval) with
one rounding (XLA's fused multiply-add) and clamps at minval. The normal is sqrt(2) * erfinv(u) of a uniform over
(nextafter(-1, 0), 1), the inverse error function taken in float64 and rounded
(XLA's float32 polynomial agrees to a few ulp). verify_weights.py draws its
fixed latent and its prior noise so, and a golden written by either package
verifies in the other.
"""

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """JAX's threefry2x32 of the uint32 arrays (x0, x1) under key (k0, k1)."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = (x0 + ks[0]).astype(np.uint32)
    x1 = (x1 + ks[1]).astype(np.uint32)
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = (x0 + x1).astype(np.uint32)
                x1 = _rotl(x1, r) ^ x0
            x0 = (x0 + ks[(i + 1) % 3]).astype(np.uint32)
            x1 = (x1 + ks[(i + 2) % 3] + np.uint32(i + 1)).astype(np.uint32)
    return x0, x1


def prng_key(seed: int):
    """jax.random.PRNGKey(seed)'s two words (seed < 2**32)."""
    return (np.uint32((int(seed) >> 32) & 0xFFFFFFFF), np.uint32(int(seed) & 0xFFFFFFFF))


def random_bits(seed: int, shape) -> np.ndarray:
    """jax.random.bits(PRNGKey(seed), shape), uint32."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(prng_key(seed), hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(seed: int, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """jax.random.uniform(PRNGKey(seed), shape, float32, minval, maxval), bitwise."""
    bits = random_bits(seed, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo, hi = np.float32(minval), np.float32(maxval)
    # one rounding of floats * (hi - lo) + lo, as XLA's fused multiply-add: the
    # float64 product of two float32 values is exact
    scaled = (floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


def normal(seed: int, shape) -> np.ndarray:
    """jax.random.normal(PRNGKey(seed), shape), float32 (module docstring)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = torch.from_numpy(uniform(seed, shape, lo, 1.0).astype(np.float64))
    return (np.sqrt(2.0) * torch.special.erfinv(u).numpy()).astype(np.float32)

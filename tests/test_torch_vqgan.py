"""The port's VQGAN decoder and synth against the JAX package's, on the same weights.

Tiny configs (like __graft_entry__'s dry run): one with per-channel GroupNorm
groups (C % 32 != 0), one with 32 groups. The port upsamples by the reference
graph (NN-2x + 3x3 conv); the JAX decoder runs its default lhs-dilated form,
which is bit-tight with it in float32. Tolerances: float32 1e-4 (relative to
max |JAX| for the decoder, absolute for [0, 1] images), equal VQ indices;
bfloat16 5e-2 relative (the two graphs round at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.io.torch_import import convert_vqgan
from feed_forward_vqgan_clip_tpu.models import vqgan as jvq
from feed_forward_vqgan_clip_tpu.ops.quantize import nearest_codebook_indices as j_nearest
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import vqgan_state_dict
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import latent_bounds, make_vqgan, synth
from feed_forward_vqgan_clip_tpu_torch.ops.quantize import quantize_indices

TINY = dict(n_embed=32, embed_dim=8, z_channels=8, ch=8, ch_mult=(1, 2),
            num_res_blocks=1, attn_resolutions=(4,), resolution=8)
TINY32 = dict(n_embed=64, embed_dim=16, z_channels=32, ch=32, ch_mult=(1, 2),
              num_res_blocks=1, attn_resolutions=(4,), resolution=8)
CONFIGS = pytest.mark.parametrize("cfg", [TINY, TINY32], ids=["groups_per_channel", "groups32"])


def _random_state_dict(module, rng):
    """numpy draws for every parameter: matrices N(0, 1/fan_in), norm scales
    1 + N(0, 0.1), biases and shifts N(0, 0.1)."""
    sd = {}
    for k, v in module.state_dict().items():
        if v.dim() >= 2:
            a = rng.normal(size=v.shape) / np.sqrt(np.prod(v.shape[1:]))
        else:
            a = 0.1 * rng.normal(size=v.shape) + (k.endswith("weight") and "norm" in k)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def _make(rng, cfg, dtype=torch.float32):
    """The port's VQGAN with random weights, and the JAX VQGAN with the same weights
    carried over by the JAX package's own converter (io/torch_import.convert_vqgan)."""
    tm = make_vqgan(cfg, dtype=dtype)
    sd = _random_state_dict(tm, rng)
    tm.load_state_dict(sd)
    params = convert_vqgan({k: v.numpy() for k, v in sd.items()}, cfg)
    jm = jvq.make_vqgan(cfg, dtype=jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    return jm, params, tm.eval()


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@CONFIGS
def test_decoder_matches_jax(rng, cfg):
    jm, params, tm = _make(rng, cfg)
    z = rng.normal(size=(2, 4, 4, cfg["embed_dim"])).astype(np.float32)
    ref = jax.jit(lambda p, v: jm.apply(p, v, method=jm.decode_latent))(params, jnp.asarray(z))
    with torch.no_grad():
        out = tm.decode_latent(torch.from_numpy(z))
    assert out.shape == (2, 8, 8, 3)
    assert _rel(out, ref) <= 1e-4


@CONFIGS
def test_synth_matches_jax(rng, cfg):
    jm, params, tm = _make(rng, cfg)
    z = 0.1 * rng.normal(size=(2, 4, 4, cfg["embed_dim"])).astype(np.float32)
    jz = jnp.asarray(z)
    ref, jvjp = jax.jit(
        lambda p, v: jax.vjp(lambda u: jvq.synth(jm, p, u, use_pallas=False), v))(params, jz)
    g = rng.normal(size=ref.shape).astype(np.float32)
    tz = torch.tensor(z, requires_grad=True)
    img = synth(tm, tz)
    (img * torch.from_numpy(g)).sum().backward()
    idx = quantize_indices(tz.detach(), tm.codebook().detach())
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(j_nearest(jz, jnp.asarray(params["params"]["codebook"]))))
    assert img.shape == (2, 8, 8, 3)
    assert float(np.abs(img.detach().numpy() - np.asarray(ref)).max()) <= 1e-4
    # straight-through gradient: through the decoder, then identity to z
    assert _rel(tz.grad, jvjp(jnp.asarray(g))[0]) <= 1e-4


@CONFIGS
def test_from_jax_round_trip(rng, cfg):
    jm, params, tm = _make(rng, cfg)
    back = vqgan_state_dict(params)
    sd = tm.state_dict()
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())


def test_latent_bounds(rng):
    _, params, tm = _make(rng, TINY)
    with torch.no_grad():
        lo, hi = latent_bounds(tm)
    cb = np.asarray(params["params"]["codebook"])
    assert lo.dim() == 0 and hi.dim() == 0
    assert float(lo) == float(cb.min()) and float(hi) == float(cb.max())
    jlo, jhi = jvq.latent_bounds(params)
    assert float(lo) == float(jlo) and float(hi) == float(jhi)


def test_decoder_bf16_matches_jax(rng):
    jm, params, tm = _make(rng, TINY32, dtype=torch.bfloat16)
    z = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    ref = jax.jit(lambda p, v: jm.apply(p, v, method=jm.decode_latent))(params, jnp.asarray(z))
    with torch.no_grad():
        out = tm.decode_latent(torch.from_numpy(z))
    assert out.dtype == torch.bfloat16
    assert _rel(out.float(), ref) <= 5e-2


def test_f16_16384_structure():
    from feed_forward_vqgan_clip_tpu.registry import VQGAN_CONFIGS

    tm = make_vqgan(VQGAN_CONFIGS["vqgan_imagenet_f16_16384"], device="meta")
    sd = tm.state_dict()
    assert sd["quantize.embedding.weight"].shape == (16384, 256)
    assert "decoder.up.4.attn.2.q.weight" in sd  # 16x16 attention at the lowest level
    assert "decoder.up.3.attn.0.q.weight" not in sd
    assert sd["decoder.up.1.upsample.conv.weight"].shape == (128, 128, 3, 3)
    assert "decoder.up.0.upsample.conv.weight" not in sd

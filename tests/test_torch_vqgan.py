"""The port's VQGAN decoder and synth against the JAX package's, on the same weights.

Tiny configs (like __graft_entry__'s dry run): one with per-channel GroupNorm
groups (C % 32 != 0), one with 32 groups. The port's decoder (its Upsample is
the transposed conv) against the JAX decoder in both of its forms: the
reference graph NN-2x + 3x3 conv (mode 0) and its default lhs-dilated form
(mode 2). Tolerances: float32 1e-4 (relative to max |JAX| for the decoder,
absolute for [0, 1] images), equal VQ indices; bfloat16 5e-2 relative (the
graphs round at different points). Upsample alone, against the reference graph
on its own weights (reference_upsample) and against JAX's mode 2: float32
forward within 1e-5, input and parameter gradients within 1e-4 (JAX
tests/test_vqgan.py holds its own modes so); bf16 within 5e-2 of max
|reference| (its test_upsample_fast_bf16).
"""

import jax
import torch.nn.functional as F
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.io.torch_import import convert_vqgan
from feed_forward_vqgan_clip_tpu.models import vqgan as jvq
from feed_forward_vqgan_clip_tpu.ops.quantize import nearest_codebook_indices as j_nearest
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import vqgan_state_dict
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import (
    Upsample,
    latent_bounds,
    make_vqgan,
    synth,
)
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


# the JAX decoder's upsample form, read when it is traced (FFVC_FAST_UPSAMPLE at import)
FAST = pytest.mark.parametrize("fast", ["0", "2"], ids=["reference_upsample",
                                                      "transposed_upsample"])


@FAST
@CONFIGS
def test_decoder_matches_jax(rng, cfg, fast, monkeypatch):
    monkeypatch.setattr(jvq, "_FAST_UPSAMPLE_MODE", fast)
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


@FAST
def test_decoder_bf16_matches_jax(rng, fast, monkeypatch):
    monkeypatch.setattr(jvq, "_FAST_UPSAMPLE_MODE", fast)
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


def reference_upsample(m, x):
    """The reference graph on the weights of Upsample `m`: NN-2x, then the 3x3 conv."""
    return m.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def _upsample_pair(rng, c, dtype=torch.float32):
    """Upsample on random weights, and the JAX Upsample's parameters holding them
    (HWIO kernel)."""
    m = Upsample(c, dtype=dtype)
    m.conv.weight.data = torch.from_numpy(
        (rng.normal(size=(c, c, 3, 3)) / np.sqrt(9 * c)).astype(np.float32))
    m.conv.bias.data = torch.from_numpy((0.1 * rng.normal(size=c)).astype(np.float32))
    jp = {"params": {"conv": {"kernel": jnp.asarray(m.conv.weight.detach().permute(2, 3, 1, 0)
                                                    .numpy()),
                              "bias": jnp.asarray(m.conv.bias.detach().numpy())}}}
    return m, jp


def _upsample_grads(m, fn, x, g):
    """NHWC x -> (NHWC output, input gradient, (weight gradient HWIO, bias gradient))
    of <fn(m, x), g>."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    m.zero_grad()
    y = fn(m, xt).permute(0, 2, 3, 1)
    (y.float() * torch.from_numpy(g)).sum().backward()
    return (y.detach().float().numpy(), xt.grad.permute(0, 2, 3, 1).numpy(),
            (m.conv.weight.grad.permute(2, 3, 1, 0).numpy(), m.conv.bias.grad.numpy()))


def test_upsample_transposed_matches_jax_and_the_reference_graph(rng):
    c = 16
    x = rng.normal(size=(2, 7, 5, c)).astype(np.float32)
    g = rng.normal(size=(2, 14, 10, c)).astype(np.float32)
    m, jp = _upsample_pair(rng, c)
    y0, dx0, dp0 = _upsample_grads(m, reference_upsample, x, g)
    y2, dx2, dp2 = _upsample_grads(m, Upsample.__call__, x, g)
    assert y2.shape == (2, 14, 10, c)

    def jloss(p, v):
        y = jvq.Upsample(fast="2").apply(p, v)
        return jnp.sum(y * jnp.asarray(g)), y

    (jdp, jdx), jy = jax.grad(jloss, (0, 1), has_aux=True)(jp, jnp.asarray(x))
    jdp = (jdp["params"]["conv"]["kernel"], jdp["params"]["conv"]["bias"])
    for want_y, want_dx, want_dp in ((y0, dx0, dp0), (jy, jdx, jdp)):
        np.testing.assert_allclose(y2, np.asarray(want_y), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(dx2, np.asarray(want_dx), atol=1e-4)
        for got, want in zip(dp2, want_dp):
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_upsample_transposed_bf16(rng):
    c = 16
    x = rng.normal(size=(1, 6, 6, c)).astype(np.float32)
    g = rng.normal(size=(1, 12, 12, c)).astype(np.float32)
    m, jp = _upsample_pair(rng, c, torch.bfloat16)
    y0, dx0, dp0 = _upsample_grads(m, reference_upsample, x, g)
    y2, dx2, dp2 = _upsample_grads(m, Upsample.__call__, x, g)
    jy = jvq.Upsample(fast="2", dtype=jnp.bfloat16).apply(jp, jnp.asarray(x))
    for got, want in [(y2, y0), (y2, jy), (dx2, dx0)] + list(zip(dp2, dp0)):
        assert _rel(got, want) < 5e-2

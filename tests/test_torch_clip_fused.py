"""The port's fused CLIP image tower (models/clip_fused.py: every MLP sublayer
through K11, its plain version on the CPU) against the JAX package's
`encode_image_fused` (Pallas kernel in interpret mode) and against the port's
own module path; and the dispatcher's FFVC_FUSED_CLIP resolution.

The tower of tests/test_fused_clip.py: image 32 px, patch 8, width 128 (the
kernel gate's 128-multiple widths), 2 layers, 4 heads, batch 16 (272 rows).
Tolerances, float32: embeddings within 5e-4 (the JAX test's ceiling for its
fused tower against its module path); the input gradient within 1e-3 of max
|JAX grad|; the tower's parameter grads within 5e-3 of max(1e-2, max |grad|),
the JAX test's ceiling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.models import clip_fused as jfused
from feed_forward_vqgan_clip_tpu.models import clip_vit as jclip
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import clip_state_dict
from feed_forward_vqgan_clip_tpu_torch.models import clip_fused
from feed_forward_vqgan_clip_tpu_torch.models.clip_fused import (
    clip_fused_supported,
    encode_image_fused,
    make_clip_image_apply,
)
from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip_from_config

CFG = dict(image_size=32, patch_size=8, vision_width=128, vision_layers=2, vision_heads=4,
           embed_dim=32, text_width=32, text_layers=1, text_heads=2, vocab_size=64,
           context_length=8)
B = 16


def _towers(act, seed=0):
    """(JAX module, its variables, the port's CLIP on the same weights)."""
    jm = jclip.make_clip_from_config(CFG, act=act)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
                         jnp.zeros((1, 32, 32, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    v = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=np.shape(a)).astype(
        np.float32), v)
    tm = make_clip_from_config(CFG, act=act, image=True)
    tm.load_state_dict(clip_state_dict(v))
    return jm, v, tm.requires_grad_(False)


def _images(seed=1, b=B):
    return np.random.default_rng(seed).normal(size=(b, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_encode_image_fused_matches_jax_and_module_path(act):
    jm, v, tm = _towers(act)
    x = _images()
    assert clip_fused_supported(tm, B, 32) and jfused.clip_fused_supported(jm, B, 32)
    want = np.asarray(jfused.encode_image_fused(jm, v, jnp.asarray(x), interpret=True))
    got = encode_image_fused(tm, torch.from_numpy(x))
    assert got.shape == (B, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)
    np.testing.assert_allclose(got.numpy(), tm.encode_image(torch.from_numpy(x)).numpy(),
                               atol=5e-4)


def test_input_gradient_matches_jax_fused_tower():
    """The train loss differentiates the frozen tower in its input images only."""
    jm, v, tm = _towers("quick_gelu", seed=2)
    x = _images(3)
    ct = np.random.default_rng(4).normal(size=(B, 32)).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: jfused.encode_image_fused(jm, v, xx, interpret=True),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    tx = torch.from_numpy(x).requires_grad_()
    encode_image_fused(tm, tx).backward(torch.from_numpy(ct))
    assert all(p.grad is None for p in tm.parameters())
    assert np.abs(tx.grad.numpy() - want).max() <= 1e-3 * np.abs(want).max()


def test_parameter_grads_match_module_path():
    """With the tower's parameters trainable, the fused path's grads equal the
    module path's (tests/test_fused_clip.py's grads parity)."""
    _, _, tm = _towers("quick_gelu", seed=5)
    x = torch.from_numpy(_images(6))
    tgt = torch.from_numpy(np.random.default_rng(7).normal(size=(B, 32)).astype(np.float32))
    grads = []
    for fn in (encode_image_fused, lambda m, xx: m.encode_image(xx)):
        tm.zero_grad(set_to_none=True)
        tm.visual.requires_grad_(True)
        (fn(tm, x) - tgt).square().mean().backward()
        grads.append({n: p.grad.clone() for n, p in tm.visual.named_parameters()})
    fused, module = grads
    assert sorted(fused) == sorted(module)
    for name, want in module.items():
        scale = max(1e-2, float(want.abs().max()))
        assert float((fused[name] - want).abs().max()) <= 5e-3 * scale, name


@pytest.mark.parametrize("env,fused,on", [
    ("", None, False),      # the default is the module path
    ("", True, True),       # fused=True runs it on any device (plain K11 on the CPU)
    ("0", True, False),     # FFVC_FUSED_CLIP=0 forces it off
    ("false", True, False),
    ("1", None, False),     # =1 turns it on for CUDA tensors only
    ("true", True, False),
])
def test_dispatcher_resolves_the_env_as_jax(monkeypatch, env, fused, on):
    _, _, tm = _towers("quick_gelu", seed=8)
    calls = []
    real = clip_fused.encode_image_fused
    monkeypatch.setattr(clip_fused, "encode_image_fused",
                        lambda m, xx: calls.append(1) or real(m, xx))
    monkeypatch.setenv("FFVC_FUSED_CLIP", env)
    x = torch.from_numpy(_images(9))
    got = make_clip_image_apply(tm, fused=fused)(x)
    assert bool(calls) == on
    np.testing.assert_allclose(got.numpy(), tm.encode_image(x).numpy(), atol=5e-4)


def test_dispatcher_falls_back_outside_the_gate(monkeypatch):
    """Rows no JAX row tile divides (2 images x 17 tokens) and towers that are no
    CLIP take the module path, as in the JAX dispatcher."""
    _, _, tm = _towers("quick_gelu", seed=10)
    monkeypatch.delenv("FFVC_FUSED_CLIP", raising=False)
    monkeypatch.setattr(clip_fused, "encode_image_fused", lambda m, xx: pytest.fail("fused"))
    x = torch.from_numpy(_images(11, b=2))
    assert not clip_fused_supported(tm, 2, 32)
    assert torch.equal(make_clip_image_apply(tm, fused=True)(x), tm.encode_image(x))
    assert not clip_fused_supported(tm.visual, B, 32)


@pytest.mark.parametrize("b,hh", [(16, 32), (2, 32), (64, 224), (8, 224), (48, 32)])
def test_supported_is_the_jax_gate(b, hh):
    jm, _, tm = _towers("quick_gelu")
    assert clip_fused_supported(tm, b, hh) == jfused.clip_fused_supported(jm, b, hh)

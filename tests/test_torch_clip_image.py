"""The port's CLIP image tower against the JAX package's `encode_image`, and the
JAX <-> port converters for the whole CLIP.

The registry's "tiny" CLIP (image 32 px, patch 8, width 64, 2 layers, 2 heads).
JAX params are drawn by its init, moved off it with numpy noise and carried to
the port by io/from_jax.py. Tolerances relative to max |JAX|: float32 1e-4 for
the embeddings and the input gradient (the same math, summed in another order);
bfloat16 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.io.torch_import import convert_clip_vit
from feed_forward_vqgan_clip_tpu.models import clip_vit as jclip
from feed_forward_vqgan_clip_tpu.registry import CLIP_VIT_CONFIGS
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import (
    clip_image_state_dict,
    clip_state_dict,
    clip_text_state_dict,
)
from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import CLIP, make_clip, make_clip_from_config
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import load_perceptor

CFG = CLIP_VIT_CONFIGS["tiny"]


def _jax_clip(rng, act):
    jm = jclip.make_clip_from_config(CFG, act=act)
    p = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32),
                         jnp.zeros((1, 32, 32, 3), jnp.float32))
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=np.shape(a)).astype(np.float32), p)
    return jm, p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_image_tower_matches_jax_encode_image(rng, act, dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    _, p = _jax_clip(rng, act)
    jm = jclip.make_clip_from_config(CFG, act=act, dtype=jdt)
    x = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    ct = rng.normal(size=(3, CFG["embed_dim"])).astype(np.float32)
    ref, vjp = jax.vjp(lambda v: jm.apply(p, v.astype(jdt), method=jm.encode_image),
                       jnp.asarray(x))
    (g_ref,) = vjp(jnp.asarray(ct))
    tm = make_clip_from_config(CFG, act=act, dtype=dtype, image=True)
    tm.load_state_dict(clip_state_dict(p))
    tm.requires_grad_(False)
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    out = tm.encode_image(tx)
    out.backward(torch.from_numpy(ct))
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    ref, g_ref = np.asarray(ref), np.asarray(g_ref, np.float32)
    assert out.shape == (3, CFG["embed_dim"]) and out.dtype == torch.float32
    assert np.abs(out.detach().numpy() - ref).max() / np.abs(ref).max() <= tol
    g = tx.grad.float().numpy()
    assert np.abs(g - g_ref).max() / np.abs(g_ref).max() <= tol


def test_clip_state_dict_round_trip(rng):
    """JAX params -> port CLIP (from_jax) -> OpenAI state dict -> the JAX package's
    convert_clip_vit gives the same params back, bit for bit."""
    _, p = _jax_clip(rng, "quick_gelu")
    tm = make_clip("tiny", image=True)
    sd = clip_state_dict(p)
    tm.load_state_dict(sd)
    assert set(clip_image_state_dict(p)) == {k for k in sd if k.startswith("visual.")}
    assert set(clip_text_state_dict(p)) | set(clip_image_state_dict(p)) | {"logit_scale"} == set(sd)
    back = convert_clip_vit({k: v.numpy() for k, v in tm.state_dict().items()})
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(p):
        np.testing.assert_array_equal(np.asarray(flat[path]), np.asarray(leaf))


def test_make_clip_image_tower_names():
    m = make_clip("ViT-B/32", device="meta", image=True)
    assert isinstance(m, CLIP)
    assert tuple(m.visual.conv1.weight.shape) == (768, 3, 32, 32)
    assert tuple(m.visual.positional_embedding.shape) == (50, 768)
    assert tuple(m.visual.proj.shape) == (768, 512)
    assert len(m.visual.transformer.resblocks) == 12
    assert "visual.transformer.resblocks.11.mlp.c_proj.weight" in m.state_dict()
    assert not isinstance(make_clip("ViT-B/32", device="meta"), CLIP)  # text tower only


def test_load_perceptor_image_half_is_seeded_and_frozen():
    a = load_perceptor("tiny", dtype=torch.float32, device="cpu", seed=3)
    b = load_perceptor("tiny", dtype=torch.float32, device="cpu", seed=3)
    text_only = load_perceptor("tiny", dtype=torch.float32, device="cpu", seed=3, image=False)
    assert not any(p.requires_grad for p in a.module.parameters())
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    ea = a.encode_image(x)
    np.testing.assert_array_equal(ea.detach().numpy(), b.encode_image(x).detach().numpy())
    ea.sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    toks = torch.zeros(2, 77, dtype=torch.long)
    toks[:, 0], toks[:, 1] = 49406, 49407
    # the text tower's draws come first: the same with or without the image tower
    np.testing.assert_array_equal(a.encode_text(toks).numpy(), text_only.encode_text(toks).numpy())

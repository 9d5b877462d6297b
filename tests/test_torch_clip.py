"""The port's CLIP text tower against the JAX package's `encode_text`.

The registry's "tiny" CLIP (width 32, 2 layers, 2 heads, 77 tokens). The JAX
text params are drawn by its init, moved off it with numpy noise and carried to
the port by io/from_jax.py. Tolerance: float32 1e-4 relative to max |JAX|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.models import clip_vit as jclip
from feed_forward_vqgan_clip_tpu.registry import CLIP_VIT_CONFIGS
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import clip_text_state_dict
from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip, make_clip_from_config
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import load_perceptor


def _tokens(rng, batch, vocab=49408):
    """[SOT, words..., EOT, 0...] with the EOT at varied positions."""
    toks = np.zeros((batch, 77), np.int32)
    for i in range(batch):
        n = 1 + (7 * i) % 20
        toks[i, 0] = 49406
        toks[i, 1:1 + n] = rng.integers(1, vocab - 2, size=n)
        toks[i, 1 + n] = 49407
    return toks


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_text_tower_matches_jax_encode_text(rng, act):
    cfg = CLIP_VIT_CONFIGS["tiny"]
    jm = jclip.make_clip_from_config(cfg, act=act)
    text = jclip.TextTransformer(
        context_length=cfg["context_length"], vocab_size=cfg["vocab_size"],
        width=cfg["text_width"], layers=cfg["text_layers"], heads=cfg["text_heads"],
        embed_dim=cfg["embed_dim"], act=act)
    p = jax.jit(text.init)(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))["params"]
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), p)
    toks = _tokens(rng, 5)
    full = {"params": {"text": p, "logit_scale": np.float32(4.6052)}}  # no image tower
    ref = jax.jit(lambda pp, t: jm.apply(pp, t, method=jm.encode_text))(full, jnp.asarray(toks))
    tm = make_clip_from_config(cfg, act=act)
    tm.load_state_dict(clip_text_state_dict(full))
    with torch.no_grad():
        out = tm.encode_text(torch.from_numpy(toks).long())
    assert out.shape == (5, cfg["embed_dim"]) and out.dtype == torch.float32
    ref = np.asarray(ref)
    assert np.abs(out.numpy() - ref).max() / np.abs(ref).max() <= 1e-4


def test_make_clip_names():
    m = make_clip("ViT-B/32", device="meta")
    assert (m.width, m.embed_dim, len(m.transformer.resblocks)) == (512, 512, 12)
    assert m.transformer.resblocks[0].mlp.act == "quick_gelu"
    m = make_clip("openclip/ViT-B-32/laion2b_e16", device="meta")
    assert m.transformer.resblocks[0].mlp.act == "gelu" and m.width == 512
    m = make_clip("openclip/ViT-B-32-quickgelu/laion400m_e32", device="meta")
    assert m.transformer.resblocks[0].mlp.act == "quick_gelu"
    with pytest.raises(ValueError, match="unknown CLIP ViT arch"):
        make_clip("ViT-H/14")


def test_load_perceptor_random_init_is_seeded(caplog, tmp_path):
    a = load_perceptor("tiny", dtype=torch.float32, device="cpu", seed=3)
    b = load_perceptor("tiny", dtype=torch.float32, device="cpu", seed=3)
    assert "random init" in caplog.text
    assert (a.size, a.dim) == (32, 32)
    toks = torch.from_numpy(_tokens(np.random.default_rng(0), 2)).long()
    np.testing.assert_array_equal(a.encode_text(toks).numpy(), b.encode_text(toks).numpy())
    # a directory is read as the JAX package's (its params.msgpack must be there)
    with pytest.raises(FileNotFoundError):
        load_perceptor("tiny", str(tmp_path), device="cpu")


def test_load_perceptor_reads_an_openai_state_dict(tmp_path):
    """A full CLIP state dict in OpenAI's key names (with the image tower and
    OpenAI's shape entries) loads into the text tower alone; a
    {"state_dict": ...} wrapper loads the same."""
    src = load_perceptor("tiny", dtype=torch.float32, device="cpu", seed=5)
    full = make_clip_from_config(CLIP_VIT_CONFIGS["tiny"], image=True).state_dict()
    full.update(src.module.state_dict())
    full["input_resolution"] = torch.tensor(32)
    torch.save(full, tmp_path / "clip.pt")
    torch.save({"state_dict": full}, tmp_path / "wrapped.pt")
    toks = torch.from_numpy(_tokens(np.random.default_rng(1), 3)).long()
    want = src.encode_text(toks).numpy()
    for name in ("clip.pt", "wrapped.pt"):
        got = load_perceptor("tiny", str(tmp_path / name), dtype=torch.float32, device="cpu",
                             seed=9, image=False)
        assert not any(p.requires_grad for p in got.module.parameters())
        np.testing.assert_array_equal(got.encode_text(toks).numpy(), want)

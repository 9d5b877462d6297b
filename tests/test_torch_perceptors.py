"""The perceptors the port gained last: OpenCLIP files outside the registry (their
architecture sniffed from the checkpoint), OpenCLIP's `text.`-nested text tower
(fault C5), and crowsonkb's CLOOB ViTs, each against the JAX package on the
same weights.

Weights are numpy draws into the port's modules, written as the torch file
(or, for CLOOB, the haiku pickle) both packages read. Tokens and images are
numpy draws, images NHWC. Tolerance: float32, 2e-4 * max(1, max |JAX|).
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.io import torch_import as ti
from feed_forward_vqgan_clip_tpu.models import cloob as jcloob
from feed_forward_vqgan_clip_tpu.models.perceptor import load_perceptor as j_load_perceptor
from feed_forward_vqgan_clip_tpu_torch.io import clip_arch
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import crowson_cloob_state_dict
from feed_forward_vqgan_clip_tpu_torch.models import cloob
from feed_forward_vqgan_clip_tpu_torch.models.clip_resnet import CLIPResNet
from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip, make_clip_from_config
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import load_perceptor
from test_torch_vitgan import assert_close, draw_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# an OpenCLIP ViT outside the registry (widths a multiple of 64: the sniffed heads)
OFF_VIT = dict(image_size=48, patch_size=16, vision_width=128, vision_layers=2,
               vision_heads=2, embed_dim=24, text_width=64, text_layers=1, text_heads=1,
               vocab_size=64, context_length=12)
OFF_RN = dict(image_size=64, vision_layers=(1, 1, 1, 1), vision_width=16, embed_dim=24,
              text_width=64, text_layers=2, text_heads=1, vocab_size=64, context_length=12)
TEXT_KEYS = ("token_embedding.weight", "positional_embedding", "ln_final.weight",
             "ln_final.bias", "text_projection")


def _tokens(b, vocab, ctx, seed=7):
    toks = np.zeros((b, ctx), np.int64)
    toks[:, 1:4] = np.random.default_rng(seed).integers(1, vocab - 2, size=(b, 3))
    toks[:, 4] = vocab - 1  # EOT, the highest id
    return toks


def _images(b, size, seed=8):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, size=(b, size, size, 3)).astype(
        np.float32)


def _nest_text(sd):
    """OpenCLIP's CustomTextCLIP layout: the text tower under `text.`."""
    return {(f"text.{k}" if k.startswith("transformer.") or k in TEXT_KEYS else k): v
            for k, v in sd.items()}


def _save(sd, path):
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    return str(path)


def _both(name, path, toks, imgs):
    """encode_text and encode_image of both packages' load_perceptor(name, path),
    float32: ((port text, port image), (JAX text, JAX image))."""
    p = load_perceptor(name, path, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        port = (p.encode_text(torch.from_numpy(toks)), p.encode_image(torch.from_numpy(imgs)))
    j = j_load_perceptor(name, path, dtype=jnp.float32)
    return port, (j.encode_text(jnp.asarray(toks)), j.encode_image(jnp.asarray(imgs))), p, j


# ------------------------------------------------------------------- C5, sniffing


def test_text_nested_openclip_vit_loads_in_both_packages(tmp_path):
    """Fault C5: a CustomTextCLIP file (text tower under `text.`) loads in the
    port as in the JAX package, and the two encode alike. Before the repair
    the port's load_state_dict failed on the missing top-level text keys."""
    sd = draw_(make_clip("tiny", image=True), 1)
    path = _save(_nest_text(sd), tmp_path / "custom_text.pt")
    assert "text.token_embedding.weight" in torch.load(path)
    toks, imgs = _tokens(2, 49408, 77), _images(2, 32)
    (pt, pi), (jt, ji), _, _ = _both("tiny", path, toks, imgs)
    assert_close(pt, jt)
    assert_close(pi, ji)
    flat = load_perceptor("tiny", _save(sd, tmp_path / "flat.pt"), dtype=torch.float32,
                          device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(flat.encode_text(torch.from_numpy(toks)).numpy(),
                                      pt.numpy())


def _vit_dict(cfg, seed):
    return draw_(make_clip_from_config(cfg, act="gelu", image=True), seed)


def _rn_dict(cfg, seed):
    return draw_(CLIPResNet(cfg, "gelu"), seed)


@pytest.mark.parametrize("layout", ["openai", "module_prefix", "text_nested"])
@pytest.mark.parametrize("family", ["vit", "resnet"])
def test_sniff_equals_jax(family, layout):
    sd = _vit_dict(OFF_VIT, 2) if family == "vit" else _rn_dict(OFF_RN, 3)
    if layout == "module_prefix":
        sd = {f"module.{k}": v for k, v in sd.items()}
    elif layout == "text_nested":
        sd = _nest_text(sd)
    got = clip_arch.sniff_clip_arch(sd)
    assert got == ti.sniff_clip_arch(sd)
    want = OFF_VIT if family == "vit" else OFF_RN
    assert got == (family, {k: want[k] for k in got[1]})


def test_normalize_equals_jax():
    sd = _nest_text(_vit_dict(OFF_VIT, 4))
    for variant in (sd, {f"module.{k}": v for k, v in sd.items()},
                    {f"_orig_mod.{k}": v for k, v in sd.items()}):
        assert list(clip_arch.normalize_openclip_naming(variant)) == list(
            ti._normalize_openclip_naming(variant))


def test_sniff_rejects_other_towers():
    sd = {k: v for k, v in _vit_dict(OFF_VIT, 5).items() if not k.startswith("visual.")}
    with pytest.raises(ValueError, match="neither"):
        clip_arch.sniff_clip_arch(sd)


@pytest.mark.parametrize("family", ["vit", "resnet"])
def test_off_registry_openclip_arch_matches_jax(family, tmp_path):
    """`openclip/<arch>/<tag>` with an arch neither registry names: both packages
    build the tower the file's shapes describe, and encode alike (exact GELU)."""
    if family == "vit":
        sd, name, cfg = _vit_dict(OFF_VIT, 6), "openclip/ViT-T-16-custom/x", OFF_VIT
    else:
        sd, name, cfg = _rn_dict(OFF_RN, 7), "openclip/RN-tiny/x", OFF_RN
    path = _save(sd, tmp_path / "off.pt")
    toks, imgs = _tokens(2, 64, 12), _images(2, cfg["image_size"])
    (pt, pi), (jt, ji), p, j = _both(name, path, toks, imgs)
    assert (p.size, p.dim) == (j.size, j.dim) == (cfg["image_size"], cfg["embed_dim"])
    assert_close(pt, jt)
    assert_close(pi, ji)
    text_only = load_perceptor(name, path, dtype=torch.float32, device="cpu", image=False)
    assert not hasattr(text_only.module, "visual")
    with torch.no_grad():
        np.testing.assert_array_equal(text_only.encode_text(torch.from_numpy(toks)).numpy(),
                                      pt.numpy())


def test_off_registry_arch_without_a_path_raises_as_jax():
    name = "openclip/ViT-B-16-plus-240/laion400m_e32"
    with pytest.raises(ValueError) as port:
        load_perceptor(name, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError) as jx:
        j_load_perceptor(name, dtype=jnp.float32)
    assert str(port.value) == str(jx.value)


# ------------------------------------------------------------------- CLOOB ViTs

TINY = dict(d_embed=8, image_layers=1, image_d_model=16, image_heads=2, image_size=16,
            patch_size=8, text_layers=1, text_d_model=16, text_heads=2, text_size=10,
            vocab_size=32)
NAME = "cloob_laion_400m_vit_b_16_32_epochs"


def _haiku_payload(cfg, seed, leaf=np.asarray):
    """A crowsonkb haiku pickle's {"params": (image_tree, text_tree)} of numpy
    draws (`leaf` wraps each array)."""
    rng = np.random.default_rng(seed)

    def g(*s):
        return leaf((0.3 * rng.normal(size=s)).astype(np.float32))

    def layers(tree, base, n, d):
        for i in range(n):
            pre = f"{base}/layer_{i}"
            for ln in ("self_attention/layer_norm", "feed_forward/layer_norm"):
                tree[f"{pre}/{ln}"] = {"scale": leaf(1 + np.asarray(g(d))), "offset": g(d)}
            for lin in ("query", "key", "value", "linear"):
                tree[f"{pre}/self_attention/multi_head_attention/{lin}"] = {"w": g(d, d),
                                                                            "b": g(d)}
            tree[f"{pre}/feed_forward/linear_0"] = {"w": g(d, 4 * d), "b": g(4 * d)}
            tree[f"{pre}/feed_forward/linear_1"] = {"w": g(4 * d, d), "b": g(d)}
        return tree

    di, dt, p = cfg["image_d_model"], cfg["text_d_model"], cfg["patch_size"]
    grid = cfg["image_size"] // p
    img = layers({"vi_t_image_encoder": {"class_embed": g(di)},
                  "vi_t_image_encoder/embed": {"w": g(p, p, 3, di)},
                  "vi_t_image_encoder/pos_embed": {"w": g(grid * grid + 1, di)},
                  "vi_t_image_encoder/proj": {"w": g(di, cfg["d_embed"]), "b": g(cfg["d_embed"])}},
                 "vi_t_image_encoder", cfg["image_layers"], di)
    txt = layers({"text_encoder/embed": {"embeddings": g(cfg["vocab_size"], dt)},
                  "text_encoder/pos_embed": {"w": g(cfg["text_size"], dt)},
                  "text_encoder/proj": {"w": g(dt, cfg["d_embed"]), "b": g(cfg["d_embed"])}},
                 "text_encoder", cfg["text_layers"], dt)
    return {"params": (img, txt)}


def _cloob_tokens(seed=3):
    toks = np.zeros((3, TINY["text_size"]), np.int64)
    toks[:, 1:4] = np.random.default_rng(seed).integers(1, 30, size=(3, 3))
    toks[:, 4] = TINY["vocab_size"] - 1
    toks[2, 2] = TINY["vocab_size"] - 1  # an early eot: the rest is padding
    return toks


@pytest.fixture
def tiny_cloob(monkeypatch, tmp_path):
    """NAME at the JAX tests' TINY config in both packages, its haiku pickle."""
    monkeypatch.setitem(cloob.CROWSON_CONFIGS, NAME, TINY)
    monkeypatch.setitem(jcloob.CROWSON_CONFIGS, NAME, TINY)
    path = tmp_path / "cloob.pkl"
    with open(path, "wb") as fd:
        pickle.dump(_haiku_payload(TINY, 0), fd)
    return str(path)


def test_cloob_vit_matches_jax(tiny_cloob):
    toks, imgs = _cloob_tokens(), _images(2, TINY["image_size"])
    (pt, pi), (jt, ji), p, j = _both(NAME, tiny_cloob, toks, imgs)
    assert (p.size, p.dim) == (j.size, j.dim) == (224, 512)  # the registry's entries
    assert_close(pt, jt)
    assert_close(pi, ji)
    np.testing.assert_allclose(np.linalg.norm(pt.numpy(), axis=1), 1.0, rtol=1e-5)
    assert float(p.logit_scale) == pytest.approx(float(j.logit_scale))
    text_only = load_perceptor(NAME, tiny_cloob, dtype=torch.float32, device="cpu",
                               image=False)
    assert text_only.module.image_encoder is None
    with torch.no_grad():
        np.testing.assert_array_equal(text_only.encode_text(torch.from_numpy(toks)).numpy(),
                                      pt.numpy())


def test_cloob_query_side_padding_mask_moves_like_jax(tiny_cloob):
    """Junk past eot reaches the valid queries through the keys, as upstream's
    query-axis mask lets it: both packages' outputs move, by the same amount."""
    p = load_perceptor(NAME, tiny_cloob, dtype=torch.float32, device="cpu", image=False)
    j = j_load_perceptor(NAME, tiny_cloob, dtype=jnp.float32)
    toks = np.zeros((1, TINY["text_size"]), np.int64)
    toks[0, :3] = [5, 6, TINY["vocab_size"] - 1]
    junk = toks.copy()
    junk[0, 5] = 9
    with torch.no_grad():
        d_port = (p.encode_text(torch.from_numpy(junk)) - p.encode_text(torch.from_numpy(toks)))
    d_jax = np.asarray(j.encode_text(jnp.asarray(junk))) - np.asarray(j.encode_text(
        jnp.asarray(toks)))
    assert float(np.abs(d_jax).max()) > 1e-3
    assert_close(d_port, d_jax)


def test_crowson_cloob_state_dict_carries_the_jax_init():
    jm = jcloob.CrowsonCLOOB(**TINY)
    toks, imgs = _cloob_tokens(), _images(2, TINY["image_size"])
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(4), jnp.asarray(toks),
                                              jnp.asarray(imgs)))
    m = cloob.CrowsonCLOOB(TINY)
    m.load_state_dict(crowson_cloob_state_dict(params))
    with torch.no_grad():
        assert_close(m.encode_text(torch.from_numpy(toks)),
                     jm.apply(params, jnp.asarray(toks), method=jm.encode_text))
        assert_close(m.encode_image(torch.from_numpy(imgs)),
                     jm.apply(params, jnp.asarray(imgs), method=jm.encode_image))


def test_cloob_random_init_is_seeded(tiny_cloob):
    a, b, c = (cloob.load_cloob(NAME, None, device="cpu", seed=s) for s in (1, 1, 2))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.text_encoder.embed.weight, c.text_encoder.embed.weight)
    full = cloob.CrowsonCLOOB(jcloob.CROWSON_CONFIGS["cloob_laion_400m_vit_b_16_16_epochs"],
                              device="meta")
    assert full.image_encoder.pos_embed.shape == (197, 768)
    assert full.text_encoder.embed.weight.shape == (49408, 512)
    with pytest.raises(ValueError, match="unknown CLOOB"):
        cloob.load_cloob("cloob_laion_2b", None, device="cpu")


def test_cloob_pickle_of_jax_arrays_loads_without_jax(tiny_cloob, tmp_path):
    """A pickle whose leaves are JAX arrays loads in a process where importing
    jax fails; the arrays come back as the numpy values."""
    path = tmp_path / "jax_leaves.pkl"
    with open(path, "wb") as fd:
        pickle.dump(_haiku_payload(TINY, 0, leaf=jnp.asarray), fd)
    want = tmp_path / "want.pt"
    with open(tiny_cloob, "rb") as fd:
        torch.save(cloob.haiku_state_dict(pickle.load(fd), TINY), want)
    script = (
        "import sys, torch\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "from feed_forward_vqgan_clip_tpu_torch.models import cloob\n"
        f"cfg = {TINY!r}\n"
        f"got = cloob.haiku_state_dict(cloob.read_haiku_pickle({str(path)!r}), cfg)\n"
        f"want = torch.load({str(want)!r})\n"
        "assert sorted(got) == sorted(want)\n"
        "assert all(torch.equal(got[k], want[k]) for k in want)\n"
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


@pytest.mark.parametrize("fn", [os.getcwd, np.load], ids=["os", "numpy_load"])
def test_haiku_unpickler_refuses_other_callables(tmp_path, fn):
    path = tmp_path / "evil.pkl"
    with open(path, "wb") as fd:
        pickle.dump({"params": (fn, {})}, fd)
    with pytest.raises(pickle.UnpicklingError):
        cloob.read_haiku_pickle(str(path))

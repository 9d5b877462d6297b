"""The port's CLIP ModifiedResNet perceptor against the JAX package's, on the same
weights, and the perceptor routing of RN, ml-jku CLOOB RN and OpenCLIP RN names.

Weights are numpy draws into the port's modules (BatchNorm statistics
included), carried to the JAX side by io/torch_import.convert_clip_resnet (and
its block helpers); the other direction, JAX init -> io/from_jax.py -> the
port -> convert_clip_resnet, must give back the same pytree. Images NHWC,
tokens and images numpy draws. A tiny RN (64 px, one Bottleneck a stage, width
16) stands in for the registry's where a test loads through `load_perceptor`.
Tolerance, as max |port - JAX|: 2e-4 * max(1, max |JAX|) in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu import registry as jax_registry
from feed_forward_vqgan_clip_tpu.io import torch_import as ti
from feed_forward_vqgan_clip_tpu.models import clip_resnet as jrn
from feed_forward_vqgan_clip_tpu.models.perceptor import load_perceptor as j_load_perceptor
from feed_forward_vqgan_clip_tpu_torch import registry
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import clip_resnet_state_dict
from feed_forward_vqgan_clip_tpu_torch.models import clip_resnet as trn
from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import TextTransformer
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import load_perceptor
from test_torch_vitgan import assert_close, draw_, normal

TINY_RN = dict(image_size=64, vision_layers=(1, 1, 1, 1), vision_width=16, embed_dim=24,
               text_width=32, text_layers=2, text_heads=2, vocab_size=64, context_length=12)


def _images(seed, b=2, size=64):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, size=(b, size, size, 3)).astype(
        np.float32)


def _tokens(b=2):
    toks = np.zeros((b, 12), np.int64)
    toks[:, 1:4] = np.random.default_rng(7).integers(1, 60, size=(b, 3))
    toks[:, 4] = 63  # EOT, the highest id
    return toks


def _j_clip(act="quick_gelu"):
    return jrn.CLIPResNet(**TINY_RN, act=act)


def test_frozen_batchnorm_matches_torch_eval_batchnorm():
    bn = torch.nn.BatchNorm2d(8).eval()
    m = trn.FrozenBatchNorm(8)
    sd = draw_(m, 0)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    x = torch.from_numpy(normal(1, 2, 8, 4, 4))
    with torch.no_grad():
        np.testing.assert_allclose(m(x).numpy(), bn(x).numpy(), atol=1e-5)
        before = m.running_mean.clone()
        m.train()(x)
    assert torch.equal(m.running_mean, before)  # frozen in train mode too


@pytest.mark.parametrize("stride,inplanes", [(1, 128), (1, 32), (2, 32)])
def test_bottleneck_matches_jax(stride, inplanes):
    m = trn.Bottleneck(inplanes, 32, stride)
    assert (m.downsample is None) == (stride == 1 and inplanes == 128)
    sd = draw_(m, 2)
    params = {"params": ti._bottleneck({f"b.{k}": v for k, v in sd.items()}, "b")}
    x = normal(3, 2, 8, 8, inplanes)
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(got, jrn.Bottleneck(32, stride).apply(params, x))


def test_attention_pool_matches_jax():
    m = trn.AttentionPool2d(3, 64, 4, 24)
    sd = draw_(m, 4)
    params = {"params": {"positional_embedding": sd["positional_embedding"],
                         **{n: ti._dense(sd, n) for n in ("q_proj", "k_proj", "v_proj",
                                                          "c_proj")}}}
    x = normal(5, 2, 3, 3, 64)
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 24)
    assert_close(got, jrn.AttentionPool2d(4, 24).apply(params, x))


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_resnet_encodes_match_jax(act):
    """The whole perceptor: the ResNet tower (stem, four stages, attention pool)
    and the text tower, JAX taking the port's weights through convert_clip_resnet."""
    m = trn.CLIPResNet(TINY_RN, act)
    sd = draw_(m, 6)
    params = ti.convert_clip_resnet(sd)
    jm = _j_clip(act)
    imgs, toks = _images(8), _tokens()
    with torch.no_grad():
        got_i = m.encode_image(torch.from_numpy(imgs))
        got_t = m.encode_text(torch.from_numpy(toks))
    assert got_i.dtype == torch.float32 and got_i.shape == (2, 24)
    assert_close(got_i, jm.apply(params, jnp.asarray(imgs), method=jm.encode_image))
    assert_close(got_t, jm.apply(params, jnp.asarray(toks, jnp.int32), method=jm.encode_text))


def test_from_jax_round_trip():
    jm = _j_clip()
    tree = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 12), jnp.int32),
                            jnp.zeros((1, 64, 64, 3)))
    tree = jax.tree.map(np.asarray, tree)
    m = trn.CLIPResNet(TINY_RN)
    m.load_state_dict(clip_resnet_state_dict(tree))
    again = ti.convert_clip_resnet({k: v.numpy() for k, v in m.state_dict().items()})
    want = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(again)}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


def _cloob_layout(sd, prefix=""):
    """An OpenAI-named RN state dict in the ml-jku CLOOB layout: the text tower
    under `transformer.`, `logit_inv_tau`, the loss-only `logit_scale_hopfield`;
    every key under `prefix` (`module.`: saved from DDP)."""
    out = {}
    for k, v in sd.items():
        k = "logit_inv_tau" if k == "logit_scale" else k
        out[k if k.startswith("visual.") or k == "logit_inv_tau" else f"transformer.{k}"] = v
    out["logit_scale_hopfield"] = np.float32(3.0)
    return {prefix + k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


@pytest.fixture
def tiny_rn50(monkeypatch):
    """RN50 and RN50x4 as the tiny RN in both packages' registries."""
    for reg in (registry.CLIP_RESNET_CONFIGS, jax_registry.CLIP_RESNET_CONFIGS):
        monkeypatch.setitem(reg, "RN50", TINY_RN)
        monkeypatch.setitem(reg, "RN50x4", TINY_RN)


def test_cloob_layout_loads_and_matches_jax(tiny_rn50, tmp_path):
    """The CLOOB layout, and the same under DDP's `module.` prefix, load into
    the port's RN50 tower as the OpenAI-named weights; the JAX package reads the
    unprefixed file."""
    m = trn.CLIPResNet(TINY_RN)
    sd = draw_(m, 9)
    path, ddp = str(tmp_path / "cloob_rn50.pt"), str(tmp_path / "cloob_rn50_ddp.pt")
    torch.save(_cloob_layout(sd), path)
    torch.save({"state_dict": _cloob_layout(sd, "module.")}, ddp)
    for file in (path, ddp):
        p = load_perceptor("cloob_rn50", file, dtype=torch.float32, device="cpu")
        assert isinstance(p.module, trn.CLIPResNet) and not p.module.training
        for k, v in p.module.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    jp = j_load_perceptor("cloob_rn50", path, dtype=jnp.float32)
    imgs, toks = _images(10), _tokens()
    assert_close(p.encode_image(torch.from_numpy(imgs)), jp.encode_image(jnp.asarray(imgs)))
    assert_close(p.encode_text(torch.from_numpy(toks)),
                 jp.encode_text(jnp.asarray(toks, jnp.int32)))
    text = load_perceptor("cloob_rn50", path, dtype=torch.float32, device="cpu", image=False)
    assert type(text.module) is TextTransformer
    np.testing.assert_array_equal(text.encode_text(torch.from_numpy(toks)).numpy(),
                                  p.encode_text(torch.from_numpy(toks)).numpy())


@pytest.mark.parametrize("name,act", [("RN50", "quick_gelu"), ("cloob_rn50", "quick_gelu"),
                                      ("cloob_rn50x4", "quick_gelu"),
                                      ("openclip/RN50-quickgelu/x", "quick_gelu"),
                                      ("openclip/RN50/yfcc15m", "gelu")])
def test_routing_matches_jax(tiny_rn50, name, act):
    """Each name builds the RN tower with the JAX route's activation, name, size
    and width (a cloob name reports the cloob entries of CLIP_SIZE / CLIP_DIM)."""
    p = load_perceptor(name, dtype=torch.float32, device="cpu")
    jp = j_load_perceptor(name, dtype=jnp.float32)
    assert isinstance(p.module, trn.CLIPResNet) and isinstance(jp.module, jrn.CLIPResNet)
    assert (p.name, p.size, p.dim) == (jp.name, jp.size, jp.dim)
    acts = {b.mlp.act for b in p.module.transformer.resblocks}
    assert acts == {act} == {jp.module.act}
    assert not any(q.requires_grad for q in p.module.parameters())


def test_registry_sizes_build():
    """Registry RN configs at their real widths (on the meta device): the image
    tower's stages, channels and the attention pool's position rows."""
    for name in ("RN101", "RN50x16"):
        cfg = registry.CLIP_RESNET_CONFIGS[name]
        m = trn.CLIPResNet(cfg, device="meta")
        grid = cfg["image_size"] // 32
        assert m.visual.attnpool.positional_embedding.shape == (grid * grid + 1,
                                                                cfg["vision_width"] * 32)
        assert len(m.visual.layer3) == cfg["vision_layers"][2]
        assert m.visual.attnpool.c_proj.weight.shape == (cfg["embed_dim"],
                                                         cfg["vision_width"] * 32)


@pytest.mark.parametrize("name", ["cloob_laion_400m_vit_b_16_32_epochs",
                                  "openclip/convnext_base/laion400m"])
def test_unported_perceptors_raise(name):
    with pytest.raises(NotImplementedError, match="A15b"):
        load_perceptor(name, dtype=torch.float32, device="cpu")

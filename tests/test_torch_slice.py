"""The port's whole prompt->image slice against the JAX package's, at tiny size.

The composition is `prompt_to_image` of __graft_entry__.entry: CLIP text encode ->
Mixer mapper -> clamp to the latent bounds -> straight-through VQ -> VQGAN
decode -> [0, 1]. Weights are numpy draws shared by both sides (the JAX side
through its own torch_import converters, the CLIP text tower through
io/from_jax.py). Tolerances in float32: equal VQ indices, images within 1e-4.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from feed_forward_vqgan_clip_tpu.io.images import make_grid as j_make_grid
from feed_forward_vqgan_clip_tpu.io.torch_import import convert_mixer, convert_vqgan
from feed_forward_vqgan_clip_tpu.models import clip_vit as jclip
from feed_forward_vqgan_clip_tpu.models import vqgan as jvq
from feed_forward_vqgan_clip_tpu.models.mappers.fused import make_mapper_apply as j_mapper_apply
from feed_forward_vqgan_clip_tpu.models.mappers.mixer import Mixer as JMixer
from feed_forward_vqgan_clip_tpu.ops.grad_ops import clamp_with_grad as j_clamp
from feed_forward_vqgan_clip_tpu.ops.quantize import nearest_codebook_indices as j_nearest
from feed_forward_vqgan_clip_tpu.registry import CLIP_VIT_CONFIGS
from feed_forward_vqgan_clip_tpu_torch.entry import example_tokens
from feed_forward_vqgan_clip_tpu_torch.infer import Generator, build_generator
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import clip_text_state_dict
from feed_forward_vqgan_clip_tpu_torch.io.images import encode_png, make_grid, save_grid
from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip
from feed_forward_vqgan_clip_tpu_torch.models.mappers.fused import make_mapper_apply
from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import Mixer
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import Perceptor
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import make_vqgan
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
    mixer_block,
    mixer_block_plain,
)
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.vq_lookup import (
    nearest_codebook_indices_kernel,
    nearest_codebook_indices_plain,
)
from feed_forward_vqgan_clip_tpu_torch.ops.quantize import quantize_indices

REPO = Path(__file__).resolve().parents[1]
TINY_VQ = dict(n_embed=32, embed_dim=8, z_channels=8, ch=8, ch_mult=(1, 2),
               num_res_blocks=1, attn_resolutions=(4,), resolution=8)


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


def _tiny_pair(rng):
    """(JAX prompt_to_image closure, port Generator) on the same tiny weights."""
    cfg = CLIP_VIT_CONFIGS["tiny"]
    jclip_m = jclip.make_clip("tiny")
    text = jclip.TextTransformer(
        context_length=cfg["context_length"], vocab_size=cfg["vocab_size"],
        width=cfg["text_width"], layers=cfg["text_layers"], heads=cfg["text_heads"],
        embed_dim=cfg["embed_dim"])
    tp = jax.jit(text.init)(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))["params"]
    tp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), tp)
    cp = {"params": {"text": tp, "logit_scale": np.float32(4.6052)}}
    tclip = make_clip("tiny")
    tclip.load_state_dict(clip_text_state_dict(cp))

    tvq = make_vqgan(TINY_VQ)
    vsd = _random_state_dict(tvq, rng)
    tvq.load_state_dict(vsd)
    vp = convert_vqgan({k: v.numpy() for k, v in vsd.items()}, TINY_VQ)
    jvq_m = jvq.make_vqgan(TINY_VQ)

    tmap = Mixer(input_dim=32, image_size=4, channels=8, dim=16, depth=2)
    msd = _random_state_dict(tmap, rng)
    tmap.load_state_dict(msd)
    mp = convert_mixer({k: v.numpy() for k, v in msd.items()}, 2)
    jmap = JMixer(input_dim=32, image_size=4, channels=8, dim=16, depth=2)
    mapper_apply = j_mapper_apply(jmap)

    @jax.jit
    def prompt_to_image(tokens):  # __graft_entry__.entry's composition
        h = jclip_m.apply(cp, tokens, method=jclip_m.encode_text)
        z = mapper_apply(mp, h.astype(jnp.float32))
        lo, hi = jvq.latent_bounds(vp)
        z = j_clamp(z, lo, hi)
        return jvq.synth(jvq_m, vp, z), z

    perceptor = Perceptor(module=tclip.eval(), name="tiny", size=32, dim=32)
    return prompt_to_image, vp, Generator(perceptor, tmap, tvq)


def _requests(rng):
    toks = example_tokens(4).numpy().astype(np.int32)
    toks[1, 1:4] = rng.integers(1, 49000, size=3)
    toks[1, 4] = 49407
    toks[2, 1:9] = rng.integers(1, 49000, size=8)
    toks[2, 9] = 49407
    return toks


def test_tiny_slice_matches_jax_prompt_to_image(rng):
    prompt_to_image, vp, gen = _tiny_pair(rng)
    toks = _requests(rng)
    ref_img, ref_z = prompt_to_image(jnp.asarray(toks))
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        h = gen.encode_tokens(tt)
        lo, hi = gen.vq.codebook().min(), gen.vq.codebook().max()
        z = gen._mapper_apply(h).clamp(lo, hi)
        img = gen.render(h)
    assert img.shape == (4, 8, 8, 3) and img.dtype == torch.float32
    np.testing.assert_allclose(z.numpy(), np.asarray(ref_z), atol=1e-5, rtol=1e-4)
    idx = quantize_indices(z, gen.vq.codebook().detach())
    ref_idx = j_nearest(ref_z, jnp.asarray(vp["params"]["codebook"]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert float(np.abs(img.numpy() - np.asarray(ref_img)).max()) <= 1e-4


def test_port_imports_no_jax_flax_yaml_pil(tmp_path):
    """Every port module imports, and the CPU slice runs, in a process where jax,
    flax, yaml and PIL are never imported."""
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        import feed_forward_vqgan_clip_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        import torch
        from feed_forward_vqgan_clip_tpu_torch.entry import example_tokens
        from feed_forward_vqgan_clip_tpu_torch.infer import build_generator
        from feed_forward_vqgan_clip_tpu_torch.io.images import save_grid
        vq = dict(n_embed=32, embed_dim=8, z_channels=8, ch=8, ch_mult=(1, 2),
                  num_res_blocks=1, attn_resolutions=(4,), resolution=8)
        gen = build_generator(clip_model="tiny", vqgan_config=vq, dim=16, depth=2,
                              vq_image_size=4, dtype=torch.float32, device="cpu")
        img = gen.render(gen.encode_tokens(example_tokens(2)))
        assert img.shape == (2, 8, 8, 3) and bool(torch.isfinite(img).all())
        save_grid(img.numpy(), {str(tmp_path / "grid.png")!r})
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "yaml", "PIL"))
        assert not bad, bad
        print("CLEAN")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CLEAN" in out.stdout
    assert (tmp_path / "grid.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_wrappers_take_plain_path_on_cpu(rng):
    """On CPU tensors the kernel wrappers run the plain versions, bit for bit, and
    leave their launch counters alone."""
    vq0, mix0 = nearest_codebook_indices_kernel.launches, mixer_block.launches
    x = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    cb = torch.from_numpy(rng.normal(size=(30, 8)).astype(np.float32))
    np.testing.assert_array_equal(nearest_codebook_indices_kernel(x, cb).numpy(),
                                  nearest_codebook_indices_plain(x, cb).numpy())
    tmap = Mixer(input_dim=8, image_size=4, channels=8, dim=16, depth=1)
    tmap.load_state_dict(_random_state_dict(tmap, rng))
    w = tmap.blocks[0].kernel_weights(torch.float32)
    h = torch.from_numpy(rng.normal(size=(2, 16, 16)).astype(np.float32))
    np.testing.assert_array_equal(mixer_block(h, w).numpy(), mixer_block_plain(h, w).numpy())
    with torch.no_grad():
        make_mapper_apply(tmap)(torch.zeros(1, 8))
    assert nearest_codebook_indices_kernel.launches == vq0
    assert mixer_block.launches == mix0


def test_generator_noise_and_repeats():
    gen = build_generator(clip_model="tiny", vqgan_config=TINY_VQ, dim=16, depth=1,
                          vq_image_size=4, noise_dim=8, dtype=torch.float32, device="cpu",
                          seed=1)
    assert gen.mapper.input_dim == 32 + 8
    h = gen.encode_tokens(example_tokens(2))
    a = gen.generate(h, nb_repeats=3, generator=torch.Generator().manual_seed(5))
    b = gen.generate(h, nb_repeats=3, generator=torch.Generator().manual_seed(5))
    assert a.shape == (6, 8, 8, 3)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def test_example_tokens_match_graft_entry():
    toks = example_tokens(4)
    assert toks.shape == (4, 77) and toks.dtype == torch.long
    assert toks[:, :3].tolist() == [[49406, 320, 49407]] * 4
    assert int(toks[:, 3:].abs().sum()) == 0


def test_png_and_grid(rng, tmp_path):
    from PIL import Image  # the test may use Pillow to read; the port never does

    imgs = rng.uniform(size=(5, 6, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(make_grid(imgs, nrow=2), j_make_grid(imgs, nrow=2))
    path = tmp_path / "g.png"
    save_grid(imgs, str(path), nrow=2)
    got = np.asarray(Image.open(path))
    want = (np.clip(make_grid(imgs, nrow=2), 0, 1) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    grey = encode_png(imgs[0, :, :, :1])
    np.testing.assert_array_equal(np.asarray(Image.open(__import__("io").BytesIO(grey))),
                                  (imgs[0, :, :, 0] * 255 + 0.5).astype(np.uint8))


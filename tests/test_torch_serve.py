"""The port's serving path against the JAX package's: `.th` checkpoints, the
`Predictor`, the `test` command and the app callback, at tiny size on the CPU;
with a flow prior (a tiny prior `.th` of numpy draws, tests/test_torch_flow.py)
through both Predictors and Generators, the prior's z pinned on both sides
(the mapper input within 2e-4 of max(1, max |JAX|)).

A tiny Mixer mapper (numpy draws) is written by the port's `save_model`; the JAX
side loads it with its own `io.checkpoint.load_model`. The JAX Predictor's CLIP
("tiny") and VQGAN (inline arch) are its random inits, carried into the port's
Predictor by io/from_jax.py. Both read the synthetic BPE table of
tests/test_tokenizer.py through FFVC_BPE_PATH. Tolerances: mapper outputs in
float32 within 1e-5 of max |JAX|; PNG grids within 2/255 per pixel (the port's
1x1 and 2x2 requests take the streamed forward with LN2 folded into W1, the
JAX Predictor on the CPU its per-block forward; the same function in float32).
"""

import gzip
import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.infer import test as j_infer_test
from feed_forward_vqgan_clip_tpu.io import checkpoint as jckpt
from feed_forward_vqgan_clip_tpu.models.mappers.fused import make_mapper_apply as j_mapper_apply
from feed_forward_vqgan_clip_tpu.serve.predictor import Predictor as JPredictor
from feed_forward_vqgan_clip_tpu.tokenizer import bpe as jbpe
from feed_forward_vqgan_clip_tpu_torch import infer
from feed_forward_vqgan_clip_tpu_torch.config import make_config
from feed_forward_vqgan_clip_tpu_torch.io import checkpoint
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import clip_text_state_dict, vqgan_state_dict
from feed_forward_vqgan_clip_tpu_torch.io.images import decode_png, encode_png
from feed_forward_vqgan_clip_tpu_torch.models import flow
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import latent_bounds, load_vqgan, make_vqgan
from feed_forward_vqgan_clip_tpu_torch.serve import app
from feed_forward_vqgan_clip_tpu_torch.serve import predictor as predictor_mod
from feed_forward_vqgan_clip_tpu_torch.serve.predictor import Predictor
from feed_forward_vqgan_clip_tpu_torch.tokenizer import bpe
from test_torch_flow import random_prior

TINY_VQ = dict(n_embed=32, embed_dim=8, z_channels=8, ch=8, ch_mult=(1, 2),
               num_res_blocks=1, attn_resolutions=(4,), resolution=8)
CFG = dict(clip_model="tiny", vqgan_arch=TINY_VQ, model_type="mlp_mixer", dim=16, depth=2,
           dropout=0, vq_image_size=4, compute_dtype="float32", noise_dim=0,
           normalize_input=True)
MERGES = ["h e", "l l", "he ll", "o</w> !</w>", "hell o</w>", "w o", "r l", "wo rl",
          "worl d</w>"]
PROMPT = "hello world"


def _mapper(cfg, seed):
    """The config's mapper with numpy draws: matrices N(0, 1/fan_in), norm scales
    1 + N(0, 0.1), biases and shifts N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    mapper = build_mapper(cfg, vq_channels=TINY_VQ["z_channels"])
    sd = {}
    for k, v in mapper.state_dict().items():
        a = (rng.normal(size=v.shape) / np.sqrt(np.prod(v.shape[1:])) if v.dim() >= 2
             else 0.1 * rng.normal(size=v.shape) + (k.endswith("weight") and "norm" in k))
        sd[k] = torch.from_numpy(a.astype(np.float32))
    mapper.load_state_dict(sd)
    return mapper.eval()


@pytest.fixture
def bpe_table(tmp_path, monkeypatch):
    """The synthetic merge table as a .txt.gz through FFVC_BPE_PATH, for both
    packages (the JAX tokenizer on its pure-Python path, which the port copies)."""
    path = tmp_path / "merges.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as fd:
        fd.write("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    monkeypatch.setenv("FFVC_BPE_PATH", str(path))
    bpe.get_tokenizer.cache_clear()
    jbpe.get_tokenizer.cache_clear()
    jbpe.get_tokenizer()._native = None
    yield
    bpe.get_tokenizer.cache_clear()
    jbpe.get_tokenizer.cache_clear()


@pytest.fixture
def model_path(tmp_path):
    return checkpoint.save_model(str(tmp_path / "tiny_mixer.th"), _mapper(CFG, 0), CFG)


def _carry_jax_frozen(jpred, pred):
    """The JAX Predictor's CLIP and VQGAN weights into the port's (one of each)."""
    (pkey, jperc), = jpred.perceptors.items()
    pred.perceptors[pkey].module.load_state_dict(clip_text_state_dict(jperc.params))
    (_, jvp, _), = jpred.vqgans.values()
    (vkey, (vq, _)), = pred.vqgans.items()
    vq.load_state_dict(vqgan_state_dict(jvp))
    pred.vqgans[vkey] = (vq, latent_bounds(vq))


def _png(path):
    from PIL import Image  # the JAX package writes with Pillow; the port never reads with it

    return np.asarray(Image.open(path)).astype(np.int32)


def test_save_model_loads_in_both_packages(tmp_path):
    cfg = dict(CFG, noise_dim=4)
    mapper = _mapper(cfg, 1)
    bank = np.random.default_rng(2).normal(size=(5, 4)).astype(np.float32)
    path = checkpoint.save_model(str(tmp_path / "m.th"), mapper, cfg, noise=bank, step=7)
    jmapper, jparams, jcfg, jnoise = jckpt.load_model(path)
    got_mapper, got_cfg, got_noise = checkpoint.load_model(path, device="cpu")
    for k, v in cfg.items():
        assert got_cfg[k] == jcfg[k] == v, k
    np.testing.assert_array_equal(got_noise.numpy(), bank)
    np.testing.assert_array_equal(np.asarray(jnoise), bank)
    assert not any(p.requires_grad for p in got_mapper.parameters())
    x = np.random.default_rng(3).normal(size=(3, 32 + 4)).astype(np.float32)
    ref = np.asarray(j_mapper_apply(jmapper)(jparams, x))
    with torch.no_grad():
        want = mapper(torch.from_numpy(x)).numpy()
        got = got_mapper(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-5


# the other mapper families at tiny size: head counts that do not divide the width
FAMILIES = {
    "vitgan": dict(CFG, model_type="vitgan", vq_image_size=8, num_heads=3),
    "simple_vitgan": dict(CFG, model_type="simple_vitgan", num_heads=3),
    "xtransformer": dict(CFG, model_type="xtransformer", num_heads=2),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_save_model_loads_in_jax_for_every_family(family, tmp_path):
    """A `.th` the port writes for each non-Mixer family: the JAX package's
    load_model builds the same mapper from it, and both load it to the same
    outputs (float32, within 1e-5 of max |JAX|)."""
    cfg = FAMILIES[family]
    mapper = _mapper(cfg, 7)
    path = checkpoint.save_model(str(tmp_path / f"{family}.th"), mapper, cfg, step=3)
    jmapper, jparams, jcfg, _ = jckpt.load_model(path)
    got_mapper, got_cfg, _ = checkpoint.load_model(path, device="cpu")
    assert type(got_mapper) is type(mapper) and got_cfg["model_type"] == family
    x = np.random.default_rng(8).normal(size=(3, 32)).astype(np.float32)
    ref = np.asarray(jmapper.apply(jparams, x))
    with torch.no_grad():
        got = got_mapper(torch.from_numpy(x)).numpy()
    side = cfg["vq_image_size"]
    assert got.shape == ref.shape == (3, side, side, TINY_VQ["z_channels"])
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("family", ["vitgan", "xtransformer"])
def test_predictor_serves_other_families_like_jax(family, bpe_table, tmp_path):
    """The Predictor serves a VitGAN and an x-transformer `.th` through the
    module path (no streamed weights), PNG grids within 2/255 of the JAX
    Predictor's at 1x1 and 2x2."""
    cfg = FAMILIES[family]
    path = checkpoint.save_model(str(tmp_path / f"{family}.th"), _mapper(cfg, 9), cfg)
    jpred = JPredictor([path])
    jpred.setup()
    pred = Predictor([path], device="cpu")
    pred.setup()
    _carry_jax_frozen(jpred, pred)
    name = f"{family}.th"
    assert list(pred.models) == [name] and not pred._stream_params
    side = 2 * cfg["vq_image_size"]  # the tiny VQGAN upsamples twice
    for n in (1, 2):
        grid = f"{n}x{n}"
        assert pred.route(name, n * n) == "block"
        got = _png(pred.predict(PROMPT, model=name, grid_size=grid, seed=0,
                                out_path=str(tmp_path / f"port_{grid}.png")))
        want = _png(jpred.predict(PROMPT, model=name, grid_size=grid, seed=0,
                                  out_path=str(tmp_path / f"jax_{grid}.png")))
        assert got.shape == want.shape == (2 + n * (side + 2), 2 + n * (side + 2), 3)
        assert len(np.unique(got[2:side, 2:side])) > 10  # an image, not a flat tile
        assert np.abs(got - want).max() <= 2, grid


def test_load_model_raises_on_formats_it_does_not_read(tmp_path):
    """An unknown model_type raises NotImplementedError (the Predictor skips it,
    as the JAX Predictor does); a directory without meta.json, or a whole
    module without a `.config`, is no checkpoint at all."""
    bad = dict(CFG, model_type="transformer")
    torch.save({"state_dict": {}, "config": bad, "step": 0, "epoch": 0}, tmp_path / "bad.th")
    with pytest.raises(NotImplementedError, match="model_type"):
        checkpoint.load_model(str(tmp_path / "bad.th"), device="cpu")
    with pytest.raises(FileNotFoundError):  # a directory without params.msgpack / meta.json
        checkpoint.load_model(str(tmp_path), device="cpu")
    torch.save(_mapper(CFG, 0), tmp_path / "legacy.th")  # a whole module with no .config
    with pytest.raises(ValueError, match="config"):
        checkpoint.load_model(str(tmp_path / "legacy.th"), device="cpu")


def test_predictor_grids_match_jax(bpe_table, model_path, tmp_path, monkeypatch):
    """The same PNG grids within 2/255 at 1x1, 2x2 (the streamed route) and 3x3
    (n = 9, the per-block route); a spy records the route of each request."""
    jpred = JPredictor([model_path])
    jpred.setup()
    pred = Predictor([model_path], device="cpu")
    pred.setup()
    _carry_jax_frozen(jpred, pred)
    (name,) = pred.models
    assert list(jpred.models) == [name]
    routes = []
    stream = predictor_mod.streamed_mixer_forward
    block = pred._mapper_apply[name]
    monkeypatch.setattr(predictor_mod, "streamed_mixer_forward",
                        lambda *a: routes.append("stream") or stream(*a))
    pred._mapper_apply[name] = lambda x: routes.append("block") or block(x)
    for grid, route in (("1x1", "stream"), ("2x2", "stream"), ("3x3", "block")):
        routes.clear()
        got = _png(pred.predict(PROMPT, model=name, grid_size=grid, seed=0,
                                out_path=str(tmp_path / f"port_{grid}.png")))
        want = _png(jpred.predict(PROMPT, model=name, grid_size=grid, seed=0,
                                  out_path=str(tmp_path / f"jax_{grid}.png")))
        assert routes == [route], grid
        n = int(grid[0])
        assert got.shape == want.shape == (2 + n * 10, 2 + n * 10, 3)
        assert len(np.unique(got[2:10, 2:10])) > 20  # an image, not a flat tile
        assert np.abs(got - want).max() <= 2, grid


@pytest.fixture
def prior_path(tmp_path):
    """A tiny prior `.th` in the reference's format: 2 flows over the tiny CLIP's
    32-d embeddings, numpy draws."""
    port, cfg = random_prior(32, 32, 2, seed=12)
    return flow.save_prior(str(tmp_path / "tiny_prior.th"), port, cfg)


def test_predictor_prior_and_model_choice(bpe_table, model_path, prior_path, tmp_path):
    pred = Predictor([model_path], device="cpu")
    pred.setup()
    assert not pred.priors
    # prior=True with no prior loaded is ignored; model=None picks a loaded model
    a = _png(pred.predict(PROMPT, prior=True, seed=4, out_path=str(tmp_path / "a.png")))
    b = _png(pred.predict(PROMPT, model="tiny_mixer.th", seed=4,
                          out_path=str(tmp_path / "b.png")))
    np.testing.assert_array_equal(a, b)
    # with a prior for the model, prior=True changes the images and prior=False does not
    with_prior = Predictor([model_path], {"tiny_mixer.th": prior_path}, device="cpu")
    with_prior.setup()
    assert list(with_prior.priors) == [prior_path]
    c = _png(with_prior.predict(PROMPT, prior=True, seed=4, out_path=str(tmp_path / "c.png")))
    d = _png(with_prior.predict(PROMPT, seed=4, out_path=str(tmp_path / "d.png")))
    np.testing.assert_array_equal(d, b)
    assert np.abs(c - b).max() > 2


def test_predictor_defaults_to_the_released_companion_prior(model_path, prior_path, tmp_path,
                                                            monkeypatch):
    """Without `prior_paths`, a model takes PRIOR_MODELS' prior where that file is
    present; two models of one prior share one loaded copy."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(predictor_mod, "PRIOR_MODELS", {
        "tiny_mixer.th": "tiny_prior.th", "other.th": "tiny_prior.th",
        "third.th": "missing_prior.th"})
    other = checkpoint.save_model(str(tmp_path / "other.th"), _mapper(CFG, 5), CFG)
    third = checkpoint.save_model(str(tmp_path / "third.th"), _mapper(CFG, 6), CFG)
    pred = Predictor([model_path, other, third], device="cpu")
    pred.setup()
    assert list(pred.priors) == ["tiny_prior.th"]
    assert pred.model_prior == {"tiny_mixer.th": "tiny_prior.th", "other.th": "tiny_prior.th"}


def _pin_jax_prior(jprior, z, record):
    """The JAX prior's sample as the reverse of the pinned z, its output recorded."""
    def sample(key, h):
        out = jprior.flow.apply(jprior.variables, jnp.asarray(z), h, method=jprior.flow.reverse)
        record.append(np.asarray(out))
        return out

    jprior.sample = sample


def test_predictor_prior_sample_matches_jax(bpe_table, model_path, prior_path, tmp_path,
                                            monkeypatch):
    """prior=True at 2x2 with the prior's z pinned on both sides: the port's
    mapper input equals JAX Prior.reverse's (float32, 2e-4 of max(1, max |JAX|)),
    and the PNG grids agree within 2/255."""
    jpred = JPredictor([model_path], {"tiny_mixer.th": prior_path})
    jpred.setup()
    pred = Predictor([model_path], {"tiny_mixer.th": prior_path}, device="cpu")
    pred.setup()
    _carry_jax_frozen(jpred, pred)
    z = np.random.default_rng(13).normal(size=(4, 32)).astype(np.float32)
    want = []
    _pin_jax_prior(jpred.priors[prior_path], z, want)
    pred.priors[prior_path].noise = lambda n, gen: torch.from_numpy(z[:n])
    got = []
    stream = predictor_mod.streamed_mixer_forward
    monkeypatch.setattr(predictor_mod, "streamed_mixer_forward",
                        lambda m, p, x: got.append(x.clone()) or stream(m, p, x))
    a = _png(pred.predict(PROMPT, prior=True, grid_size="2x2", seed=0,
                          out_path=str(tmp_path / "port.png")))
    b = _png(jpred.predict(PROMPT, prior=True, grid_size="2x2", seed=0,
                           out_path=str(tmp_path / "jax.png")))
    (x,), (ref,) = got, want
    assert x.shape == ref.shape == (4, 32)
    assert float(np.abs(x.numpy() - ref).max()) <= 2e-4 * max(1.0, float(np.abs(ref).max()))
    assert a.shape == b.shape and np.abs(a - b).max() <= 2


def test_generator_with_prior_matches_jax(model_path, prior_path, monkeypatch):
    """Generator.from_checkpoint(prior_path=...) on the CPU: the prior samples
    after the tile and before the noise (noise_dim 4, no bank), its z pinned on
    both sides; images within 2/255 of the JAX Generator's."""
    import feed_forward_vqgan_clip_tpu.infer as jinfer

    cfg = dict(CFG, noise_dim=4)
    path = checkpoint.save_model(model_path.replace("tiny_mixer", "noisy"), _mapper(cfg, 14), cfg)
    jgen = jinfer.Generator(path, prior_path=prior_path)
    gen = infer.Generator.from_checkpoint(path, prior_path=prior_path, device="cpu")
    gen.perceptor.module.load_state_dict(clip_text_state_dict(jgen.perceptor.params))
    gen.vq.load_state_dict(vqgan_state_dict(jgen.vq_params))
    z = np.random.default_rng(15).normal(size=(6, 32)).astype(np.float32)
    _pin_jax_prior(jgen.prior, z, [])
    gen.prior.noise = lambda n, g: torch.from_numpy(z[:n])
    # the noise columns: the same Gaussian rows on both sides
    nz = np.random.default_rng(16).normal(size=(6, 4)).astype(np.float32)
    monkeypatch.setattr(jinfer.jax.random, "normal", lambda key, shape: jnp.asarray(nz))
    monkeypatch.setattr(infer, "noise_rows", lambda *a: torch.from_numpy(nz))
    h = np.random.default_rng(17).normal(size=(3, 32)).astype(np.float32)
    want = np.asarray(jgen.generate(jnp.asarray(h), nb_repeats=2, seed=0))
    got = gen.generate(torch.from_numpy(h), nb_repeats=2, seed=0).numpy()
    assert got.shape == want.shape == (6, 8, 8, 3)
    assert np.abs(got - want).max() <= 2 / 255


def test_predictor_setup_dedups_and_skips_unported(model_path, tmp_path):
    other = checkpoint.save_model(str(tmp_path / "other.th"), _mapper(CFG, 5), CFG)
    unknown = str(tmp_path / "unknown.th")  # a model_type no package builds: skipped
    torch.save({"state_dict": {}, "config": dict(CFG, model_type="transformer"), "step": 0,
                "epoch": 0}, unknown)
    pred = Predictor([model_path, other, unknown], device="cpu")
    pred.setup()
    assert sorted(pred.models) == ["other.th", "tiny_mixer.th"]
    assert len(pred.perceptors) == 1 and len(pred.vqgans) == 1
    assert sorted(pred._stream_params) == ["other.th", "tiny_mixer.th"]
    assert pred.route("other.th", 8) == "stream" and pred.route("other.th", 9) == "block"


def test_infer_test_matches_jax(bpe_table, model_path, tmp_path, monkeypatch):
    """The `test` command: '|'-separated prompts, nb_repeats, the grid. The JAX
    Generator's random CLIP and VQGAN init is carried into the port's."""
    import feed_forward_vqgan_clip_tpu.infer as jinfer

    built = {}
    j_generator = jinfer.Generator

    def keep(*a, **k):
        built["gen"] = j_generator(*a, **k)
        return built["gen"]

    monkeypatch.setattr(jinfer, "Generator", keep)
    j_infer_test(model_path, "hello world|hello", nb_repeats=2, seed=1,
                 out_path=str(tmp_path / "jax.png"))
    jgen = built["gen"]
    from_checkpoint = infer.Generator.from_checkpoint

    def carried(*a, **k):
        gen = from_checkpoint(*a, **k)
        gen.perceptor.module.load_state_dict(clip_text_state_dict(jgen.perceptor.params))
        gen.vq.load_state_dict(vqgan_state_dict(jgen.vq_params))
        return gen

    monkeypatch.setattr(infer.Generator, "from_checkpoint", carried)
    out = infer.test(model_path, "hello world|hello", nb_repeats=2, seed=1,
                     out_path=str(tmp_path / "port.png"), device="cpu")
    got, want = _png(out), _png(tmp_path / "jax.png")
    assert got.shape == want.shape == (2 + 2 * 10, 2 + 2 * 10, 3)
    assert np.abs(got - want).max() <= 2


def test_decode_png_reads_what_encode_png_writes():
    img = np.random.default_rng(0).uniform(size=(5, 7, 3)).astype(np.float32)
    want = (img * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(img)), want)
    np.testing.assert_array_equal(decode_png(encode_png(img[:, :, :1])), want[:, :, :1])
    with pytest.raises(ValueError):
        decode_png(b"GIF89a")


def test_noise_rows_follow_the_bank_rules():
    bank = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    gen = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(infer.noise_rows(4, 2, bank, gen, "cpu"), bank[:4])
    rows = infer.noise_rows(9, 2, bank, gen, "cpu")  # a bank of at most n rows: sampled
    assert rows.shape == (9, 2) and all(any(torch.equal(r, b) for b in bank) for r in rows)
    assert infer.noise_rows(6, 2, bank, gen, "cpu").shape == (6, 2)
    g = infer.noise_rows(3, 5, None, torch.Generator().manual_seed(1), "cpu")
    torch.testing.assert_close(g, torch.randn(3, 5, generator=torch.Generator().manual_seed(1)))


@pytest.mark.parametrize("codebook", ["quantize.embedding.weight", "quantize.embed.weight"])
def test_load_vqgan_reads_a_taming_checkpoint(tmp_path, codebook):
    """A Lightning {"state_dict": ...} with a Net2Net `first_stage_model.` prefix,
    encoder entries the decode path ignores and the codebook under VQModel's or
    GumbelVQ's name; without a path, a seeded init."""
    src = make_vqgan(TINY_VQ).init_random_(torch.Generator().manual_seed(3))
    named = {codebook if k == "quantize.embedding.weight" else k: v
             for k, v in src.state_dict().items()}
    sd = {f"first_stage_model.{k}": v for k, v in named.items()}
    sd["first_stage_model.encoder.conv_in.weight"] = torch.zeros(8, 3, 3, 3)
    torch.save({"state_dict": sd}, tmp_path / "vq.ckpt")
    cfg = make_config(vqgan_arch=TINY_VQ, vqgan_checkpoint=str(tmp_path / "vq.ckpt"))
    vq = load_vqgan(cfg, torch.float32, device="cpu")
    for k, v in src.state_dict().items():
        assert torch.equal(vq.state_dict()[k], v), k
    a = load_vqgan(make_config(vqgan_arch=TINY_VQ), torch.float32, device="cpu", seed=2)
    b = load_vqgan(make_config(vqgan_arch=TINY_VQ), torch.float32, device="cpu", seed=2)
    assert all(torch.equal(a.state_dict()[k], v) for k, v in b.state_dict().items())


def test_app_callback_and_gradio_gate(bpe_table, model_path, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    fn, names = app.build_fn(out_path=str(tmp_path / "app.png"), device="cpu")
    assert names == ["tiny_mixer.th"]
    for grid, side in (("1x1", 12), ("2x2", 22)):
        for prior in (False, True):
            path = fn(PROMPT, names[0], prior, grid, 3)
            assert _png(path).shape == (side, side, 3)
    assert _png(fn(PROMPT, None, False, "1x1", 1)).shape == (12, 12, 3)
    if importlib.util.find_spec("gradio") is None:
        with pytest.raises(ImportError):
            app.build_app([model_path], device="cpu")


def test_stream_mixer_generator_matches_the_per_block_path():
    """`build_generator(stream_mixer=True)`, what `entry(stream_mixer=True)` (the
    keyword counterpart of FFVC_STREAM_MIXER=1) builds, gives the per-block
    path's images at tiny size (float32)."""
    vq = dict(TINY_VQ, ch=32)
    gens = [infer.build_generator(clip_model="tiny", vqgan_config=vq, dim=32, depth=2,
                                  vq_image_size=4, dtype=torch.float32, device="cpu", seed=3,
                                  stream_mixer=s) for s in (False, True)]
    from feed_forward_vqgan_clip_tpu_torch.entry import example_tokens

    h = gens[0].encode_tokens(example_tokens(2))
    a, b = (g.render(h) for g in gens)
    assert float((a - b).abs().max()) <= 1e-4

"""The port's readers of the JAX package's checkpoint formats, against the JAX package.

  * io/msgpack.py: the writer's bytes equal flax's `to_bytes` (nested trees of
    float32, bfloat16, int32, numpy scalars, lists; a chunked leaf under a
    small MAX_CHUNK_SIZE set in both); the reader equals `msgpack_restore`
    leaf by leaf, bfloat16 bits included.
  * Mapper directories written by the JAX package's `save_checkpoint` (a tiny
    Mixer, VitGAN, SimpleVitGAN, x-transformer, each with a noise bank): the
    port's `load_model` gives the JAX mapper's outputs; config and noise exact.
  * VQGAN directories, current and the older nested GroupNorm layout; CLIP
    directories (ViT, ModifiedResNet); prior directories (and the reverse on a
    pinned z).
  * The reference's legacy whole-module pickles: a stand-in module registered
    under the reference's module name, pickled whole with `.config` and
    `.NOISE`, then unregistered, loads in the port with the stand-in's outputs.
  * The Predictor serves a directory and a legacy pickle, and fails setup() on
    a damaged one.
Tolerance: float32, 2e-4 * max(1, max |JAX|).
"""

import json
import os
import pickle
import sys
import types
import typing

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.config import make_config as j_make_config
from feed_forward_vqgan_clip_tpu.io import checkpoint as jckpt
from feed_forward_vqgan_clip_tpu.models import clip_resnet as jrn
from feed_forward_vqgan_clip_tpu.models import clip_vit as jclip
from feed_forward_vqgan_clip_tpu.models import flow as jflow
from feed_forward_vqgan_clip_tpu.models import vqgan as jvq
from feed_forward_vqgan_clip_tpu.models.mappers import build_mapper as j_build_mapper
from feed_forward_vqgan_clip_tpu_torch.config import make_config
from feed_forward_vqgan_clip_tpu_torch.io import checkpoint, msgpack
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import mixer_state_dict, mixer_tree
from feed_forward_vqgan_clip_tpu_torch.models import flow
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import load_perceptor
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import load_vqgan
from feed_forward_vqgan_clip_tpu_torch.serve.predictor import Predictor
from test_torch_serve import CFG, TINY_VQ, _mapper, bpe_table  # noqa: F401
from test_torch_vitgan import assert_close

def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "params": {"dense": {"kernel": rng.normal(size=(5, 3)).astype(np.float32),
                             "bias": np.zeros(3, np.float32)},
                   "emb": _bf16(rng.normal(size=(7, 4))),
                   "idx": rng.integers(-2**31, 2**31 - 1, size=(40,)).astype(np.int32)},
        "step": np.int32(12), "scale": np.float32(0.5), "count": 300, "neg": -70000,
        "name": "x" * 40, "flag": True, "none": None, "lr": 1e-3,
        "stack": [np.ones((2, 2), np.float32), (np.int64(3), "a")],
        "big": {str(i): np.float32(i) for i in range(20)},
    }


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _bits(v):
    if isinstance(v, torch.Tensor):
        return v.view(torch.uint16).numpy()
    a = np.asarray(v)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("seed", [0, 1])
def test_msgpack_writer_bytes_equal_flax(seed):
    tree = _tree(seed)
    assert msgpack.packb(tree) == fs.to_bytes(tree)


def test_msgpack_writes_torch_bf16_as_flax_writes_its_array():
    a = np.random.default_rng(2).normal(size=(3, 5))
    as_torch = torch.from_numpy(a.astype(np.float32)).bfloat16()
    assert msgpack.packb({"w": as_torch}) == fs.to_bytes({"w": _bf16(a)})


def test_msgpack_chunked_leaf(monkeypatch):
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(10, 7)).astype(np.float32), "bf": _bf16(rng.normal(size=(9, 9))),
            "small": np.ones(3, np.float32)}
    data = fs.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    assert msgpack.packb(tree) == data
    got = msgpack.unpackb(data)
    for k in tree:
        np.testing.assert_array_equal(_bits(got[k]), _bits(tree[k]))


@pytest.mark.parametrize("seed", [0, 1])
def test_msgpack_reader_equals_msgpack_restore(seed):
    data = fs.to_bytes(_tree(seed))
    got, want = dict(_leaves(msgpack.unpackb(data))), dict(_leaves(fs.msgpack_restore(data)))
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (np.ndarray, np.generic)):
            assert isinstance(g, torch.Tensor) == (np.asarray(w).dtype.name == "bfloat16"), k
            np.testing.assert_array_equal(_bits(g), _bits(w))
            assert np.asarray(_bits(g)).dtype == np.asarray(_bits(w)).dtype, k
        else:
            assert g == w and type(g) is type(w), k


def test_msgpack_complex_and_file_round_trip(tmp_path):
    tree = {"c": complex(1.5, -2.0), "a": np.arange(6, dtype=np.float64).reshape(2, 3)}
    data = fs.to_bytes(tree)
    assert msgpack.packb(tree) == data
    path = str(tmp_path / "t.msgpack")
    checkpoint.save_pytree(path, tree)
    got = checkpoint.load_pytree(path)
    assert got["c"] == tree["c"]
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert got["a"].flags.writeable


# ---------------------------------------------------------------- mapper directories

FAMILIES = {
    "mlp_mixer": dict(CFG, noise_dim=4),
    "vitgan": dict(CFG, model_type="vitgan", vq_image_size=8, num_heads=3, noise_dim=4),
    "simple_vitgan": dict(CFG, model_type="simple_vitgan", num_heads=3, noise_dim=4),
    "xtransformer": dict(CFG, model_type="xtransformer", num_heads=2, noise_dim=4),
}


def _jax_mapper(cfg, seed):
    jcfg = j_make_config(**cfg)
    jm = j_build_mapper(jcfg, vq_channels=TINY_VQ["z_channels"])
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 32 + cfg["noise_dim"]), jnp.float32))
    return jm, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_jax_checkpoint_dir_loads_like_jax(family, tmp_path):
    cfg = FAMILIES[family]
    jm, params = _jax_mapper(cfg, 5)
    bank = np.random.default_rng(6).normal(size=(5, 4)).astype(np.float32)
    path = jckpt.save_checkpoint(str(tmp_path), "checkpoint", params, cfg, step=11, epoch=2,
                                 noise=bank)
    tree, got_cfg, step, epoch, noise = checkpoint.load_checkpoint(path)
    assert (step, epoch) == (11, 2)
    mapper, got_cfg, got_noise = checkpoint.load_model(path, device="cpu")
    _, _, jcfg, jnoise = jckpt.load_model(path)
    assert dict(got_cfg) == dict(jcfg) and got_cfg["model_type"] == family
    np.testing.assert_array_equal(got_noise.numpy(), bank)
    np.testing.assert_array_equal(np.asarray(jnoise), bank)
    assert got_noise.dtype == torch.float32 and not any(
        p.requires_grad for p in mapper.parameters())
    x = np.random.default_rng(7).normal(size=(3, 36)).astype(np.float32)
    with torch.no_grad():
        got = mapper(torch.from_numpy(x)).numpy()
    assert_close(got, jm.apply(params, x))


def test_mixer_tree_inverts_mixer_state_dict_and_saves_as_jax_does(tmp_path):
    """mixer_tree(port state dict) is the JAX tree (keys sorted as jax.tree.map
    leaves them): save_pytree's file equals the JAX package's byte for byte."""
    jm, params = _jax_mapper(FAMILIES["mlp_mixer"], 8)
    sd = mixer_state_dict(params)
    tree = mixer_tree(sd)
    a, b = str(tmp_path / "port.msgpack"), str(tmp_path / "jax.msgpack")
    checkpoint.save_pytree(a, tree)
    jckpt.save_pytree(b, params)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_checkpoint_dir_written_by_the_port_loads_in_jax(tmp_path):
    cfg = FAMILIES["mlp_mixer"]
    mapper = _mapper(cfg, 3)
    bank = np.random.default_rng(4).normal(size=(6, 4)).astype(np.float32)
    path = checkpoint.save_checkpoint_dir(str(tmp_path), "ckpt", mixer_tree(mapper.state_dict()),
                                          cfg, step=3, epoch=1, noise=bank)
    jm, jparams, jcfg, jnoise = jckpt.load_model(path)
    np.testing.assert_array_equal(np.asarray(jnoise), bank)
    x = np.random.default_rng(5).normal(size=(2, 36)).astype(np.float32)
    with torch.no_grad():
        want = mapper(torch.from_numpy(x)).numpy()
    assert_close(jm.apply(jparams, x), want)
    got, _, got_noise = checkpoint.load_model(path, device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(got(torch.from_numpy(x)).numpy(), want)


# ---------------------------------------------------------------- VQGAN, CLIP, prior


def _nest_groupnorm(tree):
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias"}:
            return {"GroupNorm_0": dict(tree)}
        return {k: _nest_groupnorm(v) for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("layout", ["current", "nested_groupnorm"])
def test_vqgan_dir_decodes_like_jax(layout, tmp_path):
    jm = jvq.make_vqgan(TINY_VQ, dtype=jnp.float32)
    z0 = jnp.zeros((1, 4, 4, TINY_VQ["z_channels"]), jnp.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3), z0))
    saved = params if layout == "current" else {"params": _nest_groupnorm(params["params"])}
    os.makedirs(tmp_path / "vq")
    jckpt.save_pytree(str(tmp_path / "vq" / "params.msgpack"), saved)
    vq = load_vqgan(make_config(vqgan_arch=TINY_VQ, vqgan_checkpoint=str(tmp_path / "vq")),
                    torch.float32, device="cpu")
    z = np.random.default_rng(4).normal(size=(2, 4, 4, TINY_VQ["embed_dim"])).astype(np.float32)
    with torch.no_grad():
        got = vq.decode_latent(torch.from_numpy(z)).numpy()
    assert_close(got, jm.apply(params, jnp.asarray(z), method=jm.decode_latent))


TINY_RN = dict(image_size=64, vision_layers=(1, 1, 1, 1), vision_width=16, embed_dim=24,
               text_width=32, text_layers=2, text_heads=2, vocab_size=64, context_length=12)


def _tokens(b, vocab, ctx):
    toks = np.zeros((b, ctx), np.int64)
    toks[:, 1:4] = np.random.default_rng(7).integers(1, vocab - 2, size=(b, 3))
    toks[:, 4] = vocab - 1  # EOT, the highest id
    return toks


@pytest.mark.parametrize("family", ["vit", "resnet"])
def test_clip_dir_matches_jax(family, tmp_path, monkeypatch):
    if family == "vit":
        jm = jclip.make_clip("tiny", dtype=jnp.float32)
        name, size, vocab, ctx = "tiny", 32, 49408, 77
    else:
        from feed_forward_vqgan_clip_tpu_torch import registry

        monkeypatch.setitem(registry.CLIP_RESNET_CONFIGS, "RN50", TINY_RN)
        jm, name, size, vocab, ctx = jrn.CLIPResNet(**TINY_RN), "RN50", 64, 64, 12
    toks = _tokens(2, vocab, ctx)
    imgs = np.random.default_rng(8).uniform(-1, 1, size=(2, size, size, 3)).astype(np.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2), jnp.asarray(toks),
                                              jnp.asarray(imgs)))
    os.makedirs(tmp_path / "clip")
    jckpt.save_pytree(str(tmp_path / "clip" / "params.msgpack"), params)
    for image in (True, False):
        p = load_perceptor(name, str(tmp_path / "clip"), dtype=torch.float32, device="cpu",
                           image=image)
        got = p.encode_text(torch.from_numpy(toks))
        assert_close(got, jm.apply(params, jnp.asarray(toks), method=jm.encode_text))
    p = load_perceptor(name, str(tmp_path / "clip"), dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got = p.encode_image(torch.from_numpy(imgs))
    assert_close(got, jm.apply(params, jnp.asarray(imgs), method=jm.encode_image))
    assert float(p.logit_scale) == pytest.approx(float(np.exp(params["params"]["logit_scale"])))


def test_prior_dir_matches_jax(tmp_path):
    model = dict(embedding_dim=4, hidden_dim=16, hidden_depth=1, n_flows=3)
    jf = jflow.build_prior_model({"model": model}, 6, 8)
    variables = jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(1), jnp.zeros((1, 8)),
                                                 jnp.zeros((1, 6))))
    path = tmp_path / "prior"
    os.makedirs(path)
    jckpt.save_pytree(str(path / "params.msgpack"), variables)
    with open(path / "meta.json", "w") as fd:
        json.dump({"config": {"model": model}, "step": 5, "epoch": 0, "input_size": 6,
                   "output_size": 8}, fd)
    prior = flow.load_prior_model(str(path), device="cpu")
    jprior = jflow.load_prior_model(str(path))
    rng = np.random.default_rng(2)
    cond = rng.normal(size=(4, 6)).astype(np.float32)
    x = rng.normal(size=(4, 8)).astype(np.float32)
    z = rng.normal(size=(4, 8)).astype(np.float32)
    with torch.no_grad():
        zt, ld = prior.flow(torch.from_numpy(x), torch.from_numpy(cond))
        rev = prior.reverse(torch.from_numpy(z), torch.from_numpy(cond))
    jz, jld = jprior.flow.apply(jprior.variables, jnp.asarray(x), jnp.asarray(cond))
    assert_close(zt, jz)
    assert_close(ld, jld)
    jrev = jprior.flow.apply(jprior.variables, jnp.asarray(z), jnp.asarray(cond),
                             method=jprior.flow.reverse)
    assert_close(rev, jrev)


# ---------------------------------------------------------------- legacy pickles

REFERENCE_MODULE = "mlp_mixer_pytorch"


def _pickle_stand_in(mapper, cfg, bank, path):
    """`mapper` pickled whole as an instance of a class of the reference's
    module `mlp_mixer_pytorch`, with `.config` (`cfg` as it is) and `.NOISE`,
    the module then unregistered (as in an environment without the reference)."""
    mod = types.ModuleType(REFERENCE_MODULE)

    class MLPMixer(type(mapper)):
        pass

    MLPMixer.__module__ = REFERENCE_MODULE
    MLPMixer.__qualname__ = "MLPMixer"
    mod.MLPMixer = MLPMixer
    sys.modules[REFERENCE_MODULE] = mod
    try:
        mapper.__class__ = MLPMixer
        mapper.config = cfg
        mapper.NOISE = torch.from_numpy(bank)
        torch.save(mapper, path)
    finally:
        del sys.modules[REFERENCE_MODULE]


def test_legacy_whole_module_pickle_loads(tmp_path):
    cfg = FAMILIES["mlp_mixer"]
    mapper = _mapper(cfg, 12)
    x = np.random.default_rng(13).normal(size=(3, 36)).astype(np.float32)
    with torch.no_grad():
        want = mapper(torch.from_numpy(x)).numpy()
    bank = np.random.default_rng(14).normal(size=(4, 4)).astype(np.float32)
    path = str(tmp_path / "legacy.th")
    _pickle_stand_in(mapper, cfg, bank, path)
    with pytest.raises(ModuleNotFoundError):
        torch.load(path, weights_only=False)
    got, got_cfg, noise = checkpoint.load_model(path, device="cpu")
    assert got_cfg["model_type"] == "mlp_mixer" and got_cfg["dim"] == cfg["dim"]
    np.testing.assert_array_equal(noise.numpy(), bank)
    for k, v in mapper.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    with torch.no_grad():
        assert_close(got(torch.from_numpy(x)).numpy(), want)


class _OmegaState:
    """Pickles as omegaconf 2's containers and nodes do: a class of omegaconf's
    module, rebuilt from its __dict__."""

    def __init__(self, **state):
        self.__dict__.update(state)


def _omegaconf_classes():
    mods = {n: types.ModuleType(n) for n in ("omegaconf", "omegaconf.dictconfig",
                                             "omegaconf.listconfig", "omegaconf.nodes",
                                             "omegaconf.base")}
    classes = {}
    for mod, name in [("omegaconf.dictconfig", "DictConfig"), ("omegaconf.listconfig",
                      "ListConfig"), ("omegaconf.nodes", "AnyNode"),
                      ("omegaconf.base", "ContainerMetadata"), ("omegaconf.base", "Metadata")]:
        cls = type(name, (_OmegaState,), {"__module__": mod, "__qualname__": name})
        setattr(mods[mod], name, cls)
        classes[name] = cls
    return mods, classes


def _omegaconf(value, classes, parent=None, key=None):
    """`value` as the tree of containers and nodes OmegaConf.create pickles:
    `_content` (a dict or list of nodes), `_val`, `_metadata`, `_parent`."""
    if isinstance(value, dict):
        node = classes["DictConfig"](_parent=parent, _metadata=classes["ContainerMetadata"](
            ref_type=typing.Any, object_type=dict, optional=True, key=key, flags={},
            key_type=typing.Any, element_type=typing.Any))
        node._content = {k: _omegaconf(v, classes, node, k) for k, v in value.items()}
    elif isinstance(value, (list, tuple)):
        node = classes["ListConfig"](_parent=parent, _metadata=classes["ContainerMetadata"](
            ref_type=typing.Any, object_type=list, optional=True, key=key, flags={},
            key_type=int, element_type=typing.Any))
        node._content = [_omegaconf(v, classes, node, i) for i, v in enumerate(value)]
    else:
        node = classes["AnyNode"](_val=value, _parent=parent, _metadata=classes["Metadata"](
            ref_type=typing.Any, object_type=None, optional=True, key=key, flags={}))
    return node


@pytest.mark.parametrize("layout", ["dict_th", "whole_module", "prior"])
def test_omegaconf_config_loads_without_omegaconf(layout, tmp_path, monkeypatch):
    """The reference stores its OmegaConf train config in the checkpoint. A
    stand-in DictConfig pickled under omegaconf's names, then unregistered,
    loads in the port as the plain config, in each `.th` layout."""
    mods, classes = _omegaconf_classes()
    path = str(tmp_path / "ckpt.th")
    cfg = dict(FAMILIES["mlp_mixer"])
    if layout == "prior":
        cfg = {"model": dict(embedding_dim=4, hidden_dim=16, hidden_depth=1, n_flows=2),
               "lr": 1e-3}
        want_flow = flow.build_prior_model(cfg, 6, 8, device="cpu")
        flow.save_prior(path, want_flow, cfg)
        want_sd = want_flow.state_dict()
    else:
        mapper = _mapper(cfg, 15)
        want_sd = mapper.state_dict()
        bank = np.random.default_rng(16).normal(size=(3, 4)).astype(np.float32)
    with monkeypatch.context() as m:
        for name, mod in mods.items():
            m.setitem(sys.modules, name, mod)
        stored = _omegaconf(cfg, classes)
        if layout == "prior":
            obj = torch.load(path, weights_only=False)
            torch.save(dict(obj, config=stored), path)
        elif layout == "dict_th":
            checkpoint.save_model(path, mapper, {}, bank)
            obj = torch.load(path, weights_only=False)
            torch.save(dict(obj, config=stored), path)
        else:
            _pickle_stand_in(mapper, stored, bank, path)
    monkeypatch.setitem(sys.modules, "omegaconf", None)  # not importable, even where installed
    with pytest.raises(ModuleNotFoundError):
        torch.load(path, weights_only=False)
    want_cfg = json.loads(json.dumps(cfg))  # tuples as the lists a ListConfig holds
    if layout == "prior":
        got_sd = flow.load_prior_model(path, device="cpu").flow.state_dict()
        assert checkpoint.plain_config(checkpoint.load_th(path)["config"]) == want_cfg
    else:
        got, got_cfg, noise = checkpoint.load_model(path, device="cpu")
        got_sd = got.state_dict()
        np.testing.assert_array_equal(noise.numpy(), bank)
        assert dict(got_cfg) == dict(make_config(**want_cfg))
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k].float(), v.float()), k


def test_legacy_unpickler_refuses_what_a_checkpoint_never_holds(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    path = tmp_path / "evil.th"
    with open(path, "wb") as fd:
        pickle.dump(Evil(), fd)
    with pytest.raises(pickle.UnpicklingError):
        with open(path, "rb") as fd:
            checkpoint.LegacyUnpickler(fd).load()
    for fn in (getattr, torch.hub.load_state_dict_from_url, np.load):  # no class, no rebuild
        with open(path, "wb") as fd:
            pickle.dump(fn, fd)
        with pytest.raises(pickle.UnpicklingError):
            with open(path, "rb") as fd:
                checkpoint.LegacyUnpickler(fd).load()


# ---------------------------------------------------------------- the Predictor


def test_predictor_serves_a_jax_dir_and_a_legacy_pickle(bpe_table, tmp_path):  # noqa: F811
    cfg = dict(CFG)
    jm, params = _jax_mapper(cfg, 21)
    jdir = jckpt.save_checkpoint(str(tmp_path), "jax_run", params, cfg, step=1, epoch=0)
    legacy = str(tmp_path / "legacy.th")
    _pickle_stand_in(_mapper(cfg, 22), cfg, np.zeros((1, 1), np.float32), legacy)
    pred = Predictor([jdir, legacy], device="cpu")
    pred.setup()
    assert sorted(pred.models) == ["jax_run", "legacy.th"]
    for name in pred.models:
        out = pred.predict("hello world", model=name, grid_size="1x1", seed=0,
                           out_path=str(tmp_path / f"{name}.png"))
        assert os.path.getsize(out) > 0


@pytest.mark.parametrize("damage", ["dir_without_params", "truncated_pickle"])
def test_predictor_setup_fails_on_a_damaged_checkpoint(damage, bpe_table, tmp_path):  # noqa: F811
    cfg = dict(CFG)
    if damage == "dir_without_params":
        _, params = _jax_mapper(cfg, 23)
        path = jckpt.save_checkpoint(str(tmp_path), "run", params, cfg, step=1, epoch=0)
        os.remove(os.path.join(path, "params.msgpack"))
    else:
        path = str(tmp_path / "legacy.th")
        _pickle_stand_in(_mapper(cfg, 24), cfg, np.zeros((1, 1), np.float32), path)
        with open(path, "r+b") as fd:
            fd.truncate(os.path.getsize(path) // 2)
    with pytest.raises(Exception):
        Predictor([path], device="cpu").setup()


def test_predictor_skips_an_unknown_model_type(bpe_table, tmp_path):  # noqa: F811
    """As the JAX Predictor: a `.th` of an unknown model_type is skipped."""
    good = checkpoint.save_model(str(tmp_path / "good.th"), _mapper(CFG, 25), CFG)
    bad = dict(CFG, model_type="transformer")
    torch.save({"state_dict": {}, "config": bad, "step": 0, "epoch": 0}, tmp_path / "bad.th")
    pred = Predictor([good, str(tmp_path / "bad.th")], device="cpu")
    pred.setup()
    assert list(pred.models) == ["good.th"]

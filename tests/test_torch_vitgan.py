"""The port's VitGAN mappers and their auxiliary classes against the JAX
package's, on the same weights, and the mapper factory for every model type.

Weights are numpy draws into the port's modules, carried to the JAX side by the
JAX package's own converters (io/torch_import.convert_vitgan_generator,
convert_vitgan_discriminator, convert_sine_layer); the other direction,
JAX init -> io/from_jax.py -> the port -> the JAX converter, must give back the
same pytree. Inputs are numpy draws. Tolerance, as max |port - JAX|:
2e-4 * max(1, max |JAX|) in float32 (the same math summed in another order).
Widths are tiny and the head counts do not divide the width (dim 24 over 5
heads: an inner width of 20), as the released 1024-wide, 6-head checkpoints
have it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.io import torch_import as ti
from feed_forward_vqgan_clip_tpu.models.mappers import build_mapper as j_build_mapper
from feed_forward_vqgan_clip_tpu.models.mappers import vitgan as jv
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import (
    mixer_state_dict,
    sine_layer_state_dict,
    vitgan_discriminator_state_dict,
    vitgan_generator_state_dict,
    xtransformer_state_dict,
)
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
from feed_forward_vqgan_clip_tpu_torch.models.mappers import vitgan as tv

TOL = 2e-4


def assert_close(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * max(1.0, float(np.abs(ref).max()))


def draw_(module, seed):
    """numpy draws into every entry of `module`'s state dict: matrices and tables
    N(0, 1/fan_in), 1-D weights (norm scales) 1 + N(0, 0.1), other vectors
    N(0, 0.1), BatchNorm variances 0.5 + |N(0, 0.1)|. Returns the state dict as
    numpy arrays."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if v.dim() >= 2:
            a = rng.normal(size=v.shape) / np.sqrt(np.prod(v.shape[1:]))
        elif k.endswith("running_var"):
            a = 0.5 + np.abs(0.1 * rng.normal(size=v.shape))
        else:
            a = 0.1 * rng.normal(size=v.shape) + k.endswith("weight")
        sd[k] = np.asarray(a, np.float32)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return sd


def port_out(module, *args):
    with torch.no_grad():
        out = module(*(torch.from_numpy(np.asarray(a)) for a in args))
    return out


def normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def prefixed(sd, prefix):
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def test_sln_matches_jax():
    m = tv.SLN(24)
    sd = draw_(m, 0)
    params = {"params": ti._sln(prefixed(sd, "n"), "n")}
    hl, w = normal(1, 2, 5, 24), normal(2, 2, 5, 24)
    assert_close(port_out(m, hl, w), jv.SLN().apply(params, hl, w))


@pytest.mark.parametrize("dim,heads", [(24, 5), (24, 6)])
def test_attention_matches_jax(dim, heads):
    m = tv.VitGANAttention(dim, heads)
    assert m.to_qkv.weight.shape == (3 * heads * (dim // heads), dim)
    sd = draw_(m, 3)
    params = {"params": {"to_qkv": ti._dense(sd, "to_qkv"), "w_out": ti._dense(sd, "w_out")}}
    x = normal(4, 2, 7, dim)
    assert_close(port_out(m, x), jv.VitGANAttention(dim, heads).apply(params, x))


def test_mlp_matches_jax():
    m = tv.VitGANMLP(24, 96)
    sd = draw_(m, 5)
    params = {"params": {"linear1": ti._dense(sd, "linear1"),
                         "linear2": ti._dense(sd, "linear2")}}
    x = normal(6, 2, 7, 24)
    assert_close(port_out(m, x), jv.VitGANMLP(24, 96).apply(params, x))


def test_block_matches_jax():
    m = tv.GEncoderBlock(24, 5)
    sd = draw_(m, 7)
    params = {"params": ti._vitgan_block(prefixed(sd, "b"), "b")}
    hl, x = normal(8, 2, 7, 24), normal(9, 2, 7, 24)
    got_x, got_hl = port_out(m, hl, x)
    want_x, want_hl = jv.GEncoderBlock(24, 5).apply(params, hl, x)
    np.testing.assert_array_equal(got_x.numpy(), x)  # x passes through
    assert_close(got_x, want_x)
    assert_close(got_hl, want_hl)


@pytest.mark.parametrize("initialize_size", [1, 2])
def test_generator_matches_jax(initialize_size):
    kw = dict(input_dim=12, dim=24, blocks=2, num_heads=5, out_channels=8)
    m = tv.Generator(initialize_size, **kw)
    sd = draw_(m, 10 + initialize_size)
    params = ti.convert_vitgan_generator(sd, blocks=2)
    z = normal(12, 3, 12)
    got = port_out(m, z)
    t = 8 * initialize_size
    assert got.shape == (3, t, t, 8)
    assert_close(got, jv.Generator(initialize_size, **kw).apply(params, z))


def test_simple_generator_matches_jax():
    kw = dict(input_dim=12, dim=24, blocks=2, num_heads=5, out_channels=8)
    m = tv.SimpleGenerator(3, **kw)
    sd = draw_(m, 13)
    params = ti.convert_vitgan_generator(sd, blocks=2)
    assert "inp" in params["params"]
    z = normal(14, 3, 12)
    got = port_out(m, z)
    assert got.shape == (3, 3, 3, 8)
    assert_close(got, jv.SimpleGenerator(3, **kw).apply(params, z))


@pytest.mark.parametrize("is_first", [True, False])
def test_sine_layer_matches_jax_and_inits_as_siren(is_first):
    m = tv.SineLayer(6, 10, is_first=is_first, omega_0=30.0)
    sd = draw_(m, 15)
    x = normal(16, 3, 6)
    want = jv.SineLayer(10, is_first=is_first, omega_0=30.0).apply(
        ti.convert_sine_layer(sd), x)
    assert_close(port_out(m, x), want)
    m.init_random_(torch.Generator().manual_seed(0))
    bound = 1.0 / 6 if is_first else (6.0 / 6) ** 0.5 / 30.0
    w, b = m.linear.weight.abs().max().item(), m.linear.bias.abs().max().item()
    assert 0.5 * bound < w <= bound and 0.5 * 6 ** -0.5 < b <= 6 ** -0.5


def _discriminator(dtype=torch.float32):
    return tv.Discriminator(in_channels=3, patch_size=2, extend_size=1, dim=18, blocks=2,
                            num_heads=4, dtype=dtype)


def test_discriminator_matches_jax():
    m = _discriminator()
    sd = draw_(m, 17)
    tv.init_discriminator_spectral_norms(m)
    params = ti.convert_vitgan_discriminator(sd, blocks=2)
    jd = jv.Discriminator(patch_size=2, extend_size=1, dim=18, blocks=2, num_heads=4)
    # 20 px: 37 of the pos table's 49 rows
    img = np.random.default_rng(18).uniform(size=(2, 20, 20, 3)).astype(np.float32)
    got = port_out(m, img)
    assert got.shape == (2, 1)
    assert_close(got, jd.apply(params, img))


def test_spectral_norm_init_is_the_loaded_weights_and_renormalizes():
    m = _discriminator()
    sd = draw_(m, 19)
    tv.init_discriminator_spectral_norms(m)
    params = ti.convert_vitgan_discriminator(sd, blocks=2)["params"]
    for i, block in enumerate(m.Transformer_Encoder.blocks):
        want = float(params[f"block_{i}"]["attn"]["init_spect_norm"])
        assert abs(block.attn.init_spect_norm.item() - want) <= 1e-5 * want
    assert not any("init_spect_norm" in k for k in m.state_dict())
    # the forward scales to_qkv to init_spect_norm / sigma_max: a scaled weight,
    # with the norm kept, gives the same output
    attn = m.Transformer_Encoder.blocks[0].attn
    x = torch.from_numpy(normal(20, 2, 5, 18))
    with torch.no_grad():
        base = attn(x)
        attn.to_qkv.weight.mul_(3.0)
        np.testing.assert_allclose(attn(x).numpy(), base.numpy(), atol=1e-5)


def _j_init(module, *args):
    return jax.jit(module.init)(jax.random.PRNGKey(0), *args)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("family", ["generator", "simple_generator", "discriminator",
                                    "sine_layer"])
def test_from_jax_round_trip(family):
    """JAX init -> from_jax -> the port (strict load) -> state_dict() -> the JAX
    converter gives back the same pytree, key for key and bit for bit."""
    kw = dict(input_dim=12, dim=24, blocks=2, num_heads=5, out_channels=8)
    if family == "generator":
        tree = _j_init(jv.Generator(1, **kw), jnp.zeros((1, 12)))
        port, to_sd = tv.Generator(1, **kw), vitgan_generator_state_dict
        back = lambda sd: ti.convert_vitgan_generator(sd, blocks=2)  # noqa: E731
    elif family == "simple_generator":
        tree = _j_init(jv.SimpleGenerator(3, **kw), jnp.zeros((1, 12)))
        port, to_sd = tv.SimpleGenerator(3, **kw), vitgan_generator_state_dict
        back = lambda sd: ti.convert_vitgan_generator(sd, blocks=2)  # noqa: E731
    elif family == "discriminator":
        jd = jv.Discriminator(patch_size=2, extend_size=1, dim=18, blocks=2, num_heads=4)
        tree = _j_init(jd, jnp.zeros((1, 20, 20, 3)))
        tree = {"params": jv.init_discriminator_spectral_norms(tree["params"])}
        port, to_sd = _discriminator(), vitgan_discriminator_state_dict
        back = lambda sd: ti.convert_vitgan_discriminator(sd, blocks=2)  # noqa: E731
    else:
        tree = _j_init(jv.SineLayer(10), jnp.zeros((1, 6)))
        port, to_sd = tv.SineLayer(6, 10), sine_layer_state_dict
        back = ti.convert_sine_layer
    port.load_state_dict(to_sd(jax.tree.map(np.asarray, tree)))
    again = back({k: v.numpy() for k, v in port.state_dict().items()})
    want, got = _leaves(tree), _leaves(again)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


FACTORY = dict(clip_model="ViT-B/32", dim=24, depth=2, noise_dim=4, dropout=0)


@pytest.mark.parametrize("model_type,vq_image_size,extra", [
    ("vitgan", 16, {}), ("simple_vitgan", 4, {"num_heads": 5}), ("mlp_mixer", 4, {}),
    ("xtransformer", 4, {}), ("xtransformer", 3, {"initial_proj": False, "add_input": True}),
])
def test_build_mapper_matches_jax(model_type, vq_image_size, extra):
    """The JAX factory's arguments for every model type (initialize_size =
    vq_image_size // 8, num_heads 6 by default, initial_proj True, add_input
    False): the JAX mapper's init loads strictly into the port's, and both give
    the same latent."""
    cfg = dict(FACTORY, model_type=model_type, vq_image_size=vq_image_size, **extra)
    jm = j_build_mapper(cfg, vq_channels=8)
    tree = jax.tree.map(np.asarray, _j_init(jm, jnp.zeros((1, 516))))
    to_sd = {"vitgan": vitgan_generator_state_dict, "simple_vitgan": vitgan_generator_state_dict,
             "mlp_mixer": mixer_state_dict,
             "xtransformer": lambda t: xtransformer_state_dict(
                 t, add_input=bool(extra.get("add_input")))}[model_type]
    m = build_mapper(cfg, vq_channels=8)
    m.load_state_dict(to_sd(tree))
    z = normal(21, 2, 516)
    want = jm.apply(tree, z)
    assert want.shape == (2, vq_image_size, vq_image_size, 8)
    assert_close(port_out(m, z), want)


def test_build_mapper_rejects_an_unknown_type():
    with pytest.raises(ValueError, match="model_type"):
        build_mapper(dict(FACTORY, model_type="transformer"))

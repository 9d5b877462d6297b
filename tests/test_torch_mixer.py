"""The port's MLP-Mixer against the JAX package's, on the same weights.

Weights are numpy draws carried to the JAX side by io/torch_import.convert_mixer
(the round trip through io/from_jax.py is tested below); inputs come from numpy.
Tolerances, as max |port - JAX| / max |JAX|: float32 1e-4 (the same math,
summed in another order); bfloat16 3e-2 (8 mantissa bits, the paths round at
different points and the Pallas kernel's GELU is a polynomial).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.io.torch_import import convert_mixer
from feed_forward_vqgan_clip_tpu.models.mappers.mixer import Mixer as JMixer
from feed_forward_vqgan_clip_tpu.models.mappers.mixer import MixerBlock as JMixerBlock
from feed_forward_vqgan_clip_tpu.ops.pallas.mixer_block import fused_mixer_block
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import mixer_state_dict
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
from feed_forward_vqgan_clip_tpu_torch.models.mappers.fused import (
    fused_mixer_forward,
    make_mapper_apply,
)
from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import Mixer
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import mixer_block_plain

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


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


def _make(rng, dtype, *, s=8, dim=32, depth=2, input_dim=24, channels=8):
    """The port's Mixer with random weights, and the JAX Mixer with the same weights
    carried over by the JAX package's own converter (io/torch_import.convert_mixer)."""
    tm = Mixer(input_dim, s, channels, dim, depth, dtype=dtype)
    sd = _random_state_dict(tm, rng)
    tm.load_state_dict(sd)
    params = convert_mixer({k: v.numpy() for k, v in sd.items()}, depth)
    jm = JMixer(input_dim=input_dim, image_size=s, channels=channels, dim=dim,
                depth=depth, dtype=JDT[dtype])
    return jm, params, tm.eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_block_matches_jax_module_and_pallas(rng, dtype):
    jm, params, tm = _make(rng, dtype)
    t, d = 64, 32
    x = rng.normal(size=(3, t, d)).astype(np.float32)
    jx = jnp.asarray(x, JDT[dtype])
    p = params["params"]["block_0"]
    ref = jax.jit(JMixerBlock(tokens=t, dim=d, dtype=JDT[dtype]).apply)({"params": p}, jx)
    pallas = fused_mixer_block(jx, p, dtype=JDT[dtype], interpret=True)
    block = tm.blocks[0]
    tx = torch.from_numpy(x).to(dtype)
    with torch.no_grad():
        plain = mixer_block_plain(tx, block.kernel_weights(dtype))
        module = block(tx)
    assert plain.dtype == module.dtype == dtype
    for got in (plain, module):
        assert _rel(got.float(), ref) <= TOL[dtype]
        assert _rel(got.float(), pallas) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mixer_matches_jax(rng, dtype):
    jm, params, tm = _make(rng, dtype)
    x = rng.normal(size=(3, 24)).astype(np.float32)
    ref = jax.jit(jm.apply)(params, jnp.asarray(x))
    tx = torch.from_numpy(x)
    with torch.no_grad():
        out = tm(tx)
        weights = [b.kernel_weights(dtype) for b in tm.blocks]
        fused = fused_mixer_forward(tm, tx, weights)
    assert out.shape == (3, 8, 8, 8)
    assert _rel(out.float(), ref) <= TOL[dtype]
    assert _rel(fused.float(), ref) <= TOL[dtype]


def test_make_mapper_apply_runs_module_on_cpu(rng):
    _, _, tm = _make(rng, torch.float32)
    x = torch.from_numpy(rng.normal(size=(2, 24)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(make_mapper_apply(tm)(x).numpy(), tm(x).numpy())


def test_from_jax_convert_mixer_round_trip(rng):
    _, params, tm = _make(rng, torch.float32, depth=3)
    sd = tm.state_dict()
    back = mixer_state_dict(params)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())
    again = convert_mixer({k: v.numpy() for k, v in back.items()}, depth=3)
    flat = dict(jax.tree_util.tree_leaves_with_path(again))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(np.asarray(flat[path]), np.asarray(leaf))


def test_build_mapper():
    m = build_mapper(dict(clip_model="ViT-B/32", model_type="mlp_mixer", dim=16, depth=2,
                          vq_image_size=4, noise_dim=8), vq_channels=8)
    assert (m.input_dim, m.image_size, m.channels, m.depth) == (520, 4, 8, 2)
    with pytest.raises(ValueError, match="model_type"):  # as the JAX factory
        build_mapper(dict(clip_model="ViT-B/32", model_type="mixer", dim=16, depth=2))


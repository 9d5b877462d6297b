"""The port's x-transformer mapper against the JAX package's, and against the
x-transformers 0.19.1 reimplementation vendored in
tests/test_xtransformer_convert.py, whose state dict loads into the port's module
as it is.

Weights: numpy draws into the port's module, carried to the JAX side by
io/torch_import.convert_xtransformer; the vendored module's own draws, loaded
with load_state_dict. Inputs are numpy draws. Tolerance, as max |port - ref|:
2e-4 * max(1, max |ref|) in float32 (the same math summed in another order; the
vendored module masks with finfo.min where the port and JAX use -inf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.io.torch_import import convert_xtransformer
from feed_forward_vqgan_clip_tpu.models.mappers.xtransformer import XTransformer as JXTransformer
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import xtransformer_state_dict
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
from feed_forward_vqgan_clip_tpu_torch.models.mappers.xtransformer import XTransformer
from test_torch_vitgan import assert_close, draw_, normal, port_out
from test_xtransformer_convert import _TXTransformer

MODES = [(True, False), (False, True), (False, False), (True, True)]
KW = dict(input_dim=20, image_size=3, channels=8, dim=32, depth=2, heads=3, dim_head=16)


@pytest.mark.parametrize("initial_proj,add_input", MODES)
def test_matches_jax(initial_proj, add_input):
    m = XTransformer(**KW, initial_proj=initial_proj, add_input=add_input)
    sd = draw_(m, 1)
    assert sd["transformer.pos_emb.emb.weight"].shape[0] == 9 + (0 if add_input else 1)
    params = convert_xtransformer(sd, depth=2)
    z = normal(2, 3, 20)
    got = port_out(m, z)
    assert got.shape == (3, 3, 3, 8)
    want = JXTransformer(**KW, initial_proj=initial_proj, add_input=add_input).apply(params, z)
    assert_close(got, want)


@pytest.mark.parametrize("initial_proj,add_input", MODES[:3])
def test_loads_the_vendored_reference_state_dict(initial_proj, add_input):
    torch.manual_seed(0)
    ref = _TXTransformer(**KW, initial_proj=initial_proj, add_input=add_input)
    with torch.no_grad():
        for p in ref.parameters():
            p.normal_(0.0, 0.1)
    m = XTransformer(**KW, initial_proj=initial_proj, add_input=add_input)
    m.load_state_dict(ref.state_dict())  # strict: the same keys and shapes
    z = normal(3, 3, 20)
    with torch.no_grad():
        want = ref(torch.from_numpy(z))
    assert_close(port_out(m, z), want)


@pytest.mark.parametrize("initial_proj,add_input", MODES)
def test_from_jax_round_trip(initial_proj, add_input):
    """JAX init -> from_jax -> the port (strict load) -> state_dict() ->
    convert_xtransformer gives back the same pytree, key for key and bit for
    bit (the port's unused last position row is dropped again)."""
    jm = JXTransformer(**KW, initial_proj=initial_proj, add_input=add_input)
    tree = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 20))))
    m = XTransformer(**KW, initial_proj=initial_proj, add_input=add_input)
    m.load_state_dict(xtransformer_state_dict(tree, add_input=add_input))
    again = convert_xtransformer({k: v.numpy() for k, v in m.state_dict().items()}, depth=2)
    want = dict(jax.tree_util.tree_leaves_with_path(tree))
    got = dict(jax.tree_util.tree_leaves_with_path(again))
    assert sorted(map(jax.tree_util.keystr, got)) == sorted(map(jax.tree_util.keystr, want))
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=jax.tree_util.keystr(k))


def test_build_mapper_keeps_dim_head_64_and_the_released_layout():
    """The released cc12m_256x16 setting at a cut depth: dim 256, 6 heads of 64
    whatever the width (inner 384), 32 x 32 latent tokens, initial_proj, and the
    position table of n + 1 rows."""
    m = build_mapper(dict(clip_model="ViT-B/32", model_type="xtransformer", dim=256, depth=1,
                          vq_image_size=32), vq_channels=256, device="meta")
    sd = m.state_dict()
    assert sd["proj.weight"].shape == (1024 * 256, 512)
    assert sd["transformer.project_in.weight"].shape == (256, 256)
    assert sd["transformer.pos_emb.emb.weight"].shape == (1025, 256)
    assert sd["transformer.attn_layers.layers.0.1.to_q.weight"].shape == (384, 256)
    assert "transformer.attn_layers.layers.0.1.to_q.bias" not in sd
    assert sd["transformer.attn_layers.layers.1.1.net.0.0.weight"].shape == (1024, 256)

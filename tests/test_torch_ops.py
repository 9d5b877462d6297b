"""The port's straight-through ops and vector quantization against the JAX package.

Inputs come from numpy and go through both; the JAX side runs on the CPU (the
Pallas kernel in interpret mode). Tolerances: the grad ops and the index search
are exact (equal values, equal indices). The kernel itself is tested on the card
by tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.ops import grad_ops as jgrad
from feed_forward_vqgan_clip_tpu.ops import quantize as jquant
from feed_forward_vqgan_clip_tpu.ops.pallas.vq_lookup import nearest_codebook_indices_pallas
from feed_forward_vqgan_clip_tpu_torch.ops.grad_ops import clamp_with_grad, replace_grad
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.vq_lookup import nearest_codebook_indices_plain
from feed_forward_vqgan_clip_tpu_torch.ops.quantize import (
    nearest_codebook_indices,
    quantize_indices,
    vector_quantize,
)


def _grad(fn, *arrays, weights):
    """Value and d(sum(fn(*arrays) * weights))/d(arrays) in torch, as numpy; an
    input that gets no gradient reads as zeros, as in JAX."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    (out * torch.tensor(weights)).sum().backward()
    grads = [np.zeros_like(a) if t.grad is None else t.grad.numpy() for a, t in zip(arrays, ts)]
    return out.detach().numpy(), grads


class TestGradOps:
    def test_clamp_with_grad_value_and_grad_exact(self, rng):
        x = rng.normal(size=(5, 7)).astype(np.float32) * 2
        g = rng.normal(size=(5, 7)).astype(np.float32)
        lo, hi = np.float32(-0.7), np.float32(0.9)
        val, (gx,) = _grad(lambda t: clamp_with_grad(t, float(lo), float(hi)), x, weights=g)
        jval, jvjp = jax.vjp(lambda v: jgrad.clamp_with_grad(v, lo, hi), jnp.asarray(x))
        np.testing.assert_array_equal(val, np.asarray(jval))
        np.testing.assert_array_equal(gx, np.asarray(jvjp(jnp.asarray(g))[0]))

    def test_clamp_with_grad_mask(self):
        # keep iff g * (x - clamp(x)) >= 0 (tests/test_ops.py::TestClampWithGrad)
        x = torch.tensor([-2.0, 0.0, 2.0], requires_grad=True)
        clamp_with_grad(x, -1.0, 1.0).sum().backward()
        np.testing.assert_array_equal(x.grad.numpy(), [0.0, 1.0, 1.0])
        x.grad = None
        (-clamp_with_grad(x, -1.0, 1.0).sum()).backward()
        np.testing.assert_array_equal(x.grad.numpy(), [-1.0, -1.0, 0.0])

    @pytest.mark.parametrize("xb_shape", [(4, 3), (1, 3)])
    def test_replace_grad_value_and_grad_exact(self, rng, xb_shape):
        xf = rng.normal(size=(4, 3)).astype(np.float32)
        xb = rng.normal(size=xb_shape).astype(np.float32)
        g = rng.normal(size=(4, 3)).astype(np.float32)
        val, (gf, gb) = _grad(replace_grad, xf, xb, weights=g)
        jval, jvjp = jax.vjp(jgrad.replace_grad, jnp.asarray(xf), jnp.asarray(xb))
        jgf, jgb = jvjp(jnp.asarray(g))
        np.testing.assert_array_equal(val, np.asarray(jval))
        np.testing.assert_array_equal(gf, np.asarray(jgf))
        np.testing.assert_array_equal(gb, np.asarray(jgb))


class TestNearestCodebook:
    @pytest.mark.parametrize("n,k,c", [(70, 300, 16), (256, 1024, 32), (33, 7, 5)])
    def test_indices_equal_jax_and_pallas(self, rng, n, k, c):
        x = rng.normal(size=(n, c)).astype(np.float32)
        cb = rng.normal(size=(k, c)).astype(np.float32)
        ref = np.asarray(jquant.nearest_codebook_indices(jnp.asarray(x), jnp.asarray(cb)))
        pallas = np.asarray(
            nearest_codebook_indices_pallas(jnp.asarray(x), jnp.asarray(cb), interpret=True)
        )
        tx, tcb = torch.from_numpy(x), torch.from_numpy(cb)
        np.testing.assert_array_equal(nearest_codebook_indices(tx, tcb).numpy(), ref)
        np.testing.assert_array_equal(nearest_codebook_indices_plain(tx, tcb).numpy(), pallas)
        np.testing.assert_array_equal(nearest_codebook_indices_plain(tx, tcb).numpy(), ref)

    def test_first_match_ties(self):
        cb = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
        x = torch.tensor([[1.0, 0.0]])
        assert int(nearest_codebook_indices(x, cb)[0]) == 0
        assert int(nearest_codebook_indices_plain(x, cb)[0]) == 0
        assert int(quantize_indices(x, cb)[0]) == 0

    def test_duplicated_codebook_picks_lower_copy(self, rng):
        half = rng.normal(size=(40, 8)).astype(np.float32)
        cb = torch.from_numpy(np.concatenate([half, half]))
        x = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
        assert int(nearest_codebook_indices_plain(x, cb).max()) < 40
        assert int(nearest_codebook_indices(x, cb).max()) < 40

    def test_batched_shape(self, rng):
        cb = rng.normal(size=(64, 8)).astype(np.float32)
        x = rng.normal(size=(2, 3, 3, 8)).astype(np.float32)
        got = quantize_indices(torch.from_numpy(x), torch.from_numpy(cb))
        ref = jquant.nearest_codebook_indices(jnp.asarray(x), jnp.asarray(cb))
        assert got.shape == (2, 3, 3) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


class TestVectorQuantize:
    def test_value_and_straight_through_grad_exact(self, rng):
        cb = rng.normal(size=(8, 4)).astype(np.float32)
        x = rng.normal(size=(5, 4)).astype(np.float32)
        g = rng.normal(size=(5, 4)).astype(np.float32)
        tcb = torch.from_numpy(cb)
        val, (gx,) = _grad(lambda t: vector_quantize(t, tcb), x, weights=g)
        jval, jvjp = jax.vjp(
            lambda v: jquant.vector_quantize(v, jnp.asarray(cb), use_pallas=False),
            jnp.asarray(x),
        )
        np.testing.assert_array_equal(val, np.asarray(jval))
        np.testing.assert_array_equal(gx, np.asarray(jvjp(jnp.asarray(g))[0]))
        np.testing.assert_array_equal(gx, g)  # identity to the latent

    def test_picks_nearest(self, rng):
        cb = torch.from_numpy(rng.normal(size=(17, 4)).astype(np.float32))
        x = cb[[3, 9, 16]] + 0.01
        np.testing.assert_allclose(vector_quantize(x, cb).numpy(), cb[[3, 9, 16]].numpy(),
                                   atol=1e-6)


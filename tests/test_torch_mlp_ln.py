"""The CLIP MLP sublayer K11 (ops/kernels/mlp_ln.py) on the CPU, where its wrappers
run the plain versions, against the JAX package's Pallas kernel in interpret
mode (ops/pallas/mlp_ln.py), float32, rows 64, D 128, E 512, both activations.

Tolerances: the forward's output, g and g' within 2e-4 (the JAX test's ceiling
for the kernel against XLA); dx within 5e-3 and each parameter grad within
3e-3 of max(1e-2, its max |JAX grad|), the JAX package's own ceilings
(tests/test_fused_clip.py); the kernel's direct outputs (`_fwd_res`, `_bwd`) the
same way.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.ops.pallas import mlp_ln as jmlp
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mlp_ln import (
    MlpLn,
    MlpLnGrads,
    MlpLnWeights,
    mlp_ln,
    mlp_ln_bwd,
    mlp_ln_bwd_plain,
    mlp_ln_supported,
)

N, D, E = 64, 128, 512


def _params(seed):
    rng = np.random.default_rng(seed)
    return {
        "ln": {"scale": (1 + 0.1 * rng.normal(size=(D,))).astype(np.float32),
               "bias": (0.1 * rng.normal(size=(D,))).astype(np.float32)},
        "fc1": {"kernel": (rng.normal(size=(D, E)) * 0.05).astype(np.float32),
                "bias": (rng.normal(size=(E,)) * 0.05).astype(np.float32)},
        "fc2": {"kernel": (rng.normal(size=(E, D)) * 0.05).astype(np.float32),
                "bias": (rng.normal(size=(D,)) * 0.05).astype(np.float32)},
    }, rng.normal(size=(N, D)).astype(np.float32), rng.normal(size=(N, D)).astype(np.float32)


def _weights(p):
    """The JAX params in MlpLnWeights' layouts: the dense kernels transposed to
    nn.Linear's (out, in)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return MlpLnWeights(ln_w=t(p["ln"]["scale"]), ln_b=t(p["ln"]["bias"]),
                        w1=t(p["fc1"]["kernel"].T), b1=t(p["fc1"]["bias"]),
                        w2=t(p["fc2"]["kernel"].T), b2=t(p["fc2"]["bias"]))


def _jax_grads_as_weights(dw1, db1, dw2, db2, dls, dlb):
    """`_bwd`'s parameter grads in MlpLnWeights' layouts."""
    v = lambda a: np.asarray(a).reshape(-1)  # noqa: E731
    return {"ln_w": v(dls), "ln_b": v(dlb), "w1": np.asarray(dw1).T, "b1": v(db1),
            "w2": np.asarray(dw2).T, "b2": v(db2)}


def _close_grad(got, want, ceiling):
    scale = max(1e-2, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=ceiling * scale)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_forward_matches_jax_kernel(act):
    p, x, _ = _params(0)
    out, g, dg = jmlp._fwd_res(jnp.asarray(x), jax.tree.map(jnp.asarray, p), act,
                               jnp.float32, True)
    before = mlp_ln.launches
    t_out, t_g, t_dg = mlp_ln(torch.from_numpy(x), _weights(p), act)
    assert mlp_ln.launches == before  # a CPU tensor runs the plain version
    for got, want in ((t_out, out), (t_g, g), (t_dg, dg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_backward_matches_jax_kernel(act):
    p, x, dy = _params(1)
    jp = jax.tree.map(jnp.asarray, p)
    _, g, dg = jmlp._fwd_res(jnp.asarray(x), jp, act, jnp.float32, True)
    dx, *jgrads = jmlp._bwd(jnp.asarray(dy), jnp.asarray(x), g, dg, jp, jnp.float32, True)
    want = _jax_grads_as_weights(*jgrads)
    w = _weights(p)
    tg, tdg = (torch.from_numpy(np.array(v)) for v in (g, dg))
    got = mlp_ln_bwd(torch.from_numpy(dy), torch.from_numpy(x), tg, tdg, w)
    np.testing.assert_allclose(got.dx.numpy(), np.asarray(dx), atol=5e-3)
    for name, v in want.items():
        _close_grad(getattr(got, name).numpy(), v, 3e-3)
    # the dx-only mode (the frozen tower): the same dx, no parameter grads
    only = mlp_ln_bwd(torch.from_numpy(dy), torch.from_numpy(x), tg, tdg, w, params=False)
    assert isinstance(only, MlpLnGrads) and all(v is None for v in only[1:])
    assert torch.equal(only.dx, got.dx)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_autograd_function_matches_jax_custom_vjp(act):
    """MlpLn's forward and grads under L = sum(y^2) / n against fused_mlp_ln's,
    the loss of tests/test_fused_clip.py."""
    p, x, _ = _params(2)
    fused = functools.partial(jmlp.fused_mlp_ln, act=act, dtype=jnp.float32, interpret=True)

    def loss(x, p):
        return jnp.sum(jnp.square(fused(x, p))) / N

    jp = jax.tree.map(jnp.asarray, p)
    want_y = np.asarray(fused(jnp.asarray(x), jp))
    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jp)
    params = [torch.nn.Parameter(t.clone()) for t in _weights(p)]
    tx = torch.from_numpy(x).requires_grad_()
    y = MlpLn.apply(tx, act, torch.float32, *params)
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=2e-4)
    (y.square().sum() / N).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=5e-3)
    want = {"ln_w": gp["ln"]["scale"], "ln_b": gp["ln"]["bias"], "w1": gp["fc1"]["kernel"].T,
            "b1": gp["fc1"]["bias"], "w2": gp["fc2"]["kernel"].T, "b2": gp["fc2"]["bias"]}
    for name, prm in zip(MlpLnWeights._fields, params):
        _close_grad(prm.grad.numpy(), np.asarray(want[name]), 3e-3)


def test_frozen_parameters_take_the_dx_only_backward(monkeypatch):
    """With parameters that do not require grad (the frozen CLIP tower) the
    backward asks for dx alone, and dx is the parameter mode's."""
    p, x, _ = _params(3)
    w = list(_weights(p))
    seen = []
    real = mlp_ln_bwd_plain

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels import mlp_ln as module

    monkeypatch.setattr(module, "mlp_ln_bwd_plain", spy)
    grads = []
    for trainable in (False, True):
        params = [torch.nn.Parameter(t.clone(), requires_grad=trainable) for t in w]
        tx = torch.from_numpy(x).requires_grad_()
        MlpLn.apply(tx, "quick_gelu", torch.float32, *params).square().sum().backward()
        grads.append(tx.grad)
        assert all((prm.grad is not None) == trainable for prm in params)
    assert seen == [False, True]
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("n,d,e", [(3200, 768, 3072), (3200, 760, 3040), (17, 768, 3072),
                                   (272, 128, 512), (64, 128, 512), (16 * 50, 1024, 4096),
                                   (2, 128, 512), (1024, 1280, 5120)])
def test_shape_gate_is_the_jax_gate(n, d, e):
    assert mlp_ln_supported(n, d, e) == jmlp.mlp_ln_supported(n, d, e)


def test_shape_gate_cases():
    assert mlp_ln_supported(3200, 768, 3072)  # the train step's rows at ViT-B/32
    assert not mlp_ln_supported(3200, 760, 3040)  # widths not multiples of 128
    assert not mlp_ln_supported(17, 768, 3072)  # no row tile divides 17

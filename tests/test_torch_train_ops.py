"""The port's train-path ops against the JAX package's: pooling, the Ji/Er
augmentations and their samplers, cutouts, losses, and the cast-state Adam
(the Af/Pe warps are in tests/test_torch_warp.py).

Inputs and random draws are numpy (torch's and JAX's generators differ), so the
augmentations compare at pinned draws and the samplers by their distributions.
Tolerances: float32 values 1e-6 absolute for pooling, cutouts and erasing (the
same arithmetic), 1e-5 for the HSV chain and the losses (f32 transcendental and
reduction order), 1e-6 relative for Adam; grads 1e-5 relative. The pools have
JAX's formulation, so their gradients agree at tied maxima too (both split
the gradient between equal maxima), and in bf16 (the window matrices cast to
bf16 on both sides) within one bf16 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from feed_forward_vqgan_clip_tpu.ops import augment as jaug
from feed_forward_vqgan_clip_tpu.ops import losses as jloss
from feed_forward_vqgan_clip_tpu.ops import pooling as jpool
from feed_forward_vqgan_clip_tpu.ops.cutouts import MakeCutouts as JMakeCutouts
from feed_forward_vqgan_clip_tpu.train.state import make_optimizer as j_make_optimizer
from feed_forward_vqgan_clip_tpu_torch.ops import augment, losses, pooling
from feed_forward_vqgan_clip_tpu_torch.ops.cutouts import MakeCutouts
from feed_forward_vqgan_clip_tpu_torch.train.state import make_optimizer


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _vjp_torch(fn, x, ct):
    xt = _t(x).requires_grad_()
    out = fn(xt)
    (g,) = torch.autograd.grad(out, xt, _t(ct))
    return out.detach().numpy(), g.numpy()


def _vjp_jax(fn, x, ct):
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(ct))[0])


# ---------------------------------------------------------------- pooling


@pytest.mark.parametrize("kind", ["avg", "max"])
@pytest.mark.parametrize("size,out", [(37, 16), (8, 32), (24, 24)])
def test_adaptive_pools_match_jax(rng, kind, size, out):
    x = rng.uniform(size=(2, size, size, 3)).astype(np.float32)
    ct = rng.normal(size=(2, out, out, 3)).astype(np.float32)
    tfn = getattr(pooling, f"adaptive_{kind}_pool")
    jfn = getattr(jpool, f"adaptive_{kind}_pool")
    got, g_got = _vjp_torch(lambda v: tfn(v, out), x, ct)
    ref, g_ref = _vjp_jax(lambda v: jfn(v, out), x, ct)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(g_got, g_ref, atol=1e-5)  # no ties in continuous data


@pytest.mark.parametrize("size,out", [(37, 16), (8, 32), (24, 20)])
def test_max_pool_splits_tied_maxima_as_jax(rng, size, out):
    """Values from {0, 1, 2}: most windows hold tied maxima, whose gradient both
    formulations split equally (torch.maximum and jnp.maximum)."""
    x = rng.integers(0, 3, size=(2, size, size, 3)).astype(np.float32)
    ct = rng.normal(size=(2, out, out, 3)).astype(np.float32)
    got, g_got = _vjp_torch(lambda v: pooling.adaptive_max_pool(v, out), x, ct)
    ref, g_ref = _vjp_jax(lambda v: jpool.adaptive_max_pool(v, out), x, ct)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(g_got, g_ref, atol=1e-6)
    # a 2x2 window of four equal maxima: each gets a quarter (torch's own pool
    # would send all of it to one)
    xt = torch.ones(1, 2, 2, 1, requires_grad=True)
    pooling.adaptive_max_pool(xt, 1).sum().backward()
    assert torch.equal(xt.grad, torch.full_like(xt, 0.25))


def test_pools_in_bf16_match_jax(rng):
    x = rng.uniform(size=(2, 37, 37, 3)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    for tfn, jfn in ((pooling.adaptive_avg_pool, jpool.adaptive_avg_pool),
                     (pooling.adaptive_max_pool, jpool.adaptive_max_pool)):
        got = tfn(xb, 24)
        assert got.dtype == torch.bfloat16
        want = np.asarray(jfn(xj, 24).astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=1e-6)


# ---------------------------------------------------------------- colour space


def test_rgb_hsv_round_trip_and_jax(rng):
    rgb = rng.uniform(size=(4, 9, 7, 3)).astype(np.float32)
    rgb[0, 0, 0] = [0.3, 0.3, 0.3]  # grey: zero saturation, zero hue
    rgb[0, 0, 1] = [0.0, 0.0, 0.0]
    hsv = augment.rgb_to_hsv(_t(rgb))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jaug.rgb_to_hsv(jnp.asarray(rgb))),
                               atol=1e-5)
    np.testing.assert_allclose(augment.hsv_to_rgb(hsv).numpy(), rgb, atol=1e-5)
    np.testing.assert_allclose(
        augment.hsv_to_rgb(hsv).numpy(), np.asarray(jaug.hsv_to_rgb(jnp.asarray(hsv.numpy()))),
        atol=1e-6)


# ---------------------------------------------------------------- Ji / Er at pinned draws


def _ji_draws(rng, b, brightness, contrast, saturation=0.1, hue=0.1):
    u = lambda lo, hi: rng.uniform(lo, hi, size=b).astype(np.float32)  # noqa: E731
    return (u(max(0.0, 1 - brightness), 1 + brightness), u(max(0.0, 1 - contrast), 1 + contrast),
            u(1 - saturation, 1 + saturation), u(-hue, hue))


@pytest.mark.parametrize("order", [None, (2, 0, 3, 1), (3, 1, 2, 0)])
def test_ji_apply_matches_jax_at_pinned_draws(rng, order):
    x = rng.uniform(size=(5, 6, 7, 3)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    draws = _ji_draws(rng, 5, 0.2, 0.3)
    t_order = None if order is None else torch.tensor(order)
    j_order = None if order is None else jnp.asarray(order)
    got, g_got = _vjp_torch(lambda v: augment.ji_apply(v, *map(_t, draws), t_order), x, ct)
    ref, g_ref = _vjp_jax(
        lambda v: jaug.ji_apply(v, *map(jnp.asarray, draws), j_order), x, ct)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(g_got, g_ref, atol=1e-5 * np.abs(g_ref).max())


def test_color_jitter_fast_path_equals_ordered(rng):
    """The `Ji` code's single HSV round trip equals ji_apply, in any order, at the
    generator's own draws and application mask (brightness and contrast factors 1)."""
    x = _t(rng.uniform(size=(6, 5, 5, 3)))
    got = augment.color_jitter(torch.Generator().manual_seed(3), x)
    gen = torch.Generator().manual_seed(3)
    sf, hf = augment.ji_sample(gen, 6)
    applied = torch.rand(6, generator=gen) < augment.JI_P
    ones = torch.ones(6)
    for order in (None, (2, 0, 3, 1), (3, 1, 2, 0)):
        t_order = None if order is None else torch.tensor(order)
        want = torch.where(applied[:, None, None, None],
                           augment.ji_apply(x, ones, ones, sf, hf, t_order), x)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("n", [1, 4])
def test_er_apply_matches_jax_at_pinned_draws(rng, n):
    x = rng.uniform(size=(4, 11, 13, 3)).astype(np.float32)
    ew = rng.integers(1, 13, size=n).astype(np.float32)
    eh = rng.integers(1, 11, size=n).astype(np.float32)
    x0 = (rng.uniform(size=n) * (13 - ew + 1)).astype(np.float32)
    y0 = (rng.uniform(size=n) * (11 - eh + 1)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    box = (x0, y0, ew, eh)
    got, g_got = _vjp_torch(lambda v: augment.er_apply(v, *map(_t, box)), x, ct)
    ref, g_ref = _vjp_jax(lambda v: jaug.er_apply(v, *map(jnp.asarray, box)), x, ct)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(g_got, g_ref)
    assert (got == 0).any()


# ---------------------------------------------------------------- samplers


def test_ji_sampler_distribution():
    gen = torch.Generator().manual_seed(0)
    sf, hf = augment.ji_sample(gen, 20000)
    assert 0.9 <= float(sf.min()) and float(sf.max()) <= 1.1
    assert -0.1 <= float(hf.min()) and float(hf.max()) <= 0.1
    for v, mean in ((sf, 1.0), (hf, 0.0)):
        assert abs(float(v.mean()) - mean) < 0.01


def test_er_sampler_distribution():
    gen = torch.Generator().manual_seed(0)
    h, w, n = 64, 48, 20000
    x0, y0, ew, eh = augment.er_sample(gen, n, h, w)
    assert float(eh.min()) >= 1 and float(eh.max()) <= h
    assert float(ew.min()) >= 1 and float(ew.max()) <= w
    assert torch.equal(eh, eh.round()) and torch.equal(ew, ew.round())
    assert float((x0 + ew - 1).max()) <= w and float((y0 + eh - 1).max()) <= h
    assert float(x0.min()) >= 0 and float(y0.min()) >= 0
    area = eh * ew / (h * w)
    assert 0.05 < float(area.min()) and float(area.max()) < 0.55
    aspect = eh / ew
    tall = float((aspect > 1.05).float().mean())
    assert 0.4 < tall < 0.6  # the two-part mixture picks either side half the time


def test_apply_probability():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(4000, 16, 16, 3)  # every box of the `Er` code is >= 3 px a side here
    out = augment.random_erasing(gen, x)
    frac = float((out == 0).flatten(1).any(1).float().mean())
    assert abs(frac - 0.7) < 0.03


def test_pipeline_codes():
    assert len(augment.build_augment_pipeline(["Ji", "Er", "Ji"], 8)) == 3
    assert augment.build_augment_pipeline(["Af", "Pe"], 8) == [augment.random_affine,
                                                               augment.random_perspective]
    with pytest.raises(ValueError, match="unknown augmentation codes"):
        augment.build_augment_pipeline(["Af", "Cc", "Xy"], 8)


# ---------------------------------------------------------------- cutouts


def test_cutouts_match_jax_without_draws(rng):
    """Pool (avg + max) / 2, tile cutn-major; augs emptied and noise 0 on the port,
    the identity centre crop and noise 0 on the JAX side."""
    x = rng.uniform(size=(3, 16, 16, 3)).astype(np.float32)
    ct = rng.normal(size=(12, 10, 10, 3)).astype(np.float32)
    mc = MakeCutouts(cut_size=10, cutn=4, pool_size=10, augs=["Ji"], noise_fac=0.0)
    mc.augs = []
    jmc = JMakeCutouts(cut_size=10, cutn=4, augs=["Cc"], pool_size=10, noise_fac=0.0)
    got, g_got = _vjp_torch(lambda v: mc(torch.Generator(), v), x, ct)
    ref, g_ref = _vjp_jax(lambda v: jmc(jax.random.PRNGKey(0), v), x, ct)
    assert got.shape == (12, 10, 10, 3)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(g_got, g_ref, atol=1e-5)
    np.testing.assert_array_equal(got[3:6], got[:3])  # cutn-major tiling


def test_cutouts_noise_and_default_codes():
    mc = MakeCutouts(cut_size=8, cutn=2, augs=[], noise_fac=0.1)  # empty: the default set
    assert mc.codes == ["Af", "Pe", "Ji", "Er"]
    x = torch.rand(50, 8, 8, 3, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    x.requires_grad_()
    out = mc(torch.Generator().manual_seed(0), x)
    assert out.shape == (100, 8, 8, 3) and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all())
    out.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and bool(torch.isfinite(x.grad).all())


# ---------------------------------------------------------------- losses


def test_losses_match_jax(rng):
    a = rng.normal(size=(6, 16)).astype(np.float32)
    b = rng.normal(size=(6, 16)).astype(np.float32)
    img = rng.uniform(size=(2, 7, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(losses.normalize(_t(a)).numpy(),
                               np.asarray(jloss.normalize(jnp.asarray(a))), atol=1e-6)
    na, nb = jloss.normalize(jnp.asarray(a)), jloss.normalize(jnp.asarray(b))
    cases = [
        (lambda v: losses.spherical_dist_loss(losses.normalize(v), _t(nb)),
         lambda v: jloss.spherical_dist_loss(jloss.normalize(v), nb), a),
        (lambda v: losses.spherical_dist(losses.normalize(v), _t(na)).sum(),
         lambda v: jloss.spherical_dist(jloss.normalize(v), na).sum(), b),
        (losses.tv_loss, jloss.tv_loss, img),
        (losses.l2_loss, jloss.l2_loss, img),
    ]
    for tfn, jfn, x in cases:
        got, g_got = _vjp_torch(tfn, x, np.float32(1.0))
        ref, g_ref = _vjp_jax(jfn, x, jnp.float32(1.0))
        np.testing.assert_allclose(got, ref, rtol=1e-5)
        np.testing.assert_allclose(g_got, g_ref, atol=1e-5 * np.abs(g_ref).max())


# ---------------------------------------------------------------- Adam


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
def test_cast_state_adam_matches_jax(rng, opt_dtype):
    """Three updates of the port's Adam against the JAX chain (optax.adam for f32
    moments, `_scale_by_adam_cast_state` + scale_by_learning_rate for bf16)."""
    shapes = [(7, 5), (11,), (3, 2, 4)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(3)]
    jtx = j_make_optimizer(1e-3, opt_dtype=opt_dtype)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    tx = make_optimizer(1e-3, opt_dtype=opt_dtype)
    tp = [_t(p) for p in params]
    state = tx.init(tp)
    for g in grads:
        upd, jstate = jtx.update([jnp.asarray(v) for v in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        state = tx.update(tp, [_t(v) for v in g], state)
    assert state.count == 3
    for got, ref in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    adam = next(s for s in jax.tree_util.tree_leaves(jstate, is_leaf=lambda s: hasattr(s, "mu"))
                if hasattr(s, "mu"))
    want_dtype = torch.bfloat16 if opt_dtype == "bfloat16" else torch.float32
    for mine, theirs in ((state.mu, adam.mu), (state.nu, adam.nu)):
        for m, r in zip(mine, theirs):
            assert m.dtype == want_dtype
            np.testing.assert_allclose(m.float().numpy(), np.asarray(r, np.float32),
                                       rtol=1e-6, atol=1e-12)

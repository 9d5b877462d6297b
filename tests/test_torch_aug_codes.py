"""The port's remaining augmentation codes and cutout modes against the JAX
package's, on the CPU: the crops (Cr, Re, Re2, Cc) and the resize R, Ro, the
fused Af-then-Pe warp of `fuse_geometric`, Sh, Gn, Er2, Ji2, Et and Ts, and
MakeCutouts with `pool=False`, another `pool_size`, `interpolate` and
`fuse_geometric`.

torch's and JAX's generators give different numbers, so each code runs whole on
both sides at the same draws: the port's code function draws from a seeded
torch.Generator, the test replays that generator's stream in the order the
sampler's docstring gives, and the JAX function gets those numbers from a
stand-in for `jax.random` (its draws answered in call order). That holds each
code's parameters, its sampler's arithmetic and its draw order to JAX's at once;
the samplers' distributions are tested on their own.

Tolerances (float32): outputs 1e-5 absolute (the same arithmetic; XLA may
contract products into FMAs), 5e-5 for the fused warp (each side solves its
own homography, float32 LU in two libraries, as for `pe_apply` in
tests/test_torch_warp.py), 1e-4 for Ts (its own 8x8 spline system); image
gradients 2e-4 absolute + 1e-4 relative, the JAX warp
tests' own (sums in another order), 1e-3 for Ts. `R` against
jax.image.resize: 1e-5 for values and gradients.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.ops import augment as jaug
from feed_forward_vqgan_clip_tpu.ops.cutouts import MakeCutouts as JMakeCutouts
from feed_forward_vqgan_clip_tpu_torch.ops import augment
from feed_forward_vqgan_clip_tpu_torch.ops.cutouts import MakeCutouts

B, H, W = 4, 24, 28
CODES = ["Ji2", "Ji", "Sh", "Gn", "Pe", "Ro", "Af", "Et", "Ts", "Cr", "Er", "Er2", "Re", "Re2",
         "Cc", "R"]


class _PinnedJax:
    """The `jax` module as jaug sees it, except that jax.random's draws answer
    the given arrays in call order (split passes through)."""

    def __init__(self, values):
        self.queue = [np.asarray(v) for v in values]

        def draw(*args, **kwargs):
            return jnp.asarray(self.queue.pop(0))

        self.random = types.SimpleNamespace(split=jax.random.split, uniform=draw,
                                            bernoulli=draw, normal=draw, permutation=draw)

    def __getattr__(self, name):
        return getattr(jax, name)


def _n(t):
    return t.numpy()


def _coins(g, n, p):
    return _n(torch.rand(n, generator=g) < p)


def _u(g, shape, lo, hi):
    return _n(torch.rand(shape, generator=g) * (hi - lo) + lo)


def _raw(g, *shape):
    return _n(torch.rand(*shape, generator=g))


# code -> (the port's function of (generator, x), JAX's of (key, x), the replay of
# the port's draws as JAX's values, in JAX's call order)
CASES = {
    "Cr": (lambda g, x: augment.random_crop(g, x, 16),
           lambda k, x: jaug.random_crop(k, x, 16, p=0.5),
           lambda g: [_raw(g, B), _raw(g, B), _coins(g, B, 0.5)]),
    "Re": (lambda g, x: augment.random_resized_crop(g, x, 16),
           lambda k, x: jaug.random_resized_crop(k, x, 16, scale=(0.1, 1.0)),
           lambda g: [_u(g, B, 0.1, 1.0), _u(g, B, math.log(0.75), math.log(1.333)),
                      _raw(g, B), _raw(g, B)]),
    "Re2": (lambda g, x: augment.random_resized_crop(g, x, 32, augment.RE2_SCALE),
            lambda k, x: jaug.random_resized_crop(k, x, 32, scale=(0.9, 1.0)),
            lambda g: [_u(g, B, 0.9, 1.0), _u(g, B, math.log(0.75), math.log(1.333)),
                       _raw(g, B), _raw(g, B)]),
    "Ro": (augment.random_rotation, lambda k, x: jaug.random_rotation(k, x, 15.0, p=0.7),
           lambda g: [_u(g, B, -15.0, 15.0), _coins(g, B, 0.7)]),
    "fused": (augment.fused_affine_perspective, jaug.fused_affine_perspective,
              lambda g: [_u(g, B, -15.0, 15.0), _u(g, B, -0.1, 0.1), _u(g, B, -0.1, 0.1),
                         _coins(g, B, 0.7), _raw(g, B, 4, 2), _coins(g, B, 0.7)]),
    "Sh": (augment.random_sharpness, lambda k, x: jaug.random_sharpness(k, x, 0.4, p=0.7),
           lambda g: [_u(g, B, 0.0, 0.4).reshape(B, 1, 1, 1), _coins(g, B, 0.7)]),
    "Gn": (augment.gaussian_noise, lambda k, x: jaug.gaussian_noise(k, x, 0.0, 1.0, p=0.5),
           lambda g: [_n(torch.randn(B, H, W, 3, generator=g)), _coins(g, B, 0.5)]),
    "Er2": (lambda g, x: augment.random_erasing(g, x, same_on_batch=False),
            lambda k, x: jaug.random_erasing(k, x, p=0.7, same_on_batch=False),
            lambda g: [_u(g, B, 0.1, 0.4), _u(g, B, 0.3, 1.0), _u(g, B, 1.0, 1 / 0.3),
                       _raw(g, B), _raw(g, B), _raw(g, B), _coins(g, B, 0.7)]),
    "Ji2": (augment.color_jitter2,
            lambda k, x: jaug.color_jitter(k, x, brightness=0.1, contrast=0.1, saturation=0.05,
                                           hue=0.05, p=0.5),
            lambda g: [_u(g, B, 0.9, 1.1), _u(g, B, 0.9, 1.1), _u(g, B, 0.95, 1.05),
                       _u(g, B, -0.05, 0.05), _n(torch.randperm(4, generator=g)),
                       _coins(g, B, 0.5)]),
    "Et": (augment.elastic_transform, lambda k, x: jaug.elastic_transform(k, x, p=0.7),
           lambda g: [_u(g, (B, H, W, 2), -1.0, 1.0), _coins(g, B, 0.7)]),
    "Ts": (augment.thin_plate_spline, lambda k, x: jaug.thin_plate_spline(k, x, 0.3, p=0.7),
           lambda g: [_u(g, (B, 5, 2), -0.3, 0.3), _coins(g, B, 0.7)]),
    "Cc": (lambda g, x: augment.center_crop(x, 16),
           lambda k, x: jaug.center_crop(k, x, 16), lambda g: []),
    "Cc_up": (lambda g, x: augment.center_crop(x, 40),
              lambda k, x: jaug.center_crop(k, x, 40), lambda g: []),
}


def _vjps(monkeypatch, port_fn, jax_fn, x, pinned, seed):
    """(port out, port grad), (JAX out, JAX grad) at one cotangent."""
    xt = torch.from_numpy(x).requires_grad_()
    out = port_fn(torch.Generator().manual_seed(seed), xt)
    ct = np.random.default_rng(1).normal(size=out.shape).astype(np.float32)
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(ct))
    pinned_jax = _PinnedJax(pinned)
    monkeypatch.setattr(jaug, "jax", pinned_jax)
    want, vjp = jax.vjp(lambda v: jax_fn(jax.random.PRNGKey(0), v), jnp.asarray(x))
    assert not pinned_jax.queue  # JAX made as many draws as the port
    return (out.detach().numpy(), grad.numpy()), (np.asarray(want),
                                                  np.asarray(vjp(jnp.asarray(ct))[0]))


@pytest.mark.parametrize("code", sorted(CASES))
def test_code_matches_jax_at_the_same_draws(monkeypatch, rng, code):
    port_fn, jax_fn, replay = CASES[code]
    x = rng.uniform(0.02, 0.98, size=(B, H, W, 3)).astype(np.float32)
    pinned = replay(torch.Generator().manual_seed(5))
    (got, g_got), (want, g_want) = _vjps(monkeypatch, port_fn, jax_fn, x, pinned, seed=5)
    assert got.shape == want.shape and got.dtype == want.dtype
    tol, g_tol = {"Ts": (1e-4, 1e-3), "fused": (5e-5, 2e-4)}.get(code, (1e-5, 2e-4))
    np.testing.assert_allclose(got, want, atol=tol)
    np.testing.assert_allclose(g_got, g_want, atol=g_tol, rtol=1e-4)


@pytest.mark.parametrize("size", [20, 40])
def test_resize_code_matches_jax_image_resize(rng, size):
    """R: jax.image.resize(..., "bilinear") shrinks with an antialiasing filter
    and enlarges without one; values and the image gradient."""
    x = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    (fn,) = augment.build_augment_pipeline(["R"], size)
    xt = torch.from_numpy(x).requires_grad_()
    out = fn(torch.Generator(), xt)
    ct = rng.normal(size=out.shape).astype(np.float32)
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(ct))
    want, vjp = jax.vjp(lambda v: jaug.resize_bilinear(None, v, size), jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), atol=1e-5)


# ---------------------------------------------------------------- the applying functions


def test_crop_resize_matches_jax_at_pinned_boxes(rng):
    """A shrinking box, a magnifying 6x9 box and a box past the frame (border)."""
    x = rng.uniform(size=(3, H, W, 3)).astype(np.float32)
    box = [np.float32(v) for v in ([1.5, 7.25, -4.0], [0.0, 9.5, 10.0], [27.0, 6.0, 30.0],
                                   [20.0, 9.0, 22.0])]
    ct = rng.normal(size=(3, 16, 16, 3)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = augment._crop_resize(xt, *map(torch.from_numpy, box), 16)
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(ct))
    want, vjp = jax.vjp(lambda v: jaug._crop_resize(v, *map(jnp.asarray, box), 16),
                        jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), atol=2e-4,
                               rtol=1e-4)


def test_rotation_is_af_apply_with_zeros_padding(rng):
    x = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    ang = rng.uniform(-15, 15, B).astype(np.float32)
    zero = np.zeros(B, np.float32)
    got = augment.af_apply(torch.from_numpy(x), *map(torch.from_numpy, (ang, zero, zero)), "zeros")
    want = jaug.af_apply(jnp.asarray(x), jnp.asarray(ang), zero, zero, "zeros", 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert (got.numpy() == 0).any()  # the corners leave the frame


def test_sharpness_blur_keeps_the_border_as_jax(rng):
    x = rng.uniform(size=(2, 9, 11, 3)).astype(np.float32)
    kernel = np.float32([[1, 1, 1], [1, 5, 1], [1, 1, 1]]) / 13
    got = augment._keep_border(augment._conv2d_same(torch.from_numpy(x), torch.from_numpy(kernel)),
                               torch.from_numpy(x))
    want = jaug._keep_border(jaug._conv2d_same(jnp.asarray(x), jnp.asarray(kernel)),
                             jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[:, 0], x[:, 0])


def test_fused_matrices_are_not_af_then_pe():
    """fuse_geometric composes +angle (no kornia fold) with the Pe homography: at
    a pure rotation its matrix is the plain inverse about the centre, unlike
    af_matrices (the kornia sign and fold), by design."""
    ang = torch.tensor([10.0])
    zero = torch.zeros(1)
    end = torch.tensor([[[0.0, 0.0], [27.0, 0.0], [27.0, 23.0], [0.0, 23.0]]])
    m = augment.fused_matrices(ang, zero, zero, torch.tensor([True]), end, torch.tensor([True]),
                               H, W)
    want = augment._affine3(augment._affine_inverse_about_center(
        ang * math.pi / 180, zero, zero, torch.ones(1), H, W))
    np.testing.assert_allclose(m.numpy(), want.numpy(), atol=1e-5)
    assert not np.allclose(m.numpy(), augment.af_matrices(ang, zero, zero, H, W).numpy(),
                           atol=1e-3)


# ---------------------------------------------------------------- samplers


def test_resized_crop_sampler_distribution():
    x0, y0, cw, ch = augment.re_sample(torch.Generator().manual_seed(0), 20000, 64, 48,
                                       augment.RE_SCALE)
    area = cw * ch / (64 * 48)
    assert float(area.min()) >= 0.1 - 1e-3 and float(area.max()) <= 1.0 + 1e-3
    aspect = cw / ch
    assert float(aspect.min()) >= 0.75 - 1e-3 and float(aspect[area < 0.5].max()) <= 1.334
    assert float(x0.min()) >= 0 and float((x0 + cw).max()) <= 48 + 1e-3
    assert float(y0.min()) >= 0 and float((y0 + ch).max()) <= 64 + 1e-3
    assert abs(float(torch.log(aspect[area < 0.5]).mean())) < 0.02  # log-uniform, symmetric


def test_random_crop_sampler_distribution():
    x0, y0 = augment.cr_sample(torch.Generator().manual_seed(1), 20000, 40, 56, 24)
    centred = (x0 == 16.0) & (y0 == 8.0)
    assert abs(float(centred.float().mean()) - 0.5) < 0.02
    assert float(x0.max()) <= 32 and float(y0.max()) <= 16 and float(x0.min()) >= 0


def test_fused_and_spline_samplers():
    ang, tx, ty, af_on, end, pe_on = augment.fused_sample(torch.Generator().manual_seed(2),
                                                          20000, 24, 28)
    assert float(ang.abs().max()) <= 15 and float(tx.abs().max()) <= 2.8 + 1e-4
    for on in (af_on, pe_on):
        assert abs(float(on.float().mean()) - 0.7) < 0.02
    assert float((end[:, 0] - torch.tensor([0.0, 0.0])).min()) >= 0
    src, dst = augment.ts_sample(torch.Generator().manual_seed(3), 5000)
    np.testing.assert_array_equal(src[0].numpy(), np.float32(augment.TPS_SRC))
    assert float((dst - src).abs().max()) <= 0.3 and abs(float((dst - src).mean())) < 0.01


def test_jitter2_sampler_draws_one_order_per_call():
    bf, cf, sf, hf, order = augment.ji2_sample(torch.Generator().manual_seed(4), 5000)
    assert sorted(order.tolist()) == [0, 1, 2, 3]
    for v, lo, hi in ((bf, 0.9, 1.1), (cf, 0.9, 1.1), (sf, 0.95, 1.05), (hf, -0.05, 0.05)):
        assert lo <= float(v.min()) and float(v.max()) <= hi
        assert abs(float(v.mean()) - (lo + hi) / 2) < 0.01


@pytest.mark.parametrize("code,p", [("Ro", 0.7), ("Sh", 0.7), ("Gn", 0.5), ("Et", 0.7),
                                    ("Ts", 0.7), ("Er2", 0.7), ("Ji2", 0.5)])
def test_codes_apply_with_their_probability(code, p):
    x = torch.rand(1000, 12, 12, 3, generator=torch.Generator().manual_seed(6)) * 0.8 + 0.1
    (fn,) = augment.build_augment_pipeline([code], 12)
    out = fn(torch.Generator().manual_seed(7), x)
    assert out.shape == x.shape
    changed = (out != x).flatten(1).any(1).float().mean().item()
    assert abs(changed - p) < 0.05


def test_pipeline_takes_every_code_of_the_jax_table(rng):
    """Each code of JAX's table builds in both packages and runs on a small batch;
    an unknown code raises ValueError in both."""
    x = torch.rand(3, 20, 20, 3, generator=torch.Generator().manual_seed(8))
    for code in CODES:
        jaug.build_augment_pipeline([code], 16)
        (fn,) = augment.build_augment_pipeline([code], 16)
        out = fn(torch.Generator().manual_seed(9), x)
        side = 16 if code in ("Cr", "Re", "Re2", "Cc", "R") else 20
        assert out.shape == (3, side, side, 3), code
    for build in (jaug.build_augment_pipeline, augment.build_augment_pipeline):
        with pytest.raises(ValueError):
            build(["Af", "Zz"], 16)


# ---------------------------------------------------------------- MakeCutouts


@pytest.mark.parametrize("name,kw,replay", [
    ("unpooled_re", dict(pool=False, augs=["Re"]),
     lambda g: [_u(g, 6, 0.1, 1.0), _u(g, 6, math.log(0.75), math.log(1.333)), _raw(g, 6),
                _raw(g, 6)]),
    ("pool_size_cc", dict(pool_size=20, augs=["Cc"]), lambda g: []),
    ("interpolate", dict(augs=["Cc"], interpolate=True, interp_size=10), lambda g: []),
    ("fuse_geometric", dict(augs=["Af", "Pe"], fuse_geometric=True),
     lambda g: [_u(g, 6, -15.0, 15.0), _u(g, 6, -0.1, 0.1), _u(g, 6, -0.1, 0.1),
                _coins(g, 6, 0.7), _raw(g, 6, 4, 2), _coins(g, 6, 0.7)]),
])
def test_cutouts_match_jax(monkeypatch, rng, name, kw, replay):
    """MakeCutouts (cut_size 16, cutn 3, noise 0) on two 24x24 renders."""
    x = rng.uniform(size=(2, 24, 24, 3)).astype(np.float32)
    mc = MakeCutouts(cut_size=16, cutn=3, noise_fac=0.0, **kw)
    jmc = JMakeCutouts(cut_size=16, cutn=3, noise_fac=0.0, **kw)
    if kw.get("fuse_geometric"):
        assert mc.augs == [augment.fused_affine_perspective]
    pinned = replay(torch.Generator().manual_seed(3))
    xt = torch.from_numpy(x).requires_grad_()
    out = mc(torch.Generator().manual_seed(3), xt)
    ct = rng.normal(size=out.shape).astype(np.float32)
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(ct))
    pinned_jax = _PinnedJax(pinned)
    monkeypatch.setattr(jaug, "jax", pinned_jax)
    want, vjp = jax.vjp(lambda v: jmc(jax.random.PRNGKey(0), v), jnp.asarray(x))
    assert not pinned_jax.queue
    side = kw.get("interp_size", 16)
    assert out.shape == want.shape == (6, side, side, 3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), atol=2e-4,
                               rtol=1e-4)

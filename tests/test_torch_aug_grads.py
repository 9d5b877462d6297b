"""The deterministic backwards of the plain-PyTorch codes `R`, `Et` and `Ts`
against the JAX package, on the CPU.

`R` (`resize_bilinear`) is the contraction `jax.image.resize` computes: one
(in, out) weight matrix per axis. `Et` and `Ts` sample through `grid_sample`,
whose image gradient is a stable sort of the taps by destination pixel and a
fixed-order sum of each pixel's run (`segment_sum_sorted`), not torch.gather's
atomic scatter-add.

Tolerances (float32): the weight matrices within 2 float32 ulps of
`compute_weight_mat`'s (weights <= 1; the normalising column sum is taken in
another order than XLA's); `R`'s values and gradient 1e-5 absolute; `Et` and
`Ts` values 1e-5 and 1e-4 absolute (Ts: its own 8x8 spline solve), gradients
2e-4 and 1e-3 absolute + 1e-4 relative (the JAX warp tests' own); against
torch autograd of the plain gather in float64, 1e-12 relative to the largest
gradient (the same products, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

from feed_forward_vqgan_clip_tpu.ops import augment as jaug
from feed_forward_vqgan_clip_tpu_torch.ops import augment

ULP_1 = 2.0 ** -23  # a float32 ulp just below 1


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------- R


@pytest.mark.parametrize("in_size,out_size", [(256, 224), (28, 20), (300, 224), (224, 100),
                                              (24, 40), (7, 30), (224, 256), (24, 24)],
                         ids=["shrink_256_224", "shrink_28_20", "shrink_300_224",
                              "shrink_224_100", "grow_24_40", "grow_7_30", "grow_224_256",
                              "equal_24"])
def test_resize_matrix_matches_jax_weight_mat(in_size, out_size):
    want = np.asarray(jax_scale.compute_weight_mat(
        in_size, out_size, out_size / in_size, 0.0, jax_scale._fill_triangle_kernel, True))
    got = augment.resize_matrix(in_size, out_size, torch.float32, "cpu").numpy()
    assert got.shape == want.shape == (in_size, out_size) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * ULP_1)
    if in_size <= out_size:  # at most two weights a column: no sum order to differ
        np.testing.assert_array_equal(got, want)


def test_resize_matrix_is_cached_and_cast():
    a = augment.resize_matrix(30, 7, torch.bfloat16, "cpu")
    assert a is augment.resize_matrix(30, 7, torch.bfloat16, "cpu")
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, augment.resize_matrix(30, 7, torch.float32, "cpu").to(torch.bfloat16))


@pytest.mark.parametrize("shape,size", [((2, 24, 28, 3), 20), ((2, 24, 28, 3), 40),
                                        ((2, 24, 31, 3), 24), ((1, 64, 64, 3), 17)],
                         ids=["shrink", "grow", "one_axis", "shrink_odd"])
def test_resize_grad_matches_jax_vjp(rng, shape, size):
    x = rng.uniform(size=shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = augment.resize_bilinear(xt, size)
    ct = rng.normal(size=out.shape).astype(np.float32)
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(ct))
    want, vjp = jax.vjp(
        lambda v: jax.image.resize(v, (shape[0], size, size, shape[3]), "bilinear"),
        jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), atol=1e-5)


def test_resize_keeps_an_equal_size_as_it_is(rng):
    """jax.image.resize skips an axis whose size does not change: bf16 in, the
    same bits out."""
    x = torch.from_numpy(rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(augment.resize_bilinear(x, 16), x)


# ---------------------------------------------------------------- the gather's backward


def _gather_autograd(img, gx, gy, mode):
    """The gather as it was differentiated before: torch.gather's autograd."""
    b, h, w, c = img.shape
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = (gx - x0)[..., None], (gy - y0)[..., None]
    flat = img.reshape(b, h * w, c)

    def fetch(xi, yi):
        idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long())
        val = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c)).reshape(
            *xi.shape, c)
        if mode == "zeros":
            inside = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1))[..., None]
            val = torch.where(inside, val, torch.zeros((), dtype=val.dtype))
        return val

    top = fetch(x0, y0) * (1 - wx) + fetch(x0 + 1, y0) * wx
    bot = fetch(x0, y0 + 1) * (1 - wx) + fetch(x0 + 1, y0 + 1) * wx
    return top * (1 - wy) + bot * wy


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_gather_backward_matches_autograd_of_the_gather_in_float64(rng, mode):
    """Samples inside, on integer coordinates, half a pixel and several pixels
    outside the frame: the image and coordinate gradients of the new backward
    equal torch autograd of the plain gather, float64."""
    b, h, w, c, ho, wo = 2, 9, 11, 3, 7, 8
    img = rng.uniform(size=(b, h, w, c))
    gx = rng.uniform(-3.0, w + 2.0, size=(b, ho, wo))
    gy = rng.uniform(-3.0, h + 2.0, size=(b, ho, wo))
    gx[:, 0, :3], gy[:, 0, :3] = [2.0, 0.0, -0.5], [4.0, -0.5, 3.0]  # integer and edge taps
    gout = rng.normal(size=(b, ho, wo, c))
    grads = []
    for fn in (augment.grid_sample, _gather_autograd):
        args = [torch.from_numpy(v.copy()).requires_grad_() for v in (img, gx, gy)]
        out = fn(*args, mode)
        grads.append([out.detach(), *torch.autograd.grad(out, args, torch.from_numpy(gout))])
    for got, want in zip(*grads):
        assert got.dtype == torch.float64
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-12 * scale


def test_gather_backward_is_float32_in_bf16_and_zeroes_outside_taps():
    """Every sample half a pixel left of the frame under zeros padding: only its
    x = 0 taps carry weight (1/2), so columns 1.. get nothing; bf16 in, a bf16
    gradient summed in float32."""
    img = torch.ones(1, 4, 5, 2, dtype=torch.bfloat16, requires_grad=True)
    gx = torch.full((1, 4, 6), -0.5)
    gy = torch.arange(4.0)[None, :, None].expand(1, 4, 6).contiguous()
    out = augment.grid_sample(img, gx, gy, "zeros")
    (grad,) = torch.autograd.grad(out, img, torch.ones_like(out))
    assert grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(grad[0, :, 0].float().numpy(), np.full((4, 2), 3.0))
    assert (grad[0, :, 1:] == 0).all()


def test_segment_sum_sorted_against_float64(rng):
    n, c = 50, 3
    keys = rng.integers(0, n + 1, size=900)  # key n: dropped
    keys[keys == 7] = 8  # key 7: empty
    keys[:200] = 3  # one long run
    vals = rng.normal(size=(900, c)).astype(np.float32)
    got = augment.segment_sum_sorted(torch.from_numpy(keys), torch.from_numpy(vals), n).numpy()
    want = np.zeros((n + 1, c))
    np.add.at(want, keys, vals.astype(np.float64))
    assert got.shape == (n, c) and got.dtype == np.float32
    np.testing.assert_allclose(got, want[:n], rtol=1e-5, atol=1e-5)
    assert (got[7] == 0).all()


def test_segment_sum_sorted_is_a_fixed_pairwise_tree():
    """A run of 5 entries behind the leading zero entry, [0, a, b, c, d, e], sums
    as ((0 + a) + (b + c)) + (d + e): the association, not only the set, is
    fixed (here b + c loses b)."""
    vals = torch.tensor([[1e8], [1.0], [-1e8], [1.0], [0.5]])
    got = augment.segment_sum_sorted(torch.zeros(5, dtype=torch.long), vals, 1)
    a, b, c, d, e = (np.float32(v) for v in vals[:, 0].tolist())
    want = np.float32(np.float32(np.float32(0) + a) + np.float32(b + c)) + np.float32(d + e)
    assert got.item() == want == np.float32(1.5)


# ---------------------------------------------------------------- Et and Ts against JAX


def _vjp_pair(port_fn, jax_fn, x, ct):
    xt = torch.from_numpy(x).requires_grad_()
    out = port_fn(xt)
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(ct))
    want, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    return (out.detach().numpy(), grad.numpy()), (np.asarray(want),
                                                  np.asarray(vjp(jnp.asarray(ct))[0]))


@pytest.mark.parametrize("amp", [1.0, 40.0], ids=["kornia_noise", "clamped_noise"])
def test_elastic_warp_grad_matches_jax_vjp(rng, amp):
    """At pinned noise; amp 40 pushes most of the field onto the clamp at +-1,
    where samples sit half a pixel outside the frame (taps zeroed)."""
    x = rng.uniform(size=(2, 20, 24, 3)).astype(np.float32)
    noise = (rng.uniform(-1, 1, size=(2, 20, 24, 2)) * amp).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    (got, g_got), (want, g_want) = _vjp_pair(
        lambda v: augment.elastic_warp(v, torch.from_numpy(noise)),
        lambda v: jaug.elastic_warp(v, jnp.asarray(noise)), x, ct)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(g_got, g_want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("shift", [0.3, 0.9], ids=["ts_scale", "past_the_frame"])
def test_tps_warp_grad_matches_jax_vjp(rng, shift):
    x = rng.uniform(size=(2, 20, 24, 3)).astype(np.float32)
    src = np.broadcast_to(np.float32(augment.TPS_SRC), (2, 5, 2)).copy()
    dst = (src + rng.uniform(-shift, shift, size=src.shape)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    (got, g_got), (want, g_want) = _vjp_pair(
        lambda v: augment.tps_warp(v, torch.from_numpy(src), torch.from_numpy(dst)),
        lambda v: jaug.tps_warp(v, jnp.asarray(src), jnp.asarray(dst)), x, ct)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(g_got, g_want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("code", ["Et", "Ts"])
def test_code_backward_matches_the_gather_autograd_in_float64(rng, code, monkeypatch):
    """The whole code, float64 image, with the gather's old autograd swapped in
    as the reference."""
    x = rng.uniform(size=(2, 16, 18, 3))
    ct = torch.from_numpy(rng.normal(size=x.shape))
    if code == "Et":
        noise = torch.from_numpy((rng.uniform(-1, 1, size=(2, 16, 18, 2)) * 20).astype(
            np.float32))
        fn = lambda v: augment.elastic_warp(v, noise)  # noqa: E731
    else:
        src = torch.tensor(augment.TPS_SRC).expand(2, 5, 2)
        dst = src + torch.from_numpy(rng.uniform(-0.6, 0.6, size=(2, 5, 2)).astype(np.float32))
        fn = lambda v: augment.tps_warp(v, src, dst)  # noqa: E731
    grads = []
    for patch in (False, True):
        if patch:
            monkeypatch.setattr(augment, "grid_sample", _gather_autograd)
        xt = torch.from_numpy(x.copy()).requires_grad_()
        grads.append(torch.autograd.grad(fn(xt), xt, ct)[0])
    assert grads[0].dtype == torch.float64
    scale = grads[1].abs().max().item()
    assert scale > 0 and (grads[0] - grads[1]).abs().max().item() <= 1e-12 * scale

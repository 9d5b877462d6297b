"""The port's projective warp and its Af/Pe codes against the JAX package, on the CPU.

`warp_projective` on a CPU tensor runs the plain versions of the kernels K9
(`warp_forward_plain`, i.e. `warp_perspective_inverse`) and K10
(`warp_adjoint_plain`, the transpose of the same 4-tap gather). Matrices are
built with the JAX samplers or numpy and the same numbers go to both sides.

Tolerances: the forward 1e-5 absolute in float32 (the same arithmetic; XLA may
contract products into FMAs); bf16 within one bf16 ulp of the float32 result
(one rounding of a float32 value that differs from JAX's by ~1e-7); the
image gradient atol 2e-4, rtol 1e-4, the JAX warp tests' own tolerance (sums in
another order); the dot-product test 1e-10 relative in float64; `pe_apply`'s
output 5e-5 absolute, because each side solves its own homography (float32 LU in
two libraries: ~1e-6 relative in H, ~1e-5 px in the samples). The rectangular
cases (an output frame other than the input's: crops of a 64-px frame to 32, a
box of a 32-px frame zoomed 3.2x to 64, a projective map of 64x48 onto 40x24)
are held to the same tolerances, and to the JAX package's Pallas kernels in
interpret mode at 1e-4 (forward) and 2e-4 (adjoint), the tolerances of its own
tests/test_warp_forward.py and test_warp_adjoint.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.ops import augment as jaug
from feed_forward_vqgan_clip_tpu_torch.ops import augment
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_adjoint import warp_adjoint
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_forward import warp_forward


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _rot_trans_mats(seed, b, h, w):
    """Af-family output->input maps, as tests/test_warp_forward.py draws them."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    ang = jax.random.uniform(k1, (b,), minval=-15.0, maxval=15.0) * math.pi / 180
    tx = jax.random.uniform(k2, (b,), minval=-0.1, maxval=0.1) * w
    ty = jax.random.uniform(k3, (b,), minval=-0.1, maxval=0.1) * h
    inv = jaug._affine_inverse_about_center(ang, tx, ty, jnp.ones((b,)), h, w)
    return np.asarray(jaug._affine3(inv))


def _pe_mats(seed, b, h, w, distortion):
    """Pe-family maps at a given distortion (1.4 crosses the horizon)."""
    start, end = jaug.pe_sample(jax.random.PRNGKey(seed), b, h, w, distortion)
    return np.asarray(jaug._kornia_ac_false_fold(jaug.solve_homography(end, start), h, w))


def _far_overshoot_mat():
    """A translation that sends most samples far outside a 64-px frame."""
    inv = jaug._affine_inverse_about_center(jnp.asarray([0.2]), jnp.asarray([55.0]),
                                            jnp.asarray([-60.0]), jnp.ones((1,)), 64, 64)
    return np.asarray(jaug._affine3(inv))


MATS = {
    "affine": lambda: _rot_trans_mats(0, 2, 64, 64),
    "affine_seed1": lambda: _rot_trans_mats(1, 2, 64, 64),
    "pe_0.3": lambda: _pe_mats(2, 2, 64, 64, 0.3),
    "pe_0.7": lambda: _pe_mats(3, 2, 64, 64, 0.7),
    "horizon_1.4": lambda: _pe_mats(5, 1, 64, 64, 1.4),
    "far_overshoot": _far_overshoot_mat,
    "nonsquare": lambda: _rot_trans_mats(10, 2, 72, 88),
}


def _case(name, seed=0):
    m = MATS[name]()
    h, w = (72, 88) if name == "nonsquare" else (64, 64)
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(m.shape[0], h, w, 3)).astype(np.float32)
    ct = rng.normal(size=img.shape).astype(np.float32)
    return img, m, ct


def _jax_vjp(img, m, mode, ct):
    out, vjp = jax.vjp(lambda x: jaug.warp_perspective_inverse(x, jnp.asarray(m), mode),
                       jnp.asarray(img))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(ct))[0])


def _port_vjp(img, m, mode, ct):
    x = _t(img).requires_grad_()
    mt = _t(m).requires_grad_()
    out = augment.warp_projective(x, mt, mode)
    (out.float() * _t(ct)).sum().backward()
    assert mt.grad is None  # the matrices get no gradient
    return out.detach(), x.grad


def _check_horizon(m, h, w):
    """The draw's output->input denominator changes sign over the output frame."""
    qx, qy = np.meshgrid(np.arange(w), np.arange(h))
    den = m[:, 2, 0, None, None] * qx + m[:, 2, 1, None, None] * qy + m[:, 2, 2, None, None]
    return bool(((den.min((1, 2)) < 0) & (den.max((1, 2)) > 0)).any())


# ---------------------------------------------------------------- forward and adjoint


@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("name", sorted(MATS))
def test_warp_matches_jax(name, mode):
    img, m, ct = _case(name)
    if name == "horizon_1.4":
        assert _check_horizon(m, 64, 64)
    got, g_got = _port_vjp(img, m, mode, ct)
    want, g_want = _jax_vjp(img, m, mode, ct)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(g_got.numpy(), g_want, atol=2e-4, rtol=1e-4)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("name,mode", [("affine", "border"), ("pe_0.7", "zeros")])
def test_bf16_warp_within_one_ulp(name, mode):
    img, m, _ = _case(name)
    img = np.abs(img) / np.abs(img).max()  # an image in [0, 1]
    x16 = _t(img, torch.bfloat16)
    got = augment.warp_projective(x16, _t(m), mode)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jaug.warp_perspective_inverse(jnp.asarray(x16.float().numpy()),
                                                    jnp.asarray(m), mode))
    nz = np.abs(want) > 0
    ulp = np.where(nz, 2.0 ** (np.floor(np.log2(np.where(nz, np.abs(want), 1.0))) - 7), 0.0)
    assert (np.abs(got.float().numpy() - want) <= ulp + 1e-30).all()


@pytest.mark.parametrize("name,mode", [("affine", "border"), ("pe_0.7", "zeros"),
                                       ("horizon_1.4", "zeros"), ("far_overshoot", "border")])
def test_adjoint_is_the_transpose_in_float64(name, mode):
    """<warp(x), g> = <x, warp^T g>: the backward is the forward's exact transpose."""
    img, m, ct = _case(name, seed=1)
    x = torch.from_numpy(img.astype(np.float64)).requires_grad_()
    g = torch.from_numpy(ct.astype(np.float64))
    out = augment.warp_projective(x, _t(m), mode)
    assert out.dtype == torch.float64
    lhs = (out * g).sum()
    lhs.backward()
    rhs = (x.detach() * x.grad).sum()
    assert abs(lhs.item() - rhs.item()) <= 1e-10 * abs(lhs.item())


def test_wrappers_take_the_plain_version_on_the_cpu():
    img, m, ct = _case("pe_0.3")
    before = (warp_forward.launches, warp_adjoint.launches)
    out = warp_forward(_t(img), _t(m), "zeros")
    grad = warp_adjoint(_t(ct), _t(m), "zeros")
    assert (warp_forward.launches, warp_adjoint.launches) == before
    assert out.shape == grad.shape == img.shape


# ---------------------------------------------------------------- rectangular frames


def _crop_np(x0, y0, cw, ch, out):
    """The crop maps of augment._crop_resize, in numpy."""
    m = np.zeros((len(x0), 3, 3), np.float32)
    m[:, 0, 0], m[:, 0, 2] = (np.float32(cw) - 1) / (out - 1), x0
    m[:, 1, 1], m[:, 1, 2] = (np.float32(ch) - 1) / (out - 1), y0
    m[:, 2, 2] = 1
    return m


def _rect_case(name, seed=0):
    """(img, m, ct, output frame, padding, the JAX kernels' kind)."""
    rng = np.random.default_rng(seed)
    hw, out, mode, kind = (64, 64), (32, 32), "border", "crop"
    if name == "crop_64_to_32":  # Re-like boxes: one shrinking, one magnifying
        m = _crop_np([3.5, 20.25], [10.0, 1.75], [50.0, 21.0], [41.0, 26.5], 32)
    elif name == "center_64_to_32":
        m = _crop_np([16.0] * 2, [16.0] * 2, [32.0] * 2, [32.0] * 2, 32)
    elif name == "zoom_32_to_64":  # a 20-px box magnified 3.2x
        m, hw, out = _crop_np([4.0, 11.5], [8.25, 0.0], [20.0] * 2, [20.0] * 2, 64), (32, 32), \
            (64, 64)
    else:  # a Pe draw of a 64x48 frame onto a 40x24 output
        m, hw, out, mode, kind = _pe_mats(4, 2, 64, 48, 0.7), (64, 48), (40, 24), "zeros", \
            "projective"
    img = rng.normal(size=(m.shape[0], *hw, 3)).astype(np.float32)
    ct = rng.normal(size=(m.shape[0], *out, 3)).astype(np.float32)
    return img, m, ct, out, mode, kind


RECT = ["crop_64_to_32", "center_64_to_32", "zoom_32_to_64", "pe_64x48_to_40x24"]


@pytest.mark.parametrize("name", RECT)
def test_rectangular_warp_matches_jax(name):
    img, m, ct, out_hw, mode, _ = _rect_case(name)
    x = _t(img).requires_grad_()
    got = augment.warp_projective(x, _t(m), mode, out_hw)
    (got * _t(ct)).sum().backward()
    want, vjp = jax.vjp(lambda v: jaug.warp_perspective_inverse(v, jnp.asarray(m), mode, out_hw),
                        jnp.asarray(img))
    assert got.shape == (m.shape[0], *out_hw, 3) and x.grad.shape == img.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("name", RECT)
def test_rectangular_adjoint_is_the_transpose_in_float64(name):
    img, m, ct, out_hw, mode, _ = _rect_case(name, seed=1)
    x = torch.from_numpy(img.astype(np.float64)).requires_grad_()
    out = augment.warp_projective(x, _t(m), mode, out_hw)
    lhs = (out * torch.from_numpy(ct.astype(np.float64))).sum()
    lhs.backward()
    rhs = (x.detach() * x.grad).sum()
    assert abs(lhs.item() - rhs.item()) <= 1e-10 * abs(lhs.item())


def test_wrappers_take_the_output_and_input_frames_on_the_cpu():
    img, m, ct, out_hw, mode, _ = _rect_case("crop_64_to_32")
    out = warp_forward(_t(img), _t(m), mode, out_hw)
    grad = warp_adjoint(_t(ct), _t(m), mode, img.shape[1:3])
    assert out.shape == ct.shape and grad.shape == img.shape


# ---------------------------------------------------------------- the Pallas kernels


@pytest.mark.parametrize("kind,mode", [("affine", "border"), ("pe_0.3", "zeros")])
def test_matches_jax_pallas_kernels_in_interpret_mode(monkeypatch, kind, mode):
    """The JAX package's own K9 forward and K10 adjoint (interpret mode on the
    CPU, as tests/test_warp_forward.py and test_warp_adjoint.py run them)."""
    monkeypatch.setattr(jaug, "_WARP_FWD_MODE", "pallas")
    monkeypatch.setattr(jaug, "_WARP_VJP_MODE", "pallas")
    monkeypatch.setattr(jaug, "_WARP_INTERPRET", True)
    img, m, ct = _case(kind)
    pallas_kind = "affine" if kind == "affine" else "projective"
    out, vjp = jax.vjp(lambda x: jaug.warp_projective(x, jnp.asarray(m), mode, 0, pallas_kind),
                       jnp.asarray(img))
    got, g_got = _port_vjp(img, m, mode, ct)
    # the Pallas forward sums its hat contractions in another order (~1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(g_got.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("name", RECT)
def test_rectangular_warp_matches_jax_pallas_kernels_in_interpret_mode(monkeypatch, name):
    """The JAX package's K9 with an `out_hw` frame and K10 with an `in_hw` frame,
    as its `_crop_resize` reaches them."""
    monkeypatch.setattr(jaug, "_WARP_FWD_MODE", "pallas")
    monkeypatch.setattr(jaug, "_WARP_VJP_MODE", "pallas")
    monkeypatch.setattr(jaug, "_WARP_INTERPRET", True)
    img, m, ct, out_hw, mode, kind = _rect_case(name)
    out, vjp = jax.vjp(lambda x: jaug.warp_projective(x, jnp.asarray(m), mode, 0, kind, out_hw),
                       jnp.asarray(img))
    x = _t(img).requires_grad_()
    got = augment.warp_projective(x, _t(m), mode, out_hw)
    (got * _t(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]), atol=2e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------- Af and Pe


def _pe_points(rng, b, h, w, distortion=0.7):
    base = np.asarray([[0.0, 0.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0], [0.0, h - 1.0]],
                      np.float32)
    signs = np.asarray([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float32)
    disp = (rng.uniform(size=(b, 4, 2)) * np.asarray([w, h]) * (distortion / 2) * signs)
    start = np.broadcast_to(base, (b, 4, 2)).astype(np.float32)
    return start, (start + disp).astype(np.float32)


def test_solve_homography_and_fold_match_jax(rng):
    start, end = _pe_points(rng, 6, 40, 56)
    got = augment.solve_homography(_t(end), _t(start))
    want = np.asarray(jaug.solve_homography(jnp.asarray(end), jnp.asarray(start)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    # H maps each end corner onto its start corner
    hom = np.concatenate([end, np.ones((6, 4, 1), np.float32)], -1) @ got.numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(hom[..., :2] / hom[..., 2:], start, atol=1e-3)
    np.testing.assert_allclose(augment._kornia_ac_false_fold(_t(want), 40, 56).numpy(),
                               np.asarray(jaug._kornia_ac_false_fold(jnp.asarray(want), 40, 56)),
                               rtol=1e-6, atol=1e-6)


def test_affine_matrices_match_jax(rng):
    ang = rng.uniform(-0.3, 0.3, 5).astype(np.float32)
    tx, ty = (rng.uniform(-6, 6, (2, 5))).astype(np.float32)
    got = augment._affine3(augment._affine_inverse_about_center(
        _t(ang), _t(tx), _t(ty), torch.ones(5), 40, 56))
    want = jaug._affine3(jaug._affine_inverse_about_center(
        jnp.asarray(ang), jnp.asarray(tx), jnp.asarray(ty), jnp.ones((5,)), 40, 56))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def test_af_apply_matches_jax_at_pinned_draws(rng):
    x = rng.uniform(size=(4, 40, 56, 3)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    ang = rng.uniform(-15, 15, 4).astype(np.float32)
    tx = (rng.uniform(-0.1, 0.1, 4) * 56).astype(np.float32)
    ty = (rng.uniform(-0.1, 0.1, 4) * 40).astype(np.float32)
    xt = _t(x).requires_grad_()
    got = augment.af_apply(xt, _t(ang), _t(tx), _t(ty))
    (got * _t(ct)).sum().backward()
    want, vjp = jax.vjp(lambda v: jaug.af_apply(v, jnp.asarray(ang), jnp.asarray(tx),
                                                jnp.asarray(ty)), jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]),
                               atol=2e-4, rtol=1e-4)


def test_pe_apply_matches_jax_at_pinned_draws(rng):
    x = rng.uniform(size=(4, 40, 56, 3)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    start, end = _pe_points(rng, 4, 40, 56)
    xt = _t(x).requires_grad_()
    got = augment.pe_apply(xt, _t(start), _t(end))
    (got * _t(ct)).sum().backward()
    want, vjp = jax.vjp(lambda v: jaug.pe_apply(v, jnp.asarray(start), jnp.asarray(end)),
                        jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]),
                               atol=2e-4, rtol=1e-4)


def test_af_sampler_distribution():
    ang, tx, ty = augment.af_sample(torch.Generator().manual_seed(0), 4000, 32, 48)
    assert float(ang.abs().max()) <= 15.0 and float(ang.abs().max()) > 13.0
    assert float(tx.abs().max()) <= 0.1 * 48 and float(ty.abs().max()) <= 0.1 * 32
    assert abs(float(ang.mean())) < 1.0  # symmetric
    assert abs(float(ang.std()) - 15 / math.sqrt(3)) < 0.5  # uniform, not normal


def test_pe_sampler_pulls_corners_inward():
    start, end = augment.pe_sample(torch.Generator().manual_seed(1), 2000, 20, 24)
    disp = (end - start).numpy()
    np.testing.assert_array_equal(start[0].numpy(), [[0, 0], [23, 0], [23, 19], [0, 19]])
    # corner 0 moves right and down, corner 2 left and up, 1 and 3 in between
    assert (disp[:, 0] >= 0).all() and (disp[:, 2] <= 0).all()
    assert (disp[:, 1, 0] <= 0).all() and (disp[:, 1, 1] >= 0).all()
    assert np.abs(disp[..., 0]).max() <= 0.35 * 24 + 1e-4
    assert np.abs(disp[..., 1]).max() <= 0.35 * 20 + 1e-4
    assert abs(float(np.abs(disp[..., 0]).mean()) - 0.35 * 24 / 2) < 0.2


@pytest.mark.parametrize("code", ["Af", "Pe"])
def test_geometric_codes_apply_with_probability(code):
    """Each sample is warped with probability 0.7 and otherwise passed through."""
    x = torch.rand(2000, 12, 12, 3, generator=torch.Generator().manual_seed(2))
    (fn,) = augment.build_augment_pipeline([code], 12)
    out = fn(torch.Generator().manual_seed(3), x)
    assert out.shape == x.shape and out.dtype == x.dtype
    changed = (out != x).flatten(1).any(1).float().mean().item()
    assert abs(changed - 0.7) < 0.04

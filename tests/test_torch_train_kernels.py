"""The plain versions of the Mixer train kernels (forward with residuals, channel
backward, token backward) against the JAX package, on the same weights.

Weights are numpy draws carried to the JAX side by io/torch_import.convert_mixer;
inputs and the upstream gradient come from numpy. Comparands:

  * JAX `fused_mixer_block_train` in Pallas interpret mode, forward and
    `jax.vjp`, and its residuals (`_fwd_res_dispatch`). The Pallas kernels use
    polynomial erf and gelu' (|gelu' err| <= 1.4e-5 in f32,
    ops/pallas/mixer_block.py `_gelu_val_grad`), the port exact erf / exp;
  * `jax.grad` of the JAX Mixer block module (exact erf);
  * torch.autograd of the port's `mixer_block_plain`.

Tolerances, as max |port - ref| / max |ref|: float32 1e-4 (the polynomial's
error and f32 sums in other orders), except gelu' itself, held to 3e-5 absolute
(the polynomial bound plus rounding); bfloat16 against the Pallas kernels 3e-2
(8 mantissa bits rounded at different points); against torch autograd 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.io.torch_import import convert_mixer
from feed_forward_vqgan_clip_tpu.models.mappers.mixer import MixerBlock as JMixerBlock
from feed_forward_vqgan_clip_tpu.ops.pallas.mixer_block import (
    _fwd_res_dispatch,
    fused_mixer_block_train,
)
from feed_forward_vqgan_clip_tpu_torch.models.mappers.fused import (
    fused_mixer_train_forward,
    make_mapper_train_apply,
)
from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import Mixer
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
    MixerBlockTrain,
    MixerBlockWeights,
    mixer_block_fwd_res,
    mixer_block_fwd_res_plain,
    mixer_block_plain,
    mixer_channel_bwd,
    mixer_channel_bwd_plain,
    mixer_token_bwd,
    mixer_token_bwd_plain,
)

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
S, DIM, B = 8, 32, 3  # T = 64 tokens, Et = 256, Ec = 128


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _random_state_dict(module, rng):
    """numpy draws: matrices N(0, 1/fan_in), norm scales 1 + N(0, 0.1), biases N(0, 0.1)."""
    sd = {}
    for k, v in module.state_dict().items():
        if v.dim() >= 2:
            a = rng.normal(size=v.shape) / np.sqrt(np.prod(v.shape[1:]))
        else:
            a = 0.1 * rng.normal(size=v.shape) + (k.endswith("weight") and "norm" in k)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def _block(rng, dtype=torch.float32, depth=1):
    """(port Mixer, JAX params of the same weights, x, dout) as numpy/torch."""
    tm = Mixer(24, S, 8, DIM, depth, dtype=dtype)
    sd = _random_state_dict(tm, rng)
    tm.load_state_dict(sd)
    params = convert_mixer({k: v.numpy() for k, v in sd.items()}, depth)
    x = rng.normal(size=(B, S * S, DIM)).astype(np.float32)
    dout = rng.normal(size=(B, S * S, DIM)).astype(np.float32)
    return tm, params, x, dout


def _port_grads(gp):
    """JAX block param grads -> MixerBlockWeights layouts (torch (out, in))."""
    a = lambda v: np.asarray(v, np.float32)  # noqa: E731
    return MixerBlockWeights(
        ln1_w=a(gp["token_norm"]["scale"]), ln1_b=a(gp["token_norm"]["bias"]),
        t1=a(gp["token_fc1"]).T, t1b=a(gp["token_fc1_bias"]),
        t2=a(gp["token_fc2"]).T, t2b=a(gp["token_fc2_bias"]),
        ln2_w=a(gp["channel_norm"]["scale"]), ln2_b=a(gp["channel_norm"]["bias"]),
        w1=a(gp["channel_fc1"]["kernel"]).T, b1=a(gp["channel_fc1"]["bias"]),
        w2=a(gp["channel_fc2"]["kernel"]).T, b2=a(gp["channel_fc2"]["bias"]),
    )


def _plain_train(x, dout, w):
    """The port's plain forward and backward: (out, residuals, dx, MixerBlockWeights of grads)."""
    out, res = mixer_block_fwd_res_plain(x, w)
    ch = mixer_channel_bwd_plain(dout, res, w)
    tok = mixer_token_bwd_plain(ch.dr, x, res.g1, res.dg1, w)
    grads = MixerBlockWeights(
        ln1_w=tok.ln1_w, ln1_b=tok.ln1_b, t1=tok.t1, t1b=tok.t1b, t2=tok.t2, t2b=tok.t2b,
        ln2_w=ch.ln2_w, ln2_b=ch.ln2_b, w1=ch.w1, b1=ch.b1, w2=ch.w2, b2=ch.b2)
    return out, res, tok.dx, grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_train_kernels_match_pallas_vjp(rng, dtype):
    tm, params, x, dout = _block(rng, dtype)
    p = params["params"]["block_0"]
    jdt = JDT[dtype]
    jx = jnp.asarray(x, jdt)
    out_j, vjp = jax.vjp(lambda xx, pp: fused_mixer_block_train(xx, pp, jdt, True), jx, p)
    gx_j, gp_j = vjp(jnp.asarray(dout, jdt))
    tx = torch.from_numpy(x).to(dtype)
    out, res, dx, grads = _plain_train(tx, torch.from_numpy(dout),
                                       tm.blocks[0].kernel_weights(dtype))
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert out.dtype == dtype and _rel(out.float(), out_j) <= tol
    assert _rel(dx, gx_j) <= tol
    for name, want in zip(MixerBlockWeights._fields, _port_grads(gp_j)):
        assert _rel(getattr(grads, name), want) <= tol, name
    # the saved residuals: (out, g1, dg1, rhat, inv2, g3, dg3)
    ref = _fwd_res_dispatch(jx, p, jdt, True)
    for name, want in zip(("g1", "rhat", "inv2", "g3"), (ref[1], ref[3], ref[4], ref[5])):
        assert _rel(getattr(res, name).float(), want) <= tol, name
    if dtype == torch.float32:
        for got, want in ((res.dg1, ref[2]), (res.dg3, ref[6])):
            assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 3e-5


def test_plain_train_kernels_match_jax_module_grad(rng):
    """The ROADMAP C comparand: XLA autodiff of the JAX module path (exact erf)."""
    tm, params, x, dout = _block(rng)
    p = params["params"]["block_0"]
    block = JMixerBlock(tokens=S * S, dim=DIM, dtype=jnp.float32)

    def scalar(pp, xx):
        return jnp.sum(block.apply({"params": pp}, xx) * dout)

    gp_j, gx_j = jax.jit(jax.grad(scalar, argnums=(0, 1)))(p, jnp.asarray(x))
    _, _, dx, grads = _plain_train(torch.from_numpy(x), torch.from_numpy(dout),
                                   tm.blocks[0].kernel_weights(torch.float32))
    assert _rel(dx, gx_j) <= 1e-4
    for name, want in zip(MixerBlockWeights._fields, _port_grads(gp_j)):
        assert _rel(getattr(grads, name), want) <= 1e-4, name


def test_plain_backward_matches_torch_autograd(rng):
    tm, _, x, dout = _block(rng)
    w = tm.blocks[0].kernel_weights(torch.float32)
    ws = [v.clone().requires_grad_() for v in w]
    tx = torch.from_numpy(x).requires_grad_()
    out = mixer_block_plain(tx, MixerBlockWeights(*ws))
    want = torch.autograd.grad(out, [tx, *ws], torch.from_numpy(dout))
    _, _, dx, grads = _plain_train(torch.from_numpy(x), torch.from_numpy(dout), w)
    assert _rel(dx, want[0]) <= 1e-5
    for name, g in zip(MixerBlockWeights._fields, want[1:]):
        assert _rel(getattr(grads, name), g) <= 1e-5, name


def test_mixer_block_train_function_reaches_f32_masters(rng):
    """MixerBlockTrain on CPU tensors runs the plain versions; its grads land on the
    block's float32 parameters (through the differentiable weight view) unrounded,
    also when the compute dtype is bf16."""
    counts = (mixer_block_fwd_res.launches, mixer_channel_bwd.launches,
              mixer_token_bwd.launches)
    for dtype in (torch.float32, torch.bfloat16):
        tm, _, x, dout = _block(rng, dtype)
        block = tm.blocks[0]
        tx = torch.from_numpy(x).to(dtype).requires_grad_()
        dy = torch.from_numpy(dout).to(dtype)
        out = MixerBlockTrain.apply(tx, dtype, *block.train_weights())
        out.backward(dy)
        _, _, dx, grads = _plain_train(tx.detach(), dy.float(), block.kernel_weights(dtype))
        assert tx.grad.dtype == dtype
        np.testing.assert_array_equal(tx.grad.float().numpy(), dx.to(dtype).float().numpy())
        for name, param in zip(MixerBlockWeights._fields, block.train_weights()):
            leaf = {"t1": block[0].fn[0].weight, "t2": block[0].fn[3].weight}.get(name)
            g = (leaf.grad[:, :, 0] if leaf is not None else
                 dict(block.named_parameters())[_PARAM_NAMES[name]].grad)
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), getattr(grads, name).numpy())
    assert counts == (mixer_block_fwd_res.launches, mixer_channel_bwd.launches,
                      mixer_token_bwd.launches)


_PARAM_NAMES = {
    "ln1_w": "0.norm.weight", "ln1_b": "0.norm.bias", "t1b": "0.fn.0.bias",
    "t2b": "0.fn.3.bias", "ln2_w": "1.norm.weight", "ln2_b": "1.norm.bias",
    "w1": "1.fn.0.weight", "b1": "1.fn.0.bias", "w2": "1.fn.3.weight", "b2": "1.fn.3.bias",
}


def test_fused_train_forward_matches_module_grads(rng):
    """The mapper through MixerBlockTrain (plain versions on CPU) against the module
    path, f32, two blocks: output and every parameter grad within 1e-5 relative,
    the grad's scale floored at 1e-3 of the largest grad (the token-FF output
    bias's grad is zero but for rounding: the next LayerNorms remove a per-token
    shift)."""
    tm, _, _, _ = _block(rng, depth=2)
    x = torch.from_numpy(rng.normal(size=(2, 24)).astype(np.float32))
    dz = torch.from_numpy(rng.normal(size=(2, S, S, 8)).astype(np.float32))
    grads = []
    for fn in (tm, make_mapper_train_apply(tm), lambda v: fused_mixer_train_forward(tm, v)):
        tm.zero_grad(set_to_none=True)
        z = fn(x)
        z.backward(dz)
        grads.append((z.detach(), {n: p.grad.clone() for n, p in tm.named_parameters()}))
    (z_mod, g_mod), (z_apply, g_apply), (z_fused, g_fused) = grads
    np.testing.assert_array_equal(z_apply.numpy(), z_mod.numpy())  # CPU input: the module
    assert _rel(z_fused, z_mod) <= 1e-5
    top = max(float(g.abs().max()) for g in g_mod.values())
    for n, g in g_mod.items():
        np.testing.assert_array_equal(g_apply[n].numpy(), g.numpy())
        err = float((g_fused[n] - g).abs().max())
        assert err <= 1e-5 * (float(g.abs().max()) + 1e-3 * top), n

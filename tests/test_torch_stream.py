"""The port's stacked Mixer layout, its per-block kernel (K5) and its whole-stack
kernel (K4) against the JAX package's, on the same weights; the Mixer's
inference route (`fused.mapper_route`) and the apply that follows it.

Weights are numpy draws for the port's Mixer, carried to the JAX side by
io/torch_import.convert_mixer; JAX's stacked arrays reach the port through
io/from_jax.stacked_mixer_weights. The JAX Pallas kernels run in interpret mode.
Sizes: dim 128, T=256 (16x16 tokens), depth 2-3, B=2. Tolerances, as
max |port - JAX| / max |JAX|: float32 2e-5 (the same math in another summation
order; JAX's GELU is a polynomial within 1.5e-6 of erf), bfloat16 3e-2 (8
mantissa bits, JAX's bf16 GELU polynomial within 3.3e-4), as in
tests/test_fused_mixer.py. The stacked matrices are bit-equal to JAX's; b1f, a
float32 matrix-vector product summed in another order, within 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.io.torch_import import convert_mixer
from feed_forward_vqgan_clip_tpu.models.mappers import fused as jfused
from feed_forward_vqgan_clip_tpu.models.mappers.mixer import Mixer as JMixer
from feed_forward_vqgan_clip_tpu.ops.pallas.mixer_block import (
    fused_mixer_block_stacked,
    fused_mixer_stream,
)
from feed_forward_vqgan_clip_tpu.ops.pallas.mixer_block import (
    stack_mixer_params as j_stack_mixer_params,
)
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import stacked_mixer_weights
from feed_forward_vqgan_clip_tpu_torch.models.mappers import fused
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
from feed_forward_vqgan_clip_tpu_torch.models.mappers.fused import (
    STREAM_MAX_BATCH,
    make_mapper_apply,
    mapper_route,
    prepare_streamed_params,
    streamed_mixer_forward,
    streamed_supported,
)
from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import Mixer
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
    STACKED_MATRICES,
    StackedMixerWeights,
    mixer_block_stacked,
    mixer_block_stacked_plain,
    stack_mixer_params,
)
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_stream import (
    STREAM_GEMMS,
    barriers_per_launch,
    gemm_plans,
    mixer_stream,
    mixer_stream_plain,
    stream_plan,
    stream_route,
)

DIM, S, B, IN, CH = 128, 16, 2, 32, 8
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _pair(depth, dtype, seed=0):
    """(port Mixer, JAX Mixer, JAX params) on the same numpy draws: matrices
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1), biases and shifts N(0, 0.1), so the
    LN2 fold is not the identity."""
    rng = np.random.default_rng(seed)
    mapper = Mixer(input_dim=IN, image_size=S, channels=CH, dim=DIM, depth=depth, dtype=dtype)
    sd = {}
    for k, v in mapper.state_dict().items():
        if v.dim() >= 2:
            a = rng.normal(size=v.shape) / np.sqrt(np.prod(v.shape[1:]))
        else:
            a = 0.1 * rng.normal(size=v.shape) + (k.endswith("weight") and "norm" in k)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    mapper.load_state_dict(sd)
    jmapper = JMixer(input_dim=IN, image_size=S, channels=CH, dim=DIM, depth=depth,
                     dtype=JDT[dtype])
    params = convert_mixer({k: v.numpy() for k, v in sd.items()}, depth)
    return mapper.eval(), jmapper, params


def _activations(seed, dtype):
    x = np.random.default_rng(seed).normal(size=(B, S * S, DIM)).astype(np.float32)
    return torch.from_numpy(x).to(dtype), jnp.asarray(x).astype(JDT[dtype])


def _j_stack(params, depth, dtype):
    p = params["params"]
    return j_stack_mixer_params([p[f"block_{i}"] for i in range(depth)], dtype=JDT[dtype])


@DTYPES
def test_stack_mixer_params_matches_jax(dtype):
    mapper, _, params = _pair(3, dtype)
    got = stack_mixer_params([b.kernel_weights(torch.float32) for b in mapper.blocks], dtype)
    want = stacked_mixer_weights(_j_stack(params, 3, dtype), dtype)
    for name in StackedMixerWeights._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert g.dtype == (dtype if name in STACKED_MATRICES else torch.float32), name
        if name == "b1f":
            assert float((g - w).abs().max() / w.abs().max()) <= 1e-6
        else:
            assert torch.equal(g, w), name


@DTYPES
def test_mixer_stream_matches_jax_stream(dtype):
    """The whole stack (the plain version on a CPU tensor) against
    `fused_mixer_stream`, on JAX's stacked arrays."""
    depth = 3 if dtype == torch.float32 else 2
    _, _, params = _pair(depth, dtype, seed=1)
    jsp = _j_stack(params, depth, dtype)
    x, jx = _activations(2, dtype)
    ref = fused_mixer_stream(jx, jsp, dtype=JDT[dtype], interpret=True)
    before = mixer_stream.launches
    got = mixer_stream(x, stacked_mixer_weights(jsp, dtype))
    assert mixer_stream.launches == before  # a CPU tensor launches nothing
    assert got.dtype == dtype
    assert _rel(got.float(), ref) <= TOL[dtype]


@pytest.mark.parametrize("block_idx", [0, 1, 2])
def test_mixer_block_stacked_matches_jax(block_idx):
    _, _, params = _pair(3, torch.float32, seed=3)
    jsp = _j_stack(params, 3, torch.float32)
    x, jx = _activations(4, torch.float32)
    ref = fused_mixer_block_stacked(jx, jsp, block_idx=block_idx, dtype=jnp.float32,
                                    interpret=True)
    before = mixer_block_stacked.launches
    got = mixer_block_stacked(x, stacked_mixer_weights(jsp), block_idx)
    assert mixer_block_stacked.launches == before
    assert _rel(got, ref) <= TOL[torch.float32]


@DTYPES
def test_streamed_mixer_forward_matches_jax(dtype):
    mapper, jmapper, params = _pair(2, dtype, seed=5)
    x = np.random.default_rng(6).normal(size=(3, IN)).astype(np.float32)
    jspp = jfused.prepare_streamed_params(jmapper, params)
    ref = jfused.streamed_mixer_forward(jmapper, jspp, jnp.asarray(x), interpret=True)
    got = streamed_mixer_forward(mapper, prepare_streamed_params(mapper), torch.from_numpy(x))
    assert got.shape == (3, S, S, CH) and got.dtype == dtype
    assert _rel(got.float(), ref) <= TOL[dtype]


@pytest.fixture
def card_rule(monkeypatch):
    """`make_mapper_apply` routes a CPU tensor as `mapper_route` routes a CUDA
    one, so the kernels' plain versions run where the kernels would."""
    monkeypatch.setattr(fused, "mapper_route",
                        lambda m, n, device: mapper_route(m, n, torch.device("cuda")))


def test_streamed_apply_matches_module_path(card_rule):
    """The apply's stream route computes the module's function: float32, folded
    LN2 against the affine LN2, within 2e-5."""
    mapper, _, _ = _pair(2, torch.float32, seed=7)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, IN)).astype(np.float32))
    with torch.no_grad():
        ref = mapper(x)
    assert _rel(make_mapper_apply(mapper)(x), ref) <= TOL[torch.float32]


@pytest.mark.parametrize("batch,route", [(STREAM_MAX_BATCH, "stream"),
                                         (STREAM_MAX_BATCH + 1, "block")])
def test_streamed_apply_routes_by_batch(monkeypatch, card_rule, batch, route):
    """Under the card's rule at most STREAM_MAX_BATCH rows run the stack in one
    `mixer_stream` call, more one `mixer_block` call a block; both compute the
    module's function (float32, within 2e-5). Each layout is built once, at the
    first call that takes its route."""
    mapper, _, _ = _pair(2, torch.float32, seed=11)
    calls, built = [], []
    stream, block = fused.mixer_stream, fused.mixer_block
    prepare = fused.prepare_streamed_params
    monkeypatch.setattr(fused, "mixer_stream", lambda *a: calls.append("stream") or stream(*a))
    monkeypatch.setattr(fused, "mixer_block", lambda *a: calls.append("block") or block(*a))
    monkeypatch.setattr(fused, "prepare_streamed_params",
                        lambda m: built.append("stack") or prepare(m))
    x = torch.from_numpy(np.random.default_rng(12).normal(size=(batch, IN)).astype(np.float32))
    apply_fn = make_mapper_apply(mapper)
    got, again = apply_fn(x), apply_fn(x)
    assert calls == ([route] * 2 if route == "stream" else [route] * 4)
    assert built == (["stack"] if route == "stream" else [])
    assert torch.equal(got, again)
    with torch.no_grad():
        assert _rel(got, mapper(x)) <= TOL[torch.float32]


def test_mixer_stream_plain_loops_the_stacked_block():
    _, _, params = _pair(2, torch.float32, seed=9)
    sp = stacked_mixer_weights(_j_stack(params, 2, torch.float32))
    x, _ = _activations(10, torch.float32)
    want = mixer_block_stacked_plain(mixer_block_stacked_plain(x, sp, 0), sp, 1)
    assert torch.equal(mixer_stream_plain(x, sp), want)
    assert torch.equal(mixer_stream(x, sp), want)


def test_streamed_supported():
    mapper, _, _ = _pair(1, torch.float32)
    assert streamed_supported(mapper)
    assert not streamed_supported(Mixer(input_dim=IN, image_size=4, channels=CH, dim=16,
                                        depth=1, dropout=0.1))
    assert not streamed_supported(torch.nn.Linear(2, 2))


ROUTE_FAMILIES = {
    "mixer": dict(model_type="mlp_mixer", dim=16, depth=1, vq_image_size=4),
    "mixer_tp": dict(model_type="mlp_mixer", dim=16, depth=1, vq_image_size=4),
    "vitgan": dict(model_type="vitgan", dim=12, depth=1, vq_image_size=8, num_heads=3),
    "xtransformer": dict(model_type="xtransformer", dim=16, depth=1, vq_image_size=4,
                         num_heads=2),
}


@pytest.mark.parametrize("n", [1, STREAM_MAX_BATCH, STREAM_MAX_BATCH + 1, 256])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("family", sorted(ROUTE_FAMILIES))
def test_mapper_route(family, dropout, device, n):
    """The one inference rule for the Generator and the Predictor: off CUDA,
    and for every mapper without a kernel (VitGAN, x-transformer, a Mixer split
    for tensor parallelism), the module; on CUDA a Mixer of at most
    STREAM_MAX_BATCH rows with dropout 0 takes K4 ("stream"), any other Mixer
    K2 a block ("block"). Only the device's type is read: nothing is allocated."""
    cfg = dict(ROUTE_FAMILIES[family], clip_model="ViT-B/32", dropout=dropout)
    mapper = build_mapper(cfg, vq_channels=CH, device="meta")
    if family == "mixer_tp":
        mapper.tp = object()  # what parallel/tensor_parallel.py marks a split Mixer with
    if device == "cpu" or family != "mixer":
        want = "module"
    elif n <= STREAM_MAX_BATCH and dropout == 0:
        want = "stream"
    else:
        want = "block"
    assert mapper_route(mapper, n, torch.device(device)) == want


@pytest.mark.parametrize("batch,tiles,splits,k_split,barriers", [
    (1, (64, 16, 64, 16), (1, 2, 2, 8), (4, 8, 8, 8), 32 * 7),
    (4, (256, 64, 256, 64), (1, 2, 1, 2), (4, 8, 16, 32), 32 * 6),
])
def test_flagship_split_k_plans_and_barriers(batch, tiles, splits, k_split, barriers):
    """The wgmma route's plan at the flagship (T=256, D=1024, Et=1024, Ec=4096,
    bf16, 132 SMs): each GEMM's 128 x 128 tiles (g1, r, g3, out), its K splits
    (K steps of 64 each), and the kernel's grid-wide barriers per launch (six
    phases a block, one more where g1 or g3 splits: r's and out's sums run
    inside the next row phase); on one SM every K stays whole."""
    plan = stream_plan(batch, 256, 1024, 1024, 4096, 132)
    assert (plan.tiles, plan.splits, plan.k_split) == (tiles, splits, k_split)
    assert plan.barriers(32) == barriers
    whole = stream_plan(batch, 256, 1024, 1024, 4096, 1)
    assert whole.tiles == tiles
    assert whole.splits == (1, 1, 1, 1) and whole.barriers(32) == 32 * 6
    assert whole.k_split == (4, 16, 16, 64)


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("b,t,d", [(1, 256, 1024), (4, 256, 1024), (8, 64, 128), (3, 56, 200)])
def test_stream_plan_splits_cover_k(sms, b, t, d):
    """Every split holds at least 8 K steps of 64 and the splits cover K exactly;
    doubling stops while the doubled tiles would overflow one wave of `sms`."""
    plan = stream_plan(b, t, d, 4 * t, 4 * d, sms)
    for name, tiles, splits, per, k in zip(STREAM_GEMMS, plan.tiles, plan.splits, plan.k_split,
                                           (t, 4 * t, d, 4 * d)):
        steps = -(-k // 64)
        assert (splits - 1) * per < steps <= splits * per, name
        if splits > 1:
            assert per >= 8 and tiles * splits <= sms, name


@pytest.mark.parametrize("batch,plans,barriers", [
    (1, [(2, 128), (8, 128), (4, 256), (16, 256)], 32 * 10),
    (4, [(1, 256), (4, 256), (1, 1024), (4, 1024)], 32 * 8),
])
def test_tile_route_split_k_plans_and_barriers(batch, plans, barriers):
    """The WMMA / FMA tile route's K2 split-K plan at the flagship (the float32
    route takes it; 132 SMs) and its grid-wide barriers per launch."""
    got = gemm_plans(batch, 256, 1024, 1024, 4096, torch.bfloat16, 132)
    assert got == plans
    assert barriers_per_launch(32, got) == barriers


@pytest.mark.parametrize("t,d,dtype,route", [
    (256, 1024, torch.bfloat16, "wgmma"),  # the flagship
    (64, 96, torch.bfloat16, "wgmma"),
    (49, 100, torch.bfloat16, "wmma"),  # rows of 49 and 100 elements: TMA cannot read them
    (256, 1024, torch.float32, "fma"),
])
def test_stream_route_by_dtype_and_shape(t, d, dtype, route):
    """K4 takes the persistent wgmma kernel in bf16 wherever TMA can read T, D, Et
    and Ec rows, the WMMA tile's kernel at other bf16 shapes, the FMA tile in f32."""
    sp = stack_mixer_params([_block_weights(t, d, s) for s in range(2)], dtype)
    x = torch.zeros(1, t, d, dtype=dtype)
    assert stream_route(x, sp) == route
    if route == "wgmma":  # a misaligned activation sends it to the tile kernel
        shifted = torch.zeros(t * d + 1, dtype=dtype)[1:].view(1, t, d)
        assert stream_route(shifted, sp) == "wmma"


def _block_weights(t, d, seed):
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import MixerBlockWeights

    g = torch.Generator().manual_seed(seed)

    def n(*shape):
        return torch.randn(*shape, generator=g)

    et, ec = 4 * t, 4 * d
    return MixerBlockWeights(ln1_w=1 + n(d), ln1_b=n(d), t1=n(et, t), t1b=n(et), t2=n(t, et),
                             t2b=n(t), ln2_w=1 + n(d), ln2_b=n(d), w1=n(ec, d), b1=n(ec),
                             w2=n(d, ec), b2=n(d))

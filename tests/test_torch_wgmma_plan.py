"""The Hopper GEMM of csrc/wgmma_gemm.cuh from the CPU side (ops/kernels/wgmma.py):
the tile planner (tile width, persistent grid and the cooperative or ping-pong
schedule, batched walks included), the TMA-eligibility predicate, the Mixer
block's route of each GEMM
(ops/kernels/mixer_block.mixer_gemm_route), and `gemm_reference`, the plain
version of the GEMM contract that the card tests hold the kernel to, checked
here against explicit float32 sums. The kernel itself needs the card
(tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
    MIXER_GEMMS,
    MixerBlockWeights,
    mixer_gemm_route,
    mixer_gemm_routes,
    stack_mixer_params,
    stacked_block_weights,
)
from feed_forward_vqgan_clip_tpu_torch.ops.kernels import wgmma
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.wgmma import (
    EPILOGUES,
    PINGPONG_EPILOGUES,
    WGMMA_ROWS,
    WGMMA_WIDTHS,
    gemm_reference,
    tma_ok,
    wgmma_plan,
    wgmma_tiles,
)

H100_SMS = 132
FORWARD = ("g1", "r", "g3", "out")   # K2, K5, K6
CHANNEL_BWD = ("da3", "drn", "dw2", "dw1")  # K7
TOKEN_BWD = ("da1", "dxn", "dt2", "dt1")  # K8


def _cost(m, n, bn, sms, batch=1):
    tiles = -(-m // WGMMA_ROWS) * -(-n // bn) * batch
    return -(-tiles // sms) * bn, tiles


@pytest.mark.parametrize("m,n,want", [
    (3200, 3072, (128, 132)),  # fc1, dgh at the train loss: 600 tiles, 5 waves
    (3200, 768, (192, 100)),   # fc2, dxn: 100 tiles, one wave (2 waves of 128)
    (100, 3072, (128, 24)),    # ragged rows: one row block
    (100, 96, (128, 1)),
    (65536, 4096, (128, 132)),  # K2's g3 at B=256: 16384 tiles
    (65536, 1024, (128, 132)),  # K2's out at B=256: 4096 tiles
])
def test_plan_at_the_path_shapes(m, n, want):
    """Width and grid; without an epilogue the plan is cooperative."""
    plan = wgmma_plan(m, n, H100_SMS)
    assert (plan.bn, plan.grid) == want and plan.pingpong is False


@pytest.mark.parametrize("sms", [1, 7, 132])
def test_plan_takes_the_cheapest_width_and_a_grid_within_the_tiles(sms):
    for m in (1, 64, 127, 128, 129, 1000, 3200, 9000):
        for n in (8, 64, 96, 128, 192, 200, 384, 768, 1536, 3072, 4096):
            bn, grid, _ = wgmma_plan(m, n, sms)
            assert bn in WGMMA_WIDTHS
            cost, tiles = _cost(m, n, bn, sms)
            others = [_cost(m, n, w, sms)[0] for w in WGMMA_WIDTHS]
            assert cost == min(others)
            if others.count(cost) > 1:  # a tie goes to the narrower tile
                assert bn == min(w for w, c in zip(WGMMA_WIDTHS, others) if c == cost)
            assert grid == min(tiles, sms) >= 1


@pytest.mark.parametrize("m,n,batch,tiles,want", [
    (1024, 1024, 8, 512, (128, 132)),  # g1 at B=8: 8 x 8 x 8 tiles, 4 waves
    (256, 1024, 8, 128, (128, 128)),   # r at B=8: one wave of 128 tiles
    (1024, 1024, 1, 64, (128, 64)),    # g1 at B=1
    (256, 1024, 16, 256, (128, 132)),  # r at B=16: 2 waves (192: 2 waves of 192)
    (200, 136, 3, 12, (128, 12)),      # ragged: 2 row blocks x 2 column blocks x 3
    (1024, 1024, 256, 16384, (128, 132)),  # g1 at B=256: 124-125 tiles a CTA
    (256, 1024, 256, 4096, (128, 132)),    # r at B=256: 31-32 tiles a CTA
])
def test_batched_tiles_and_persistent_grid(m, n, batch, tiles, want):
    """The batch multiplies the tiles of the walk; the grid is min(tiles, SMs)."""
    assert wgmma_tiles(m, n, 128, batch) == -(-m // 128) * -(-n // 128) * batch
    assert wgmma_plan(m, n, H100_SMS, batch)[:2] == want
    assert wgmma_tiles(m, n, want[0], batch) == tiles
    assert wgmma_plan(m, n, H100_SMS, batch)[1] == min(tiles, H100_SMS)
    for sms in (1, 7, 132):
        bn, grid, _ = wgmma_plan(m, n, sms, batch)
        others = [_cost(m, n, w, sms, batch)[0] for w in WGMMA_WIDTHS]
        assert _cost(m, n, bn, sms, batch)[0] == min(others)
        assert grid == min(wgmma_tiles(m, n, bn, batch), sms)


def test_tma_ok_needs_rows_of_16_bytes_and_aligned_bases():
    base = torch.zeros(4096, dtype=torch.bfloat16)
    assert tma_ok((8, 64, 1024), (base,))
    assert not tma_ok((8, 100, 1024), (base,))  # a row of 200 bytes
    assert not tma_ok((50,), ())
    assert tma_ok((), (base[8:], None))  # 16 bytes in
    assert not tma_ok((), (base[1:],))   # 2 bytes in
    assert not tma_ok((), (base[4:],))   # 8 bytes in


def _block(t, d, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    et, ec = 4 * t, 4 * d

    def n(*shape):
        return torch.randn(*shape, generator=g)

    return MixerBlockWeights(ln1_w=1 + n(d), ln1_b=n(d), t1=n(et, t).to(dtype), t1b=n(et),
                             t2=n(t, et).to(dtype), t2b=n(t), ln2_w=1 + n(d), ln2_b=n(d),
                             w1=n(ec, d).to(dtype), b1=n(ec), w2=n(d, ec).to(dtype), b2=n(d))


def test_tma_ok_on_stacked_views():
    """K5 reads one block's weights as views into the stacked layout: each view
    of a flagship-like width starts 16-byte aligned, so K5 takes K2's routes."""
    sp = stack_mixer_params([_block(64, 96, torch.float32, s) for s in range(3)],
                            torch.bfloat16)
    for i in range(3):
        w = stacked_block_weights(sp, i)
        assert tma_ok((64, 96, 256, 384), (w.t1, w.t2, w.w1, w.w2))
    odd = stack_mixer_params([_block(50, 100, torch.float32, s) for s in range(2)],
                             torch.bfloat16)
    assert not tma_ok((50, 100, 200, 400), (odd.t1[1],))  # and the rows are too short


@pytest.mark.parametrize("t,d,dtype,want", [
    # chip_smoke's three Mixer shapes (T, D; Et = 4T, Ec = 4D; B = 8, 3, 2)
    (256, 1024, torch.bfloat16, dict.fromkeys(MIXER_GEMMS, "wgmma")),
    (64, 96, torch.bfloat16, dict.fromkeys(MIXER_GEMMS, "wgmma")),
    (50, 100, torch.bfloat16, dict.fromkeys(MIXER_GEMMS, "wmma")),  # rows of 100, 50
    (256, 1024, torch.float32, dict.fromkeys(MIXER_GEMMS, "fma")),
    (64, 96, torch.float32, dict.fromkeys(MIXER_GEMMS, "fma")),
    (50, 100, torch.float32, dict.fromkeys(MIXER_GEMMS, "fma")),
    # T = 49 (a 7 x 7 grid): the token GEMMs and K8's read rows of 49 or Et = 196;
    # the channel ones fit
    (49, 40, torch.bfloat16, {**dict.fromkeys(("g1", "r") + TOKEN_BWD, "wmma"),
                              **dict.fromkeys(("g3", "out") + CHANNEL_BWD, "wgmma")}),
])
def test_routes_at_the_smoke_shapes(t, d, dtype, want):
    """Every flagship GEMM, K6's four, K7's four and K8's four, takes the wgmma
    tile in bf16; chip_smoke's ragged (3, 64, 96) too, (2, 50, 100) the WMMA tile."""
    assert mixer_gemm_routes(t, d, 4 * t, 4 * d, dtype) == want


# (M, N, K, batch) of the flagship's GEMMs (T=256, D=1024, Et=1024, Ec=4096) at B
def _flagship(b):
    return {"g1": (1024, 1024, 256, b), "r": (256, 1024, 1024, b),
            "g3": (256 * b, 4096, 1024, 1), "out": (256 * b, 1024, 4096, 1),
            "da3": (256 * b, 4096, 1024, 1), "drn": (256 * b, 1024, 4096, 1),
            "dw2": (1024, 4096, 256 * b, 1), "dw1": (4096, 1024, 256 * b, 1),
            "da1": (1024, 1024, 256, b), "dxn": (256, 1024, 1024, b),
            "dt2": (256, 1024, 1024, b), "dt1": (1024, 256, 1024, b)}


@pytest.mark.parametrize("b,tiles", [
    # the wgmma tiles of g1, r, g3, out at 128 columns: the token GEMMs' batch in the walk
    (1, (64, 16, 64, 16)),    # K2 per block: 16-tile GEMMs keep 116 of 132 SMs idle
    (4, (256, 64, 256, 64)),
    (8, (512, 128, 512, 128)),  # K6
    (16, (1024, 256, 1024, 256)),  # K2 at serving's 4x4
])
def test_routes_of_the_flagship_by_batch(b, tiles):
    """At B = 1, 4, 8 (the train step) and 16 the route takes the wgmma tile for
    K6's (K2's) four GEMMs, K7's four and K8's four (the route reads no batch size:
    wgmma without split-K was faster at every one, PERF.md); the tiles of the walk
    and the persistent grid each GEMM is planned with."""
    routes = mixer_gemm_routes(256, 1024, 1024, 4096, torch.bfloat16)
    assert [routes[n] for n in FORWARD + CHANNEL_BWD + TOKEN_BWD] == ["wgmma"] * 12
    for name, want in zip(FORWARD, tiles):
        m, n, _, batch = _flagship(b)[name]
        assert wgmma_tiles(m, n, 128, batch) == want
    for name, (m, n, _, batch) in _flagship(b).items():
        bn, grid, _ = wgmma_plan(m, n, H100_SMS, batch)
        assert bn == 128, name  # narrow tiles win or tie in whole waves at these shapes
        assert grid == min(wgmma_tiles(m, n, bn, batch), H100_SMS)


@pytest.mark.parametrize("b,tiles", [(8, 128), (1, 16), (4, 64)])
def test_token_weight_grad_partials_fill_a_wave_at_b8(b, tiles):
    """dt2 (T x Et) and dt1 (Et x T) have 16 output tiles of 128 x 128: as B batched
    partial products (one per batch element, added in order afterwards) they walk
    16 B tiles, one wave of 128 on 132 SMs at the train step's B=8."""
    for name in ("dt2", "dt1"):
        m, n, _, batch = _flagship(b)[name]
        assert wgmma_tiles(m, n, 128, batch) == tiles
        assert wgmma_plan(m, n, H100_SMS, batch, "f32") == (128, min(tiles, H100_SMS), False)


_FORWARD_EPI = {"g1": "act_only", "r": "res", "g3": "act_only", "out": "res"}  # K2's


@pytest.mark.parametrize("chain,b,want", [
    # (g1, r, g3, out) ping-pong at the flagship
    ("K2", 256, (True, False, True, False)),   # the batch cell: 16384, 4096, 16384, 4096 tiles
    ("K2", 16, (True, False, True, False)),    # 1024 and 256 tiles
    ("K6", 8, (False, False, False, False)),   # g1, g3 take "act"; r, out 128 tiles
    ("K2", 8, (True, False, True, False)),     # 512 and 128 tiles
    ("K2", 4, (False, False, False, False)),   # 256 and 64 tiles: fewer than 2 x 132
    ("K2", 1, (False, False, False, False)),
    ("K6", 32, (False, False, False, False)),  # r and out: 512 tiles of "res"
])
def test_schedule_of_the_mixer_forward(chain, b, want):
    """The inference forward's GELU GEMMs (g1, g3) take the ping-pong walk where
    their tiles are at least twice the SMs; the residual GEMMs (r, out) and the
    train forward's g1 and g3 ("act") stay cooperative; width and grid as before."""
    for name, pingpong in zip(FORWARD, want):
        m, n, _, batch = _flagship(b)[name]
        epi = "act" if chain == "K6" and name in ("g1", "g3") else _FORWARD_EPI[name]
        plan = wgmma_plan(m, n, H100_SMS, batch, epi)
        assert plan.pingpong is pingpong, name
        grid = min(wgmma_tiles(m, n, 128, batch), H100_SMS)
        assert plan[:2] == wgmma_plan(m, n, H100_SMS, batch)[:2] == (128, grid)


@pytest.mark.parametrize("m,n,epi,want", [
    (3200, 3072, "act", (128, 132, False)),   # K11 fc1: 600 tiles of "act", cooperative
    (12800, 768, "res", (128, 132, False)),   # K11 fc2 at 4x the rows: 600 tiles of "res"
    (3200, 768, "res", (192, 100, False)),    # K11 fc2: 100 tiles, one wave of 192
    (3200, 3072, "mul", (128, 132, False)),   # K11 dgh: the backward stays cooperative
    (3200, 768, "f32", (192, 100, False)),    # K11 dxn
    (8 * 256, 4096, "mul", (128, 132, False)),  # K7 da3 at B=8: 512 tiles, cooperative
])
def test_schedule_of_the_clip_mlp_and_the_backward(m, n, epi, want):
    assert wgmma_plan(m, n, H100_SMS, 1, epi) == want


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("epi", list(EPILOGUES) + [None])
def test_pingpong_exactly_where_every_cta_has_two_tiles(epi, sms):
    """Over a grid of shapes and batches: ping-pong exactly where the tiles are at
    least twice the SMs (every persistent CTA walks two or more), the epilogue is
    the forward's and the width is the walk's 128; width and grid do not depend
    on the epilogue."""
    for m in (64, 128, 300, 1024, 3200, 65536):
        for n in (96, 136, 768, 1024, 3072, 4096):
            for batch in (1, 3, 8, 256):
                plan = wgmma_plan(m, n, sms, batch, epi)
                tiles = wgmma_tiles(m, n, plan.bn, batch)
                assert plan[:2] == wgmma_plan(m, n, sms, batch)[:2]
                assert plan.grid == min(tiles, sms)
                want = epi in PINGPONG_EPILOGUES and plan.bn == 128 and tiles >= 2 * sms
                assert plan.pingpong is want
                if plan.pingpong:  # every CTA of the persistent grid gets >= 2 tiles
                    assert tiles // plan.grid >= 2


def test_route_reads_the_bases():
    """A misaligned operand sends the GEMM to the WMMA tile."""
    x = torch.zeros(2 * 256 * 1024 + 1, dtype=torch.bfloat16)
    aligned, shifted = x[:-1], x[1:]
    args = (256, 1024, 1024, 4096, torch.bfloat16)
    assert mixer_gemm_route("g3", *args, (aligned,)) == "wgmma"
    assert mixer_gemm_route("g3", *args, (shifted,)) == "wmma"


# ---------------------------------------------------------------- the GEMM contract


def _explicit(a, b, a_m_major, b_mn_major):
    """C = A . B by explicit float64 sums over k, from the stored layouts."""
    an, bn = a.double().numpy(), b.double().numpy()
    am = np.swapaxes(an, -1, -2) if a_m_major else an      # (.., M, K)
    bk = bn if b_mn_major else np.swapaxes(bn, -1, -2)     # (.., K, N)
    return torch.from_numpy(np.einsum("...mk,...kn->...mn", am, bk))


def _gelu64(v):
    from math import erf, exp, pi, sqrt

    val = np.vectorize(lambda x: 0.5 * x * (1 + erf(x / sqrt(2))))(v)
    grad = np.vectorize(lambda x: 0.5 * (1 + erf(x / sqrt(2))) + x * exp(-x * x / 2) / sqrt(2 * pi))(v)
    return torch.from_numpy(val), torch.from_numpy(grad)


def _bf(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("a_m_major,b_mn_major", [(False, False), (False, True), (True, True)])
@pytest.mark.parametrize("batched", [False, True])
def test_reference_products_against_explicit_sums(a_m_major, b_mn_major, batched):
    """f32: C = A . B in every layout the kernel compiles, a shared A over a
    batched B where `batched`."""
    rng = np.random.default_rng(int(a_m_major) + 2 * int(b_mn_major) + 4 * int(batched))
    m, n, k = 20, 24, 40
    a = _bf(rng, *((k, m) if a_m_major else (m, k)))
    b = _bf(rng, *(((3,) if batched else ()) + ((k, n) if b_mn_major else (n, k))))
    got, aux = gemm_reference(a, b, "f32", a_m_major=a_m_major, b_mn_major=b_mn_major)
    want = _explicit(a, b, a_m_major, b_mn_major)
    assert aux is None and got.dtype == torch.float32
    assert got.shape == want.shape == ((3, m, n) if batched else (m, n))
    assert torch.allclose(got.double(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("a_m_major,b_mn_major", [(False, False), (True, True)])
def test_reference_batch_sum_against_einsum(a_m_major, b_mn_major):
    """The batch-sum form (K8's dt2 and dt1 in its K-major layouts): one f32 C,
    the sum over the batch of the products, against an explicit float64 einsum
    over (z, k); it takes the f32 epilogue and a batched operand only."""
    rng = np.random.default_rng(17 + int(a_m_major))
    batch, m, n, k = 5, 12, 20, 24
    a = _bf(rng, batch, *((k, m) if a_m_major else (m, k)))
    b = _bf(rng, batch, *((k, n) if b_mn_major else (n, k)))
    got, aux = gemm_reference(a, b, "f32", a_m_major=a_m_major, b_mn_major=b_mn_major,
                              batch_sum=True)
    want = np.einsum("zkm,zkn->mn" if a_m_major else "zmk,znk->mn", a.double().numpy(),
                     b.double().numpy())
    assert aux is None and got.dtype == torch.float32 and got.shape == (m, n)
    assert torch.allclose(got.double(), torch.from_numpy(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        gemm_reference(a, b, "mul", batch_sum=True, mul=a)
    with pytest.raises(ValueError):
        gemm_reference(a[0], b[0], "f32", a_m_major=a_m_major, b_mn_major=b_mn_major,
                       batch_sum=True)


@pytest.mark.parametrize("bias_rows", [False, True])
def test_reference_epilogues_keep_the_rounding_points(bias_rows):
    """act, act_only, res and mul against explicit float64 math rounded where the
    kernel rounds: act' and act(v) rounded once, res after round(v), mul's f32 v."""
    rng = np.random.default_rng(7 + int(bias_rows))
    m, n, k = 16, 24, 32
    a, b = _bf(rng, 2, m, k), _bf(rng, 2, k, n)
    bias = torch.from_numpy(rng.normal(size=m if bias_rows else n).astype(np.float32))
    res, mul = _bf(rng, 2, m, n), _bf(rng, 2, m, n)
    v = _explicit(a, b, False, True) + (bias.double()[:, None] if bias_rows else bias.double())
    val, grad = _gelu64(v.numpy())
    kw = dict(b_mn_major=True, bias=bias, bias_rows=bias_rows)
    got, dg = gemm_reference(a, b, "act", **kw)
    tol = dict(rtol=2 ** -7, atol=1e-6)  # one bf16 rounding of a value within f32 of it
    assert got.dtype == dg.dtype == torch.bfloat16
    assert torch.allclose(got.double(), val.to(torch.bfloat16).double(), **tol)
    assert torch.allclose(dg.double(), grad.to(torch.bfloat16).double(), **tol)
    only, none = gemm_reference(a, b, "act_only", **kw)
    assert none is None and torch.equal(only, got)  # K2's output is K6's
    out, _ = gemm_reference(a, b, "res", res=res, **kw)
    want = (v.to(torch.bfloat16).double() + res.double()).to(torch.bfloat16)
    assert torch.allclose(out.double(), want.double(), **tol)
    prod, vf = gemm_reference(a, b, "mul", b_mn_major=True, mul=mul)
    wv = _explicit(a, b, False, True) * mul.double()
    assert vf.dtype == torch.float32 and torch.allclose(vf.double(), wv, rtol=1e-5, atol=1e-5)
    assert torch.equal(prod, vf.to(torch.bfloat16))
    with pytest.raises(ValueError):
        gemm_reference(a, b, "relu")

"""The Hopper GEMM of csrc/wgmma_gemm.cuh (TMA, wgmma, persistent tiles) from
Python: its tile planner, the TMA-eligibility predicate, the launch through the
entry point `ffvc_wgmma_gemm` (csrc/wgmma_gemm.cu), and `gemm_reference`, the
plain version of its contract. K11 (ops/kernels/mlp_ln.py) and the Mixer block
kernels (ops/kernels/mixer_block.py: K2, K5, K6, K7, K8) launch their bf16 GEMMs
through `gemm`; the Mixer stack (K4, ops/kernels/mixer_stream.py) runs the same
tile walk inside its own persistent kernel.

The contract, for z < batch (a batch stride of 0: the operand is shared, as the
Mixer's token weights are):

    C[z] (M x N) = A[z] (M x K) . B[z]     f32 accumulation, one K chain in order
    A K-major (M, K) or M-major (K, M);  B K-major (N, K) or MN-major (K, N)

then the epilogue on v, with an f32 bias per column (N,) where B is K-major or
per row (M,) where B is MN-major (the token GEMMs), as the kernel is compiled:

    act       v += bias; aux = round(act'(v)); C = round(act(v))
    act_only  v += bias; C = round(act(v))
    res       v += bias; C = round(round(v) + res)
    mul       v *= mul; aux (f32, where given) = v; C = round(v)
    f32       C = v, float32

act: exact GELU or quick_gelu (ACTIVATIONS). Rounding is to the working type,
bf16; the tile takes bf16 operands only (the float32 routes keep their FMA tile).

The batch-sum form (`batch_sum`, f32 only; K8's token weight grads) gives one C,
the sum over z of the batch's products: each product lands as an f32 partial
(batch, M, N) and csrc/mixer_train.cu `ffvc_batch_sum` adds them in batch order,
z = 0, 1, ..., one thread per output, so every run gives the same bits.

Two schedules walk a call's tiles (csrc/wgmma_gemm.cuh): cooperative, both
consumer warpgroups on one 128-row tile, its K loop and then its epilogue
together; and ping-pong, each warpgroup on whole tiles of its own with the two
wgmma chains taking turns, so one's GELU epilogue runs under the other's chain.
`wgmma_plan` takes ping-pong for the inference forward's GELU GEMMs (act_only) where
the persistent CTAs get enough tiles each (`takes_pingpong`). Each output is the
same chain of m64 wgmma in K order under either, so both give the same bits.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from feed_forward_vqgan_clip_tpu_torch.ops.kernels import build

# csrc/wgmma_gemm.cuh: output rows of a tile, the tile widths compiled, the epilogues
WGMMA_ROWS = 128
WGMMA_WIDTHS = (128, 192)
EPILOGUES = {"act": 0, "res": 1, "mul": 2, "f32": 3, "act_only": 4}  # WgmmaEpilogue
ACTIVATIONS = {"gelu": 0, "quick_gelu": 1}  # csrc/common.cuh Activation
# csrc/wgmma_gemm_pingpong.cu: the epilogue and the tile width of the ping-pong walk,
# and the tiles a persistent CTA must get, at the least, for the plan to take it
PINGPONG_EPILOGUES = ("act_only",)
PINGPONG_WIDTH = 128
PINGPONG_MIN_TILES_PER_SM = 2
_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


class WgmmaPlan(NamedTuple):
    """How the wgmma GEMM walks one call's tiles: the tile width, the persistent
    CTAs, and whether the consumer warpgroups run in ping-pong (each owns whole
    tiles; one's epilogue under the other's wgmma chain) rather than
    cooperatively (both on one tile, its K loop and then its epilogue together)."""

    bn: int
    grid: int
    pingpong: bool


def wgmma_plan(m: int, n: int, sms: int, batch: int = 1, epi=None) -> WgmmaPlan:
    """The WgmmaPlan of the wgmma GEMM for `batch` (m, n) outputs with epilogue
    `epi` (of EPILOGUES; None: not known) on `sms` SMs. The width of WGMMA_WIDTHS
    whose tiles take the least time in whole waves, waves x width (a tile's time
    grows with its width), the narrower on a tie; the grid min(tiles, SMs); the
    schedule `takes_pingpong`'s. At the train loss's 3200 rows: N = 3072 takes 128
    (600 tiles, 5 waves on 132 SMs: 5 x 128 against 4 x 192), N = 768 takes 192
    (100 tiles, one wave: 1 x 192 against 2 x 128)."""
    best = None
    for bn in WGMMA_WIDTHS:
        tiles = wgmma_tiles(m, n, bn, batch)
        cost = -(-tiles // sms) * bn
        if best is None or cost < best[0]:
            best = (cost, bn, tiles)
    _, bn, tiles = best
    return WgmmaPlan(bn, min(tiles, sms), takes_pingpong(tiles, sms, bn, epi))


def takes_pingpong(tiles: int, sms: int, bn: int, epi) -> bool:
    """Whether a call of `tiles` output tiles at width `bn` with epilogue `epi`
    runs the ping-pong walk: where every persistent CTA gets at least
    PINGPONG_MIN_TILES_PER_SM tiles (a CTA with one tile has nothing to overlap),
    for the inference forward's GELU epilogue (PINGPONG_EPILOGUES) at the width
    the walk is compiled for (PINGPONG_WIDTH: two m64n128 chains hold a
    warpgroup's 128 accumulators a thread). The train forward's "act" (two output
    planes), the residual adds ("res": the ping-pong walk gained them 1-3% alone
    at B=256) and the backward's epilogues stay cooperative."""
    return (epi in PINGPONG_EPILOGUES and bn == PINGPONG_WIDTH
            and tiles >= PINGPONG_MIN_TILES_PER_SM * sms)


def wgmma_tiles(m: int, n: int, bn: int, batch: int = 1) -> int:
    """Output tiles of the persistent walk: row blocks x column blocks x batch."""
    return -(-m // WGMMA_ROWS) * -(-n // bn) * batch


def tma_ok(row_lengths, tensors=()) -> bool:
    """Whether TMA can read and write the GEMM's operands: every operand's row
    length in elements (K or M for A, K or N for B, N for C; a batch stride is a
    whole number of rows) a multiple of 8, i.e. 16-byte row strides, and every
    base 16-byte aligned (a view into a stacked weight too)."""
    return (all(n % 8 == 0 for n in row_lengths)
            and all(t.data_ptr() % 16 == 0 for t in tensors if t is not None))


def _ptr(t):
    return t.data_ptr() if t is not None else None


def gemm(k, a, b, c, m, n, kdim, epi, *, a_m_major=False, b_mn_major=False, batch=1, sa=0,
         sb=0, sc=0, bias=None, bias_rows=False, res=None, mul=None, aux=None, act=0, bn=None,
         batch_sum=False, pingpong=None):
    """One bf16 GEMM of csrc/wgmma_gemm.cuh on launcher `k` (its `lib`, `sms` and
    `stream`): c = a . b with epilogue `epi` of EPILOGUES, as the module docstring
    states; sa, sb, sc batch strides in elements. With `batch_sum` (epi "f32"),
    c (M, N) is the sum over the batch of the products, added in batch order
    from an f32 partial per element (sc is then unused). The tile width and the
    schedule are `wgmma_plan`'s, the width `bn` of WGMMA_WIDTHS where given, the
    schedule `pingpong` (True: ping-pong, False: cooperative) where given: the
    tests and chip_smoke.py time and compare the two, which give the same bits.
    Returns whether the call took the ping-pong walk. Raises where an operand is
    not 16-byte aligned or the launch fails (the entry point refuses ping-pong for
    an epilogue or width it is not compiled for): there is no other route from here."""
    for t in (a, b, c, res, mul, aux):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the wgmma GEMM's operands need 16-byte-aligned bases (TMA)")
    if batch_sum and epi != "f32":
        raise ValueError(f"the batch-sum form takes the f32 epilogue, not {epi!r}")
    out = c
    if batch_sum:
        c, sc = torch.empty(batch, m, n, dtype=torch.float32, device=out.device), m * n
    plan = wgmma_plan(m, n, k.sms, batch, epi)
    if bn is not None and bn != plan.bn:
        tiles = wgmma_tiles(m, n, bn, batch)
        plan = WgmmaPlan(bn, min(tiles, k.sms), takes_pingpong(tiles, k.sms, bn, epi))
    if pingpong is not None:
        plan = plan._replace(pingpong=bool(pingpong))
    build.check(k.lib.ffvc_wgmma_gemm(
        a.data_ptr(), sa, int(a_m_major), b.data_ptr(), sb, int(b_mn_major), c.data_ptr(), sc,
        m, n, kdim, batch, EPILOGUES[epi], _ptr(bias), int(bias_rows), _ptr(res), _ptr(mul),
        _ptr(aux), act, plan.bn, plan.grid, int(plan.pingpong), k.stream), "ffvc_wgmma_gemm")
    if batch_sum:
        build.check(k.lib.ffvc_batch_sum(c.data_ptr(), out.data_ptr(), batch, m * n, k.stream),
                    "ffvc_batch_sum")
    return plan.pingpong


# ---------------------------------------------------------------- plain versions


def gelu_grad(v):
    """d/dv gelu(v) = Phi(v) + v phi(v), exact erf and exp."""
    return 0.5 * (1.0 + torch.erf(v * _SQRT_HALF)) + v * torch.exp(-0.5 * v * v) * _INV_SQRT_2PI


def act_val_grad(h, act):
    """(act(h), act'(h)) in f32: quick_gelu's s = sigmoid(1.702 h), h s and
    s + 1.702 h s (1 - s) (`_quick_gelu_val_grad`), or exact gelu and its derivative."""
    if act == "quick_gelu":
        s = torch.sigmoid(1.702 * h)
        val = h * s
        return val, s + 1.702 * val * (1.0 - s)
    return F.gelu(h), gelu_grad(h)


def gemm_reference(a, b, epi, *, a_m_major=False, b_mn_major=False, bias=None, bias_rows=False,
                   res=None, mul=None, act="gelu", batch_sum=False):
    """The GEMM contract in plain PyTorch: a (M, K), or (K, M) where a_m_major, and
    b (N, K), or (K, N) where b_mn_major, each with an optional leading batch
    dimension (an operand without one is shared by the batch) -> (C, aux): aux
    act' for "act", the f32 v for "mul", else None. Products in float32 (exact for
    bf16 operands), rounded to a's dtype where the kernel rounds. `batch_sum`
    ("f32"): C (M, N) = the batch's products added in batch order."""
    if epi not in EPILOGUES:
        raise ValueError(f"epilogue {epi!r}: the kernel has {sorted(EPILOGUES)}")
    if batch_sum and epi != "f32":
        raise ValueError(f"the batch-sum form takes the f32 epilogue, not {epi!r}")
    dt = a.dtype
    af = a.float().transpose(-1, -2) if a_m_major else a.float()
    bf = b.float() if b_mn_major else b.float().transpose(-1, -2)
    v = torch.matmul(af, bf)
    if batch_sum:
        if v.dim() != 3:
            raise ValueError("the batch-sum form needs a batched operand")
        total = v[0].clone()
        for z in range(1, v.shape[0]):
            total += v[z]
        return total, None
    if bias is not None and epi in ("act", "act_only", "res"):
        v = v + (bias[:, None] if bias_rows else bias)
    if epi in ("act", "act_only"):
        val, grad = act_val_grad(v, act)
        return val.to(dt), (grad.to(dt) if epi == "act" else None)
    if epi == "res":
        return (v.to(dt).float() + res.float()).to(dt), None
    if epi == "mul":
        v = v * mul.float()
        return v.to(dt), v
    return v, None  # f32

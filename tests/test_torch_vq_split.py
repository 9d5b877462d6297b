"""K1's float32-accurate split product from the CPU side (ops/kernels/vq_lookup.py):
the three-piece bf16 split of float32 values (`bf16x3_split`, the plain version of
the card's split kernel), an emulation of the kernel's arithmetic (the six piece
products in float32, in the kernel's order) held to the JAX package's search, and
the codebook splits of `vq_plan`. The kernel itself needs the card
(tests/test_torch_gpu.py).

Tolerances: the split reproduces each value to 2^-24 |v| (exactly, wherever its
last piece stays at or above bf16's subnormal step, |v| >= 2^-110; below that the
floor is half that step, 2^-134). The emulated indices equal the JAX search's except
at near-ties, where the plain float32 top-2 gap is under 4 C eps (|x| max|c| +
max|c|^2), and agree on at least 99.9% of rows, the rule the card's kernel is held
to (chip_smoke.py VQ_MIN_AGREEMENT).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from feed_forward_vqgan_clip_tpu.ops import quantize as jquant
from feed_forward_vqgan_clip_tpu.ops.pallas.vq_lookup import nearest_codebook_indices_pallas
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.vq_lookup import (
    VQ_BN,
    VQ_ROWS,
    bf16x3_split,
    split_pieces,
    vq_plan,
)

H100_SMS = 132
# csrc/vq_lookup.cu: the (x piece, codebook piece) of each product, in the chain's order:
# m.m, l.h, h.l, m.h, h.m, h.h (0 = h, 1 = m, 2 = l)
PRODUCTS = ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0))
TINY = 2.0 ** -110  # below it the last piece runs under bf16's subnormal step

finite_f32 = st.floats(width=32, allow_nan=False, allow_infinity=False)


def _reassembled(v):
    h, m, l = bf16x3_split(v)
    return h, m, l, h.double() + m.double() + l.double()


@settings(max_examples=200, deadline=None)
@given(st.lists(finite_f32, min_size=1, max_size=64))
def test_split_reproduces_finite_f32(values):
    v = torch.tensor(values, dtype=torch.float32)
    h, m, l, back = _reassembled(v)
    assert h.dtype == m.dtype == l.dtype == torch.bfloat16
    err = (back - v.double()).abs()
    big = v.double().abs() >= TINY
    assert (err[big] <= 2.0 ** -24 * v.double().abs()[big]).all()
    assert (err[~big] <= 2.0 ** -134).all()


@settings(max_examples=100, deadline=None)
@given(st.lists(finite_f32, min_size=1, max_size=64))
def test_split_of_bf16_exact_values_is_one_piece(values):
    v = torch.tensor(values, dtype=torch.float32).to(torch.bfloat16).float()
    v = v[v.isfinite()]
    h, m, l, back = _reassembled(v)
    assert torch.equal(h.float(), v)
    assert not m.float().any() and not l.float().any()
    assert torch.equal(back, v.double())


def test_split_keeps_the_largest_finite_values_finite():
    v = torch.tensor([3.4028235e38, -3.4e38, 3.3961e38], dtype=torch.float32)
    h, m, l, back = _reassembled(v)
    assert h.isfinite().all() and m.isfinite().all() and l.isfinite().all()
    assert torch.equal(back, v.double())


def _emulated_indices(x, cb):
    """The kernel's arithmetic on the CPU: x.c as the six bf16 piece products, each
    exact in float32, added in float32 in the chain's order; the first-match argmin of
    |c|^2 - 2 x.c. Test-only: nothing on the path calls it."""
    channels = vq_plan(x.shape[0], cb.shape[0], x.shape[1], H100_SMS).channels
    xp, cp = split_pieces(x, cb, channels)
    acc = torch.zeros(x.shape[0], cb.shape[0], dtype=torch.float32)
    for a, b in PRODUCTS:
        acc = acc + xp[a].float() @ cp[b].float().T
    scores = cb.square().sum(-1)[None] - 2.0 * acc
    return scores.argmin(-1).to(torch.int32).numpy(), acc


@pytest.mark.parametrize("n,k,c", [(300, 2048, 256), (77, 1000, 70)])
def test_emulated_split_product_matches_jax_search(n, k, c):
    rng = np.random.default_rng(n + k + c)
    x = rng.standard_normal((n, c), dtype=np.float32)
    cb = rng.standard_normal((k, c), dtype=np.float32)
    got, acc = _emulated_indices(torch.from_numpy(x), torch.from_numpy(cb))
    # the six products against float64: the dropped terms and the f32 sums
    exact = x.astype(np.float64) @ cb.astype(np.float64).T
    norms = np.linalg.norm(x, axis=1)[:, None] * np.linalg.norm(cb, axis=1)[None]
    assert (np.abs(acc.double().numpy() - exact) <= (c + 3) * 2.0 ** -24 * norms).all()
    # near-ties of the plain float32 scores
    scores = (cb.astype(np.float32) ** 2).sum(-1)[None] - 2.0 * (x @ cb.T)
    top2 = np.sort(scores, axis=1)[:, :2]
    eps = np.finfo(np.float32).eps
    bound = 4 * c * eps * (np.linalg.norm(x, axis=1) * np.linalg.norm(cb, axis=1).max()
                           + (cb ** 2).sum(-1).max())
    near = top2[:, 1] - top2[:, 0] < bound
    for ref in (np.asarray(jquant.nearest_codebook_indices(jnp.asarray(x), jnp.asarray(cb))),
                np.asarray(nearest_codebook_indices_pallas(jnp.asarray(x), jnp.asarray(cb),
                                                           interpret=True))):
        diff = got != ref
        assert diff.mean() <= 1e-3
        assert not (diff & ~near).any()


@pytest.mark.parametrize("n", [256, 1024, 2048, 4096])
def test_plan_splits_the_flagship_codebook(n):
    k = 16384
    plan = vq_plan(n, k, 256, H100_SMS)
    assert plan.channels == 256 and plan.bn == VQ_BN
    assert plan.row_blocks == -(-n // VQ_ROWS) and plan.col_tiles == -(-k // VQ_BN)
    # every code in exactly one split, the splits in code order
    seen = np.zeros(k, dtype=int)
    end = 0
    for s in range(plan.splits):
        begin, stop = plan.split_codes(s, k)
        assert begin == end and stop > begin
        seen[begin:stop] += 1
        end = stop
    assert end == k and (seen == 1).all()
    # the card filled: at least one CTA an SM (every N here has the tiles for it)
    assert plan.row_blocks * plan.col_tiles >= H100_SMS and plan.ctas >= H100_SMS
    # a split's row blocks are neighbours in the launch order, row block 0 first: CTA i
    # holds split i // row_blocks and row block i % row_blocks (csrc/vq_lookup.cu)
    blocks = [divmod(i, plan.row_blocks) for i in range(plan.ctas)]
    for s in range(plan.splits):
        assert blocks[s * plan.row_blocks:(s + 1) * plan.row_blocks] == [
            (s, rb) for rb in range(plan.row_blocks)]


def _time_units(plan, sms):
    return -(-plan.ctas // sms) * -(-plan.col_tiles // plan.splits)


@pytest.mark.parametrize("n,k,c", [(256, 16384, 256), (1024, 16384, 256), (300, 2048, 256),
                                   (77, 1000, 70), (5000, 333, 8), (1, 1, 1)])
def test_plan_takes_the_least_time_and_fills_where_it_can(n, k, c):
    plan = vq_plan(n, k, c, H100_SMS)
    assert plan.channels % 64 == 0 and c <= plan.channels < c + 64
    assert 1 <= plan.splits <= plan.col_tiles
    best = min(_time_units(plan._replace(splits=s), H100_SMS) for s in range(1, plan.col_tiles + 1))
    assert _time_units(plan, H100_SMS) == best
    assert plan.ctas >= min(H100_SMS, plan.row_blocks * plan.col_tiles)
    covered = [plan.split_codes(s, k) for s in range(plan.splits)]
    assert covered[0][0] == 0 and covered[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(covered, covered[1:]))

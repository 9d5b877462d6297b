"""The tile planner of K11's Hopper GEMM (ops/kernels/mlp_ln.wgmma_plan), on the
CPU: the tile width of csrc/wgmma_gemm.cuh and the persistent grid for an (M, N)
output on a card of some SMs. The kernel itself needs the card
(tests/test_torch_gpu.py)."""

import pytest

from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mlp_ln import (
    WGMMA_ROWS,
    WGMMA_WIDTHS,
    wgmma_plan,
)

H100_SMS = 132


def _cost(m, n, bn, sms):
    tiles = -(-m // WGMMA_ROWS) * -(-n // bn)
    return -(-tiles // sms) * bn, tiles


@pytest.mark.parametrize("m,n,want", [
    (3200, 3072, (128, 132)),  # fc1, dgh at the train loss: 600 tiles, 5 waves
    (3200, 768, (192, 100)),   # fc2, dxn: 100 tiles, one wave (2 waves of 128)
    (100, 3072, (128, 24)),    # ragged rows: one row block
    (100, 96, (128, 1)),
])
def test_plan_at_the_path_shapes(m, n, want):
    assert wgmma_plan(m, n, H100_SMS) == want


@pytest.mark.parametrize("sms", [1, 7, 132])
def test_plan_takes_the_cheapest_width_and_a_grid_within_the_tiles(sms):
    for m in (1, 64, 127, 128, 129, 1000, 3200, 9000):
        for n in (8, 64, 96, 128, 192, 200, 384, 768, 1536, 3072, 4096):
            bn, grid = wgmma_plan(m, n, sms)
            assert bn in WGMMA_WIDTHS
            cost, tiles = _cost(m, n, bn, sms)
            others = [_cost(m, n, w, sms)[0] for w in WGMMA_WIDTHS]
            assert cost == min(others)
            if others.count(cost) > 1:  # a tie goes to the narrower tile
                assert bn == min(w for w, c in zip(WGMMA_WIDTHS, others) if c == cost)
            assert grid == min(tiles, sms) >= 1

"""K4's share of its roofline: the least time of the whole block stack in one launch over a
call's kernel time."""

from perfbench.harness import readers


def read(ctx, outcome):
    return readers.roofline(ctx, outcome, "k4")

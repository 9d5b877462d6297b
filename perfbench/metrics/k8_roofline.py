"""K8's share of its roofline: the least time of one token-mixing backward at the calls'
batch over a call's kernel time."""

from perfbench.harness import readers


def read(ctx, outcome):
    return readers.roofline(ctx, outcome, "k8")

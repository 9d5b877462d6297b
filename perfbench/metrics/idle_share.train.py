"""% of the profiled window with no device activity (torch.profiler's CUDA trace)."""

from perfbench.harness import readers


def read(ctx, outcome):
    return readers.idle_share(ctx, outcome)

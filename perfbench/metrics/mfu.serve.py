"""% of the dense bf16 peak that the model FLOPs (counts/flops.py, one prompt -> image) of
the images completed in the profiled window reach."""

from perfbench.counts import flops
from perfbench.harness import readers


def read(ctx, outcome):
    return readers.mfu(ctx, outcome, flops.image_flops(ctx.cell.config))

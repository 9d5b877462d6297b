"""% of the dense bf16 peak that the model FLOPs (counts/flops.py, one image of the train
step with its cutouts) of the images trained in the profiled window reach."""

from perfbench.counts import flops
from perfbench.harness import readers


def read(ctx, outcome):
    per_image = flops.train_image_flops(ctx.cell.config, ctx.cell.mix["cutn"])
    return readers.mfu(ctx, outcome, per_image)

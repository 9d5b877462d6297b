"""Device ms a step from its call to the step's loss mark: text, mapper, decode, cutouts,
image tower, loss (CUDA events)."""

from perfbench.harness import readers


def read(ctx, outcome):
    return readers.device_ms(ctx, outcome, "train.forward")

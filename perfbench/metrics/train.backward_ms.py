"""Device ms a step from the loss mark to the backward mark (CUDA events)."""

from perfbench.harness import readers


def read(ctx, outcome):
    return readers.device_ms(ctx, outcome, "train.backward")

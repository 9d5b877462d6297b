"""Device ms a step from the backward mark to the adam mark: Adam and the loss EMA (CUDA
events)."""

from perfbench.harness import readers


def read(ctx, outcome):
    return readers.device_ms(ctx, outcome, "train.adam")

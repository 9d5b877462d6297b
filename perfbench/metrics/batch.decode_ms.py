"""Device ms a batch in VQ and the decoder: CUDA events around synth."""

from perfbench.harness import readers


def read(ctx, outcome):
    return readers.device_ms(ctx, outcome, "batch.decode")

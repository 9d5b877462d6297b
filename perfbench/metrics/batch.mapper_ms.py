"""Device ms a batch in the mapper: CUDA events around Generator.render's mapper call."""

from perfbench.harness import readers


def read(ctx, outcome):
    return readers.device_ms(ctx, outcome, "batch.mapper")

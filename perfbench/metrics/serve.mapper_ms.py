"""Device ms a request from the prior mark to the mapper mark (CUDA events)."""

from perfbench.harness import readers


def read(ctx, outcome):
    return readers.device_ms(ctx, outcome, "serve.mapper")

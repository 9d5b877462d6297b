"""Device ms a request from the mapper mark to the decode mark: VQ and the decoder (CUDA
events)."""

from perfbench.harness import readers


def read(ctx, outcome):
    return readers.device_ms(ctx, outcome, "serve.decode")

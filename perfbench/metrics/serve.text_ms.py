"""Ms a request from the call of predict to its text mark: host tokenize, then the text
tower (CUDA events)."""

from perfbench.harness import readers


def read(ctx, outcome):
    return readers.device_ms(ctx, outcome, "serve.text")

"""Device ms a batch in the x-transformer's feed-forward sublayers (LayerNorm, W1, GELU,
W2): the program's `mapper.ff` spans inside each `render` (CUDA events)."""

from perfbench.harness import program_spans


def read(ctx, outcome):
    return program_spans.mean_per_root("render", ("mapper.ff",), "device_ms")

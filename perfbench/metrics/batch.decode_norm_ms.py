"""Device ms a batch in the decoder's GroupNorms with their SiLU: the program's
`decode.norm` spans inside each `render` (CUDA events)."""

from perfbench.harness import program_spans


def read(ctx, outcome):
    return program_spans.mean_per_root("render", ("decode.norm",), "device_ms")

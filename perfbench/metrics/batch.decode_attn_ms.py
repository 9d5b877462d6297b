"""Device ms a batch in the decoder's attention blocks, whole: the program's `decode.attn`
spans inside each `render` (CUDA events)."""

from perfbench.harness import program_spans


def read(ctx, outcome):
    return program_spans.mean_per_root("render", ("decode.attn",), "device_ms")

"""Device ms a batch in the x-transformer's attention sublayers, whole (LayerNorm, q, k, v,
SDPA, to_out): the program's `mapper.attn` spans inside each `render` (CUDA events)."""

from perfbench.harness import program_spans


def read(ctx, outcome):
    return program_spans.mean_per_root("render", ("mapper.attn",), "device_ms")

"""Device ms a batch in the decoder's convolutions (Upsample's weight fold included): the
program's `decode.conv` spans inside each `render` (CUDA events)."""

from perfbench.harness import program_spans


def read(ctx, outcome):
    return program_spans.mean_per_root("render", ("decode.conv",), "device_ms")

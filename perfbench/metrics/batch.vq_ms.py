"""Device ms a batch in the VQ search and gather: the program's `vq` spans inside each
`render` (CUDA events)."""

from perfbench.harness import program_spans


def read(ctx, outcome):
    return program_spans.mean_per_root("render", ("vq",), "device_ms")

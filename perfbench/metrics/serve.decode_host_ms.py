"""Host ms a request enqueuing VQ and the decoder: the program's `decode` span inside each
`request`."""

from perfbench.harness import program_spans


def read(ctx, outcome):
    return program_spans.mean_per_root("request", ("decode",), "host_ms")

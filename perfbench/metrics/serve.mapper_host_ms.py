"""Host ms a request enqueuing the mapper: the program's `mapper` span inside each
`request`."""

from perfbench.harness import program_spans


def read(ctx, outcome):
    return program_spans.mean_per_root("request", ("mapper",), "host_ms")

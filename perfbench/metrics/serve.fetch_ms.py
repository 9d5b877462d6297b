"""Host ms a request waiting for the images to reach the host (`imgs.cpu()`): the program's
`fetch` span inside each `request`."""

from perfbench.harness import program_spans


def read(ctx, outcome):
    return program_spans.mean_per_root("request", ("fetch",), "host_ms")

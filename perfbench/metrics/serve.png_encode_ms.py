"""Host ms a request in the PNG's encode and write (`save_image`): the program's
`png.encode` span inside each `request`. A program without that span has nothing
to read: None."""

from perfbench.harness import program_spans


def read(ctx, outcome):
    return program_spans.mean_per_root("request", ("png.encode",), "host_ms")

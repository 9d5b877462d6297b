"""Host ms a request in the BPE tokenizer: the program's `tokenize` span inside each
`request`."""

from perfbench.harness import program_spans


def read(ctx, outcome):
    return program_spans.mean_per_root("request", ("tokenize",), "host_ms")

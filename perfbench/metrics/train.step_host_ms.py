"""Host ms of a train step: the program's `step` span, the host's cost of a step."""

from perfbench.harness import program_spans


def read(ctx, outcome):
    return program_spans.mean_per_root("step", ("step",), "host_ms")

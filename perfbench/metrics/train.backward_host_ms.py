"""Host ms a train step in `loss.backward()`: the program's `step.backward` span inside
each `step`."""

from perfbench.harness import program_spans


def read(ctx, outcome):
    return program_spans.mean_per_root("step", ("step.backward",), "host_ms")

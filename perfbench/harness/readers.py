"""What the per-layer metric files (metrics/<name>.py) share: each reads one
number from a traced run's spans, the profiler's summary or the counts, and
returns None where the run holds nothing to read it from."""

import statistics

from perfbench.counts import flops as counts


def idle_share(ctx, outcome):
    """% of the profiled window in which no kernel, copy or set ran on the device."""
    s = ctx.prof.summary
    if not s or s["window_s"] <= 0 or s["kernels"] == 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def mfu(ctx, outcome, flops_per_image):
    """% of the dense bf16 peak that the model FLOPs of the images completed in
    the profiled window reach over its seconds."""
    s, w = ctx.prof.summary, outcome.window
    if not s or not w.traced_units or s["window_s"] <= 0:
        return None
    images = w.traced_units * outcome.items_per_unit
    return 100.0 * flops_per_image * images / s["window_s"] / counts.PEAK_FLOPS


def kernel_seconds(ctx, span):
    """Seconds a call of the wrapper `span`: the device trace's kernels launched
    inside it where the trace ties them to it, else its CUDA events."""
    s = ctx.prof.summary
    calls = (s or {}).get("annotated", {}).get(span)
    if calls:
        return statistics.mean(calls)
    ms = ctx.spans.device_ms(span)
    return None if ms is None else ms / 1e3


def roofline(ctx, outcome, span):
    """% of the least time (counts.BOUNDS[span] at the calls' batch) over the
    measured time of a call."""
    shapes = ctx.spans.shapes.get(span)
    t = kernel_seconds(ctx, span)
    if not shapes or not t:
        return None
    b = statistics.mode(shapes)
    return 100.0 * counts.least_seconds(*counts.BOUNDS[span](ctx.cell.config, b)) / t


def device_ms(ctx, outcome, span):
    return ctx.spans.device_ms(span)


def host_ms_per(ctx, outcome, span, per):
    """Host milliseconds of all of `span`'s calls over the number of `per` spans."""
    vals, n = ctx.spans.host.get(span), len(ctx.spans.host.get(per, ()))
    return 1e3 * sum(vals) / n if vals and n else None

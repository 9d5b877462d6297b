"""The x-transformer's causal attention calls' share of their roofline: the least time of
each call (counts/xattn.py, from the `mapper.sdpa` span's batch, tokens, heads and
dim_head) over the device ms of the calls inside the first session's `render` roots (CUDA
events around the call alone). None where the program records no such span."""

from perfbench.counts import xattn
from perfbench.harness import program_spans


def read(ctx, outcome):
    recs = program_spans.first_session(program_spans.records())
    renders = {r.id for r in recs if r.parent is None and r.name == "render"}
    calls = [r for r in recs if r.name == "mapper.sdpa" and r.root in renders
             and r.device_ms is not None]
    if not calls:
        return None
    least = sum(xattn.least_seconds(**r.attrs) for r in calls)
    return 100.0 * least / (1e-3 * sum(r.device_ms for r in calls))

"""What the per-layer metrics of source `program_span` read: the program's own
spans (`feed_forward_vqgan_clip_tpu_torch/tracing.py`), which it records while
a `torch.profiler` session records.

A traced run's window has two profiled phases (trace.Profiled), so the program
records two sessions: the first, the device-only phase at the window's start,
where host tracing does not slow the host, is the one read. A reading sums one
field of the named spans inside each root span of that session and takes the
mean over the roots. A program without the tracing module, or a run in which
it recorded nothing, has nothing to read: None.
"""

import importlib

from perfbench.harness import program


def records() -> list:
    """The program's span records (device milliseconds resolved), or [] where the
    program has no tracing module."""
    try:
        tracing = importlib.import_module(f"{program.PORT}.tracing")
    except ImportError:
        return []
    return tracing.records()


def first_session(recs) -> list:
    """The records of the lowest session among `recs`."""
    if not recs:
        return []
    first = min(r.session for r in recs)
    return [r for r in recs if r.session == first]


def mean_per_root(root: str, names, field: str, recs=None):
    """Mean over the first session's root spans named `root` of the sum of `field`
    ("host_ms" or "device_ms") over the spans named in `names` inside each (the
    root itself counts); None without such a root or without a value to sum."""
    recs = first_session(records() if recs is None else recs)
    sums = {r.id: 0.0 for r in recs if r.parent is None and r.name == root}
    found = False
    for r in recs:
        if r.root in sums and r.name in names:
            value = getattr(r, field)
            if value is not None:
                sums[r.root] += value
                found = True
    return sum(sums.values()) / len(sums) if found else None

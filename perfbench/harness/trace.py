"""Spans, the profiled part of the window, and what the device trace says.

`Spans` records, in a traced run only, named spans from the benchmark's own
wrappers around the program's calls: CUDA events (device time between two
points of the stream), host-clock times, and a `torch.profiler`
`record_function` of the same name, so that the device trace can say what the
host was doing during an idle gap and which kernels a wrapper launched.

`Profiled` runs `torch.profiler` over two parts of the measured window, the
first recording device activity alone, the last the host too, and reduces the
exported traces to the device's busy seconds, the profiled seconds, the device
operations that took most time, the idle gaps by the host span open halfway
through each, and the kernel time launched inside each annotated wrapper.
"""

import collections
import contextlib
import json
import os
import tempfile
import time

import torch

PHASE_SECONDS = 3.0
PREFIX = "perfbench."
WINDOW = PREFIX + "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Named spans of a traced run, recorded while `live` (the measured
    window); every method is a no-op in an untraced run."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled, self.cuda = enabled, cuda
        self.live = False
        self.stats = True  # False: annotate only (the profiled host phase)
        self.dev = collections.defaultdict(list)   # name -> [(start event, end event)]
        self.host = collections.defaultdict(list)  # name -> [seconds]
        self.shapes = collections.defaultdict(list)  # name -> [call's leading dim]
        self._open = {}

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def begin(self, name):
        """Open span `name` (its start event and annotation), closed by end(name)."""
        if not (self.enabled and self.live):
            return
        rf = torch.profiler.record_function(PREFIX + name)
        rf.__enter__()
        stats = self.stats
        self._open[name] = (self._event() if self.cuda and stats else None,
                            time.perf_counter(), rf, stats)

    def end(self, name):
        if not self.enabled or name not in self._open:
            return
        e0, t0, rf, stats = self._open.pop(name)
        if stats:
            if self.cuda:
                self.dev[name].append((e0, self._event()))
            self.host[name].append(time.perf_counter() - t0)
        rf.__exit__(None, None, None)

    @contextlib.contextmanager
    def span(self, name, shape=None):
        if not (self.enabled and self.live):
            yield
            return
        if shape is not None and self.stats:
            self.shapes[name].append(int(shape))
        self.begin(name)
        try:
            yield
        finally:
            self.end(name)

    def wrap(self, name, fn, shape_of=None):
        """fn, called inside span `name`; `shape_of(*args)` records the call's size."""
        if not self.enabled:
            return fn

        def wrapped(*args, **kwargs):
            with self.span(name, shape_of(*args) if shape_of else None):
                return fn(*args, **kwargs)

        return wrapped

    def device_ms(self, name):
        """Mean CUDA-event milliseconds of span `name`, or None without one."""
        pairs = self.dev.get(name)
        if not pairs:
            return None
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)


class Profiled:
    """`torch.profiler` over two phases of the window, PHASE_SECONDS each.
    The first, at the window's start, records device activity alone (CUDA),
    which costs the host almost nothing: the device's busy seconds, the
    phase's seconds (host clock, from a synchronize to a synchronize) and the
    device operations come from it. The second, at the window's end, records
    the host's operations and the benchmark's spans too, which slows a
    host-bound cell down: the idle gaps by host span and the kernels each
    wrapper launched come from it, and the spans' statistics leave it out.
    The window calls `tick()` after each unit of work; `reduce()` reads the
    traces after the window. `summary` stays None in an untraced run."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled and cuda
        self.summary = None
        self.running = False
        self.units = {}  # phase -> units of work finished inside it
        self._done = []  # (phase, exported trace's path, seconds)

    def start(self):
        if self.enabled:
            self._begin("device")

    def _begin(self, phase):
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if phase == "host":
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self._phase, self._n = phase, 0
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._rf = torch.profiler.record_function(WINDOW)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        self.running = True

    def tick(self, remaining: float, done: bool = True) -> bool:
        """After a unit of work (`done`: it completed), with `remaining` seconds
        of the window left:
        end the device phase once it has run PHASE_SECONDS, begin the host
        phase once no more than PHASE_SECONDS remain. -> whether the host
        phase is on (the spans' statistics leave it out)."""
        if self.running:
            self._n += done
            if self._phase == "device" and time.perf_counter() - self._t0 >= PHASE_SECONDS:
                self.stop()
        if (self.enabled and not self.running and "device" in self.units
                and "host" not in self.units and remaining <= PHASE_SECONDS):
            self._begin("host")
        return self.running and self._phase == "host"

    def stop(self):
        """Synchronize, close the phase, stop collecting and export its trace
        (before another profiler session can clear it)."""
        if not self.running:
            return
        torch.cuda.synchronize()
        seconds = time.perf_counter() - self._t0
        self._rf.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        self._prof.export_chrome_trace(path)
        self._prof = None
        self._done.append((self._phase, path, seconds))
        self.units[self._phase] = self._n
        self.running = False

    def reduce(self):
        """The phases' exported traces -> `summary` (parsed, then deleted)."""
        parts = {}
        for phase, path, seconds in self._done:
            try:
                with open(path) as f:
                    parts[phase] = (reduce_trace(json.load(f)["traceEvents"]), seconds)
            finally:
                os.remove(path)
        self._done = []
        if "device" not in parts or parts["device"][0] is None:
            return
        dev, seconds = parts["device"]
        self.summary = dict(dev, window_s=seconds, busy_s=min(dev["busy_s"], seconds),
                            idle_gaps=[], annotated={})
        host = parts.get("host", (None, None))[0]
        if host:
            self.summary.update(idle_gaps=host["idle_gaps"], annotated=host["annotated"])


def _union(intervals):
    """Merged, sorted [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _kernels_by_span(xs, dev):
    """{span name: [device seconds of the kernels each call launched]}: a kernel
    belongs to the innermost perfbench span open on its launching thread when
    its launch call (the runtime or driver event of the same correlation id)
    began."""
    launch = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = (e.get("tid"), float(e["ts"]))
    spans = collections.defaultdict(list)
    for e in xs:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX) \
                and e["name"] != WINDOW:
            ts = float(e["ts"])
            spans[e.get("tid")].append((ts, ts + float(e["dur"]), e["name"][len(PREFIX):]))
    by_tid = collections.defaultdict(list)
    for e in dev:
        src = launch.get(e.get("args", {}).get("correlation"))
        if src is not None:
            by_tid[src[0]].append((src[1], float(e["dur"]) / 1e6))
    calls = collections.defaultdict(collections.Counter)
    for tid, ks in by_tid.items():
        sp = sorted(spans.get(tid, ()))
        active, nxt = [], 0
        for t, dur in sorted(ks):
            while nxt < len(sp) and sp[nxt][0] <= t:
                active.append(sp[nxt])
                nxt += 1
            active = [a for a in active if a[1] > t]
            if active:
                inner = min(active, key=lambda a: a[1] - a[0])
                calls[inner[2]][inner[0]] += dur
    return {name: list(c.values()) for name, c in calls.items()}


def reduce_trace(events):
    """A chrome trace's events -> {busy_s, window_s, device_ops, idle_gaps,
    annotated: {span name: [kernel seconds of each call]}, kernels: count}, over
    the window's annotation where the trace holds the host's events."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    win = [e for e in xs if e.get("name") == WINDOW]
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
    elif dev:  # a trace of device activity alone: the first to the last of it
        w0 = min(float(e["ts"]) for e in dev)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in dev)
    else:
        return None
    ivals = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)) for e in dev]
    busy = _union([(s, e) for s, e in ivals if e > s])
    busy_us = sum(e - s for s, e in busy)
    by_name = collections.Counter()
    for e in dev:
        by_name[e.get("name", "?")] += float(e["dur"]) / 1e6
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in xs if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith(PREFIX) and e["name"] != WINDOW)
    gaps = collections.Counter()
    edges = [w0] + [v for iv in busy for v in iv] + [w1]
    active, nxt = [], 0
    for s, e in zip(edges[0::2], edges[1::2]):  # the gaps, in time order
        if e <= s:
            continue
        mid = (s + e) / 2  # what the host was doing halfway through the gap
        while nxt < len(spans) and spans[nxt][0] <= mid:
            active.append(spans[nxt])
            nxt += 1
        active = [sp for sp in active if sp[1] > mid]
        name = min(active, key=lambda sp: sp[1] - sp[0])[2][len(PREFIX):] if active else "(no span)"
        gaps[name] += (e - s) / 1e6
    annotated = _kernels_by_span(xs, dev)
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_ops": [[n, s] for n, s in by_name.most_common(10)],
        "idle_gaps": [[n, s] for n, s in gaps.most_common(10)],
        "annotated": annotated,
        "kernels": len(dev),
    }

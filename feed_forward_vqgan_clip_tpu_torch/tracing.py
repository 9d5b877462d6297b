"""Spans of the program's own layers, and the registry of the kernels' launch counters.

A span marks one pass through a layer boundary:

    with tracing.span("decode", device=True):
        ...

Spans record while tracing is on: after `enable()` (until `disable()`), or
while any `torch.profiler` session is recording, on any activity (the CUDA
activity alone included). Off, `span()` checks one flag and
`torch._C._autograd._profiler_enabled()`, and returns the shared no-op `OFF`:
nothing is allocated, no annotation is opened, no event is recorded.

On, a span keeps a `Record` in memory: its name, id, the ids of its parent and
of its root (the outermost span open on its thread), the request id where
`request()` set one, the recording session, the host clock at its start and end
(`perf_counter_ns`) and its attributes. The root decides whether a tree is timed
on the device: a root opened with `device=True` while CUDA is in use records a
CUDA event pair on the current stream around itself and around every span
inside it, resolved to device milliseconds when the records are read; under any
other root a span costs the host clock alone (`device` is read on roots only).
So a batch's `render` times its decoder's sublayers on the device, while a
served `request` and a train `step`, whose readings are the host's, put no
event between the host's launches.

A session counts up each time recording turns on: at each `enable()`, and at a
profiler session when a span has found recording off since the recorder last
recorded. Under a profiler the span also opens the annotation that
`record_function("ffvc." + name)` would, with the request id in its args,
through the binding `torch.profiler`'s own step annotation uses, so the
program's spans lie in an exported trace on the kernels' clock. PyTorch tells
no one whether a session records the CPU activity, so the annotation opens in a
CUDA-only session too, where nothing records it.

`records()` returns the records closed so far, oldest first, waiting for the
device to pass each timed span that is still pending; `clear()` empties them.
Records stay in memory until `clear()`: at most CAP, the oldest dropped first
and counted by `dropped()`; a timed span's events are resolved and freed once
PENDING later timed spans have closed.

The spans by layer (README "Tracing" lists them): `request` (with `tokenize`,
`text`, `prior`, `mapper`, `fetch`, and `png` with `png.grid`, `png.encode`) in
`serve/predictor.py`; `render`, `mapper`, `text`, `tokenize` in
`infer.Generator`; `decode` with `vq`,
`decode.norm`, `decode.conv`, `decode.attn` in `models/vqgan.py`; `step` with
`step.<stage>`, `step.backward`, `step.adam` in `train/loop.make_train_step`.

`kernel_counters()` is the one registry of the hand-written kernels' wrappers,
each of which counts its own launches on `.launches`.
"""

import collections
import itertools
import threading
import time

import torch

PREFIX = "ffvc."
CAP = 200_000
PENDING = 4096  # timed spans whose events are kept unresolved

_profiler_enabled = torch._C._autograd._profiler_enabled
# record_function's annotation (a user_annotation), entered and left directly
_annotate = torch.autograd._record_function_with_args_enter
_end_annotation = torch.autograd._record_function_with_args_exit
_cuda_in_use = torch.cuda.is_initialized


class _Off:
    """The span handed out while tracing is off: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


OFF = _Off()


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class Record:
    """One span: open inside its `with`, a record once closed. `host_ms` is its
    host-clock length; `device_ms` the CUDA-event milliseconds between its start
    and end on the stream (None until `records()` resolves it, and for a span
    not timed on the device: `device` says whether it is)."""

    __slots__ = ("name", "id", "parent", "root", "request", "session", "t0_ns", "t1_ns",
                 "device_ms", "attrs", "device", "_rf", "_events")

    def __init__(self, name, device, attrs, profiled):
        self.name, self.device, self.attrs, self._rf = name, device, attrs, profiled
        self.device_ms = None

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6

    def __enter__(self):
        rec, local = _REC, _REC.local
        self.session = rec.current_session()
        self.id = next(rec.ids)
        stack = local.stack
        if stack:  # timed on the device where its root is
            top = stack[-1]
            self.parent, self.root, self.device = top.id, top.root, top.device
        else:
            self.parent, self.root = None, self.id
            self.device = self.device and _cuda_in_use()
        self.request = local.request
        stack.append(self)
        if self._rf:  # under a profiler
            self._rf = (_annotate(PREFIX + self.name) if self.request is None
                        else _annotate(PREFIX + self.name, f"request={self.request}"))
        else:
            self._rf = None
        self._events = _event() if self.device else None
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events = (self._events, _event())
        if self._rf is not None:
            _end_annotation(self._rf)
        stack = _REC.local.stack
        if stack and stack[-1] is self:
            stack.pop()
        _REC.keep(self)
        return None


class _Thread(threading.local):
    def __init__(self):
        self.stack = []  # the recorded spans open on this thread, innermost last
        self.request = None


class Recorder:
    """The process's spans: whether tracing is on, the session, the open spans of
    each thread and the closed records."""

    def __init__(self, cap: int = CAP):
        self.enabled = False
        self.off_seen = True  # a span found recording off since the last one recorded
        self.session = 0
        self.ids = itertools.count(1)
        self.records = collections.deque(maxlen=cap)
        self.dropped = 0
        self.local = _Thread()
        self.pending = collections.deque()  # timed records not yet resolved, oldest first

    def current_session(self) -> int:
        """The session a span opened now belongs to; a profiler session that
        follows a span found off is a new one."""
        if self.off_seen and not self.enabled:
            self.session += 1
        self.off_seen = False
        return self.session

    def keep(self, rec: Record):
        if len(self.records) == self.records.maxlen:
            self.dropped += 1
        self.records.append(rec)
        if rec._events is not None:
            self.pending.append(rec)
            if len(self.pending) > PENDING:
                self.resolve(self.pending.popleft())

    @staticmethod
    def resolve(rec: Record):
        e0, e1 = rec._events
        e1.synchronize()
        rec.device_ms, rec._events = e0.elapsed_time(e1), None


_REC = Recorder()


def span(name: str, device: bool = False, **attrs):
    """A context manager for one pass through the layer `name`: `OFF` while
    tracing is off; on, it records as the module docstring says (`device=True`
    on a root: the tree is timed on the device where CUDA is in use). `attrs`
    are kept with the record."""
    if _REC.enabled:
        return Record(name, device, attrs, _profiler_enabled())
    if _profiler_enabled():
        return Record(name, device, attrs, True)
    if not _REC.off_seen:
        _REC.off_seen = True
    return OFF


class request:
    """`with request(rid):` the spans opened inside carry request id `rid`."""

    __slots__ = ("rid", "prev")

    def __init__(self, rid):
        self.rid = rid

    def __enter__(self):
        local = _REC.local
        self.prev, local.request = local.request, self.rid
        return self

    def __exit__(self, *exc):
        _REC.local.request = self.prev
        return None


def enable():
    """Record from now on, in a new session, with or without a profiler."""
    _REC.session += 1
    _REC.enabled, _REC.off_seen = True, False


def disable():
    """Stop the recording `enable()` started (a running profiler session still records)."""
    _REC.enabled, _REC.off_seen = False, True


def records() -> list:
    """The closed spans' records, oldest first, their device milliseconds resolved
    (waiting for the device where a timed span is pending)."""
    pending = _REC.pending
    while pending:
        _REC.resolve(pending.popleft())
    return list(_REC.records)


def clear():
    """Drop every record and the count of dropped ones."""
    _REC.records.clear()
    _REC.pending.clear()
    _REC.dropped = 0


def dropped() -> int:
    """Records dropped, oldest first, since the last `clear()` because CAP were kept."""
    return _REC.dropped


def kernel_counters():
    """{kernel name: wrapper} of the port's kernels; each wrapper counts its
    launches on `.launches` (none on the CPU, where it runs its plain version)."""
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.group_norm import group_norm_silu
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
        mixer_block,
        mixer_block_fwd_res,
        mixer_block_stacked,
        mixer_channel_bwd,
        mixer_token_bwd,
    )
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_stream import mixer_stream
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mlp_ln import mlp_ln, mlp_ln_bwd
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.residual import residual_add
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.vq_lookup import (
        nearest_codebook_indices_kernel,
    )
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_adjoint import warp_adjoint
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_forward import warp_forward

    return {"vq_argmin": nearest_codebook_indices_kernel, "mixer_block": mixer_block,
            "mixer_stream": mixer_stream, "mixer_block_stacked": mixer_block_stacked,
            "mixer_fwd_res": mixer_block_fwd_res, "mixer_channel_bwd": mixer_channel_bwd,
            "mixer_token_bwd": mixer_token_bwd, "warp_forward": warp_forward,
            "warp_adjoint": warp_adjoint, "mlp_ln": mlp_ln, "mlp_ln_bwd": mlp_ln_bwd,
            "group_norm": group_norm_silu, "residual": residual_add}

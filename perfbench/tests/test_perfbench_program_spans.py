"""The readers of the program's own spans (harness/program_spans.py and the
metrics of source `program_span` that read them): on hand-made records the
first session is read, sums are taken per root and averaged over the roots,
and nothing to read gives None; every such metric has its file and entry; a
tiny cell traced by the program's `tracing.enable()` on the CPU gives each host
metric a value."""

import json
import types

import pytest

import tiny_cell
from perfbench.harness import cell as C
from perfbench.harness import program_spans

MANIFEST = json.loads((C.ROOT / "BENCHMARK.json").read_text())
# metric -> (root span, span summed, field)
READS = {
    "batch.vq_ms": ("render", "vq", "device_ms"),
    "batch.decode_norm_ms": ("render", "decode.norm", "device_ms"),
    "batch.decode_conv_ms": ("render", "decode.conv", "device_ms"),
    "batch.decode_attn_ms": ("render", "decode.attn", "device_ms"),
    "serve.tokenize_ms": ("request", "tokenize", "host_ms"),
    "serve.mapper_host_ms": ("request", "mapper", "host_ms"),
    "serve.decode_host_ms": ("request", "decode", "host_ms"),
    "serve.fetch_ms": ("request", "fetch", "host_ms"),
    "train.step_host_ms": ("step", "step", "host_ms"),
    "train.backward_host_ms": ("step", "step.backward", "host_ms"),
}
CELLS = {"batch": ["mixer-batch256"], "serve": ["mixer-serve-1x1", "vitgan-serve-1x1"],
         "train": ["mixer-train-b8"]}


def rec(id, name, session, parent=None, root=None, host_ms=None, device_ms=None):
    return types.SimpleNamespace(id=id, name=name, session=session, parent=parent,
                                 root=id if root is None else root, host_ms=host_ms,
                                 device_ms=device_ms)


def two_sessions(root, name, field):
    """Session 1: two roots, the first holding the span twice (1 + 2), the second
    once (3), and one span outside any such root; session 2: one root (100).
    Where `name` is the root's, the children take another name."""
    v = lambda x: {field: x}  # noqa: E731
    name = "child" if name == root else name
    return [rec(2, name, 1, parent=1, root=1, **v(1.0)),
            rec(3, name, 1, parent=1, root=1, **v(2.0)), rec(1, root, 1, **v(10.0)),
            rec(5, name, 1, parent=4, root=4, **v(3.0)), rec(4, root, 1, **v(20.0)),
            rec(6, "other", 1), rec(7, name, 1, parent=6, root=6, **v(50.0)),
            rec(9, name, 2, parent=8, root=8, **v(100.0)), rec(8, root, 2, **v(200.0))]


def test_first_session_sums_per_root_and_mean_over_roots():
    recs = two_sessions("request", "fetch", "host_ms")
    assert program_spans.mean_per_root("request", ("fetch",), "host_ms", recs) == 3.0
    # the root itself counts where it is named
    assert program_spans.mean_per_root("request", ("request",), "host_ms", recs) == 15.0
    assert program_spans.mean_per_root("request", ("fetch",), "host_ms", recs[-2:]) == 100.0
    assert [r.session for r in program_spans.first_session(recs[::-1])] == [1] * 7


def test_nothing_to_read_is_none(monkeypatch):
    recs = two_sessions("request", "fetch", "host_ms")
    assert program_spans.mean_per_root("request", ("fetch",), "host_ms", []) is None
    assert program_spans.mean_per_root("render", ("fetch",), "host_ms", recs) is None
    assert program_spans.mean_per_root("request", ("fetch",), "device_ms", recs) is None
    # a program without the tracing module: no records, no value
    monkeypatch.setattr(program_spans.program, "PORT", "no_such_package_here")
    assert program_spans.records() == []
    assert program_spans.mean_per_root("request", ("fetch",), "host_ms") is None


@pytest.mark.parametrize("name", sorted(READS))
def test_every_program_span_metric_has_its_file_and_entry(name, monkeypatch):
    entry, = (m for m in MANIFEST["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["unit"] == "ms"
    assert entry["workloads"] == CELLS[name.split(".")[0]]
    root, span, field = READS[name]
    monkeypatch.setattr(program_spans, "records", lambda: two_sessions(root, span, field))
    reader = C.load_module(C.BENCH / "metrics" / f"{name}.py")
    expected = 15.0 if span == root else 3.0
    assert reader.read(None, None) == expected


@pytest.mark.parametrize("generator,names", [
    ("serve_closed", ["serve.tokenize_ms", "serve.mapper_host_ms", "serve.decode_host_ms",
                      "serve.fetch_ms"]),
    ("train", ["train.step_host_ms", "train.backward_host_ms"]),
])
def test_a_tiny_cell_traced_by_the_program_gives_each_host_metric(generator, names):
    tracing = pytest.importorskip(f"{program_spans.program.PORT}.tracing")
    tracing.clear()
    tracing.enable()
    try:
        ctx, out = tiny_cell.run(generator)
    finally:
        tracing.disable()
    try:
        for name in names:
            value = C.load_module(C.BENCH / "metrics" / f"{name}.py").read(ctx, out)
            assert value is not None and value > 0, name
    finally:
        tracing.clear()

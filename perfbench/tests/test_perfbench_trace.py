"""The device trace's reduction on a hand-made chrome trace, and the spans."""

import torch

from perfbench.harness.trace import Spans, reduce_trace


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_reduce_trace_busy_gaps_and_kernels_by_span():
    ev = [
        _x("user_annotation", "perfbench.window", 0, 100),
        _x("user_annotation", "perfbench.step", 0, 60),
        _x("user_annotation", "perfbench.k2", 10, 5),
        _x("user_annotation", "perfbench.k2", 20, 5),
        _x("user_annotation", "perfbench.png", 70, 20),
        _x("cuda_driver", "cuLaunchKernelEx", 11, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=2),
        _x("cuda_driver", "cuLaunchKernelEx", 21, 1, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 30, 1, correlation=4),
        _x("kernel", "gemm", 15, 10, tid=7, correlation=1),
        _x("kernel", "ln", 25, 5, tid=7, correlation=2),
        _x("kernel", "gemm", 30, 10, tid=7, correlation=3),
        _x("kernel", "other", 40, 20, tid=7, correlation=4),
        _x("gpu_memcpy", "copy", 95, 10, tid=7),
    ]
    s = reduce_trace(ev)
    assert s["window_s"] == 100e-6
    assert abs(s["busy_s"] - 50e-6) < 1e-12  # 15-60 and 95-100
    assert s["device_ops"][0] == ["gemm", 20e-6]
    gaps = dict(s["idle_gaps"])
    assert abs(gaps["step"] - 15e-6) < 1e-12 and abs(gaps["png"] - 35e-6) < 1e-12
    assert [round(v * 1e6, 6) for v in sorted(s["annotated"]["k2"])] == [10, 15]
    assert "step" in s["annotated"] and s["kernels"] == 5


def test_reduce_trace_of_device_activity_alone():
    s = reduce_trace([_x("kernel", "k", 10, 5, tid=7), _x("kernel", "k", 20, 5, tid=7)])
    assert abs(s["busy_s"] - 10e-6) < 1e-12 and abs(s["window_s"] - 15e-6) < 1e-12
    assert reduce_trace([_x("cpu_op", "aten::add", 0, 1)]) is None


def test_spans_record_only_while_live_and_when_enabled():
    sp = Spans(enabled=True, cuda=False)
    with sp.span("a", shape=4):
        pass
    assert not sp.host
    sp.live = True
    f = sp.wrap("b", lambda x: x + 1, shape_of=lambda x: x)
    assert f(2) == 3 and sp.shapes["b"] == [2] and len(sp.host["b"]) == 1
    off = Spans(enabled=False, cuda=False)
    g = lambda x: x  # noqa: E731
    assert off.wrap("c", g) is g
    assert torch.cuda.is_available() or sp.device_ms("b") is None

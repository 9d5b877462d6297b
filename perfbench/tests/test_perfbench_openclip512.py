"""The 512-px OpenCLIP Mixer's configuration and its cells: the configuration
loads with the cells that name it; its model FLOPs and K4's least time are
frozen; `serve.png_encode_ms` reads the program's `png.encode` spans on
hand-made records and nothing where the program has none; a tiny bf16 serve
cell of this shape (an `openclip/...` text tower with exact GELU, one Mixer
block over 32 x 32 latent tokens) through `serve_closed` is correct, and its
FP8 control is not."""

import json
import math
import time
import types

import pytest
import torch

import tiny_cell
from perfbench.counts import flops
from perfbench.harness import cell as C
from perfbench.harness import program_spans
from perfbench.reference import models as R

NAME = "mixer1x1024-openclip-vitb32-f16-512px"
MANIFEST = json.loads((C.ROOT / "BENCHMARK.json").read_text())


def test_the_configuration_loads_with_its_cells():
    serve = C.load_cell("openclip512-serve-1x1", MANIFEST)
    assert serve.config["name"] == NAME and serve.mix["generator"] == "serve_closed"
    assert serve.mix["grid"] == "1x1"
    assert [m["name"] for m in serve.end_to_end] == ["request_p50_ms", "request_p95_ms",
                                                     "setup_s"]
    assert {"serve.png_encode_ms", "k4_roofline", "mfu.serve"} <= {
        m["name"] for m in serve.per_layer}
    assert serve.sample == {"requests": 8, "of_first_requests": 32}
    cfg = serve.config
    m = cfg["mapper"]
    assert (m["dim"], m["depth"], m["vq_image_size"], m["expansion"]) == (1024, 1, 32, 4)
    assert cfg["clip_model"] == "openclip/ViT-B-32/laion2b_e16" and R.clip_act(cfg) == "gelu"
    spec = R.mapper_spec(m, cfg["clip"]["embed_dim"], cfg["vqgan"]["embed_dim"])
    assert sum(math.prod(s) for s, _ in spec.values()) == 151_799_040
    entry, = (c for c in MANIFEST["configs"] if c["name"] == NAME)
    assert entry["source"] == cfg["source"] and entry["reduced"] == cfg["reduced"] == []
    batch = C.load_cell("mixer-batch64", MANIFEST)
    assert batch.config["name"] == "mixer32x1024-vitb32-f16" and batch.mix["batch"] == 64
    assert [m["name"] for m in batch.end_to_end] == ["infer_img_per_s", "setup_s"]
    assert {"k2_roofline", "mfu.batch", "batch.mapper_ms"} <= {m["name"] for m in batch.per_layer}


def test_flop_counts_are_frozen():
    cfg = C.load_cell("openclip512-serve-1x1", MANIFEST).config
    # text 2 x 12 layers at 77 tokens, the Mixer, the search over 1024 latents
    # and the decoder at 512 x 512: 1.0677 TFLOP a prompt -> image
    assert flops.image_flops(cfg) == 1_067_688_878_080
    # K4 over one row: one block, 4 products over 1024 x 4096 at width 1024
    assert flops.mixer_stream(cfg, 1) == (34_359_738_368, 37_806_080)
    # bound by its operations: 0.0347 ms
    assert abs(flops.least_seconds(*flops.mixer_stream(cfg, 1)) - 34.742e-6) < 1e-9


def _rec(id, name, session=1, parent=None, root=None, host_ms=None):
    return types.SimpleNamespace(id=id, name=name, session=session, parent=parent,
                                 root=id if root is None else root, host_ms=host_ms,
                                 device_ms=None, attrs={})


def test_png_encode_reader_on_hand_made_records(monkeypatch):
    entry, = (m for m in MANIFEST["per_layer"] if m["name"] == "serve.png_encode_ms")
    assert (entry["source"], entry["unit"], entry["moves"]) == ("program_span", "ms",
                                                                "request_p50_ms")
    assert entry["workloads"] == ["mixer-serve-1x1", "vitgan-serve-1x1", "openclip512-serve-1x1"]
    reader = C.load_module(C.BENCH / "metrics" / "serve.png_encode_ms.py")
    # two requests in session 1 (encode 30 and 40 ms under png, the grid apart), a
    # third in session 2 that is not read
    recs = [_rec(1, "request", host_ms=100.0), _rec(2, "png", parent=1, root=1, host_ms=35.0),
            _rec(3, "png.grid", parent=2, root=1, host_ms=4.0),
            _rec(4, "png.encode", parent=2, root=1, host_ms=30.0),
            _rec(5, "request", host_ms=90.0), _rec(6, "png", parent=5, root=5, host_ms=45.0),
            _rec(7, "png.encode", parent=6, root=5, host_ms=40.0),
            _rec(8, "request", session=2), _rec(9, "png.encode", 2, parent=8, root=8,
                                                host_ms=500.0)]
    monkeypatch.setattr(program_spans, "records", lambda: recs)
    assert reader.read(None, None) == 35.0
    # the parent's program records `png` alone: nothing to read
    monkeypatch.setattr(program_spans, "records", lambda: [r for r in recs if r.id in (1, 2)])
    assert reader.read(None, None) is None


@pytest.fixture
def one_thread():
    """One intra-op thread while the cell runs: its bf16 CPU products beside
    other test processes' threads otherwise slow a request from ~20 ms to
    seconds, and the window's sampled requests would not complete."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_openclip_cell(control):
    """A tiny configuration of this shape: an `openclip/<arch>/<tag>` text tower
    (exact GELU), one Mixer block over 32 x 32 latent tokens, bf16."""
    cfg = dict(tiny_cell.config(), clip_model="openclip/tiny/laion2b_e16")
    # clip_dim: the port's table of CLIP widths has no such tiny OpenCLIP name
    cfg["mapper"] = dict(cfg["mapper"], depth=1, vq_image_size=32,
                         clip_dim=cfg["clip"]["embed_dim"])
    mix = dict(tiny_cell.MIXES["serve_closed"])
    cell = C.Cell(name="tiny-openclip", chips=1, config=cfg, mix=mix,
                  limits=dict(tiny_cell.LIMITS), sample=dict(tiny_cell.SAMPLE), end_to_end=[],
                  per_layer=[])
    ctx = C.Ctx(cell=cell, seed=2**31 + 11, seconds=3.0, trace=False,
                device=torch.device("cpu"), t_start=time.perf_counter(), control=control)
    module = C.load_module(C.BENCH / "traffic" / "serve_closed.py")
    return ctx, module.run(ctx)


def test_a_tiny_openclip_serve_cell_is_correct_and_its_control_is_not(one_thread):
    ctx, out = _tiny_openclip_cell(control=True)
    assert out.attempted > 0 and out.failed == 0 and ctx.setup_s > 0
    assert ctx.cell.config["compute_dtype"] == "bfloat16"
    ok, checks = C.judge(out.checks, tiny_cell.LIMITS, out.failed)
    assert ok, checks
    assert checks["link_err"]["value"] == 0 and checks["out_err"]["value"] == 0
    ok_ctl, checks_ctl = C.judge(out.control, tiny_cell.LIMITS, 0)
    assert not ok_ctl, checks_ctl


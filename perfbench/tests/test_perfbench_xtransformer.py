"""The x-transformer family's plain reference (reference/mappers/xtransformer.py)
against the port's XTransformer on the CPU at a tiny width, in the three input
modes the port builds; four faults planted in the port each fail the
comparison; the reference's spec is the port's state dict in its order; a tiny
cell of the family is correct and its FP8 control and the mask-off fault are
not (on the card: the mask-off fault in the cell itself); the FLOP count of the
512-px configuration is the frozen one; the causal-attention count and the new
per-layer metrics' readers on hand-made records."""

import importlib
import json
import time
import types

import pytest
import torch
import torch.nn.functional as F
from torch import nn

import tiny_cell
from perfbench.counts import flops, xattn
from perfbench.harness import cell as C
from perfbench.harness import program, program_spans
from perfbench.harness.weights import draw
from perfbench.reference import models as R
from perfbench.reference.precision import EXACT

SEED = 2**31 + 21
CONFIG = "xtransformer256x16-vitb32-f16-512px"
MODES = {"initial_proj": (True, False), "add_input": (False, True), "prepend": (False, False)}
# Both sides compute in float32 from the same weights; they differ in the order of
# their sums alone (the port's fused SDPA against the reference's explicit product,
# masked softmax and product), which reads 2.5-3.0e-7 at these widths: 1e-5 leaves
# thirtyfold room, and the smallest planted fault below (tanh-GELU) reads 1.2e-4.
TOL = 1e-5


def tiny_config(mode):
    initial_proj, add_input = MODES[mode]
    cfg = tiny_cell.config()
    cfg["compute_dtype"] = "float32"
    # dim 32, depth 2, 2 heads of 64 (the port's and x-transformers' dim_head), 4 x 4 tokens
    cfg["mapper"] = {"model_type": "xtransformer", "dim": 32, "depth": 2, "num_heads": 2,
                     "vq_image_size": 4, "noise_dim": 0, "initial_proj": initial_proj,
                     "add_input": add_input, "clip_dim": cfg["clip"]["embed_dim"]}
    return cfg


def port_and_reference(mode):
    """(port module, reference forward, input) on the same seeded weights."""
    cfg = tiny_config(mode)
    m, c, ch = cfg["mapper"], cfg["clip"], cfg["vqgan"]["embed_dim"]
    sd = draw(R.mapper_spec(m, c["embed_dim"], ch), SEED, 3, "cpu")
    port = program.mapper(cfg, sd, torch.device("cpu")).eval()
    x = torch.randn(4, c["embed_dim"], generator=torch.Generator().manual_seed(SEED))
    return port, (lambda P=EXACT: R.mapper(sd, x, m, ch, P)), x


def gap(port, ref, x):
    with torch.no_grad():
        return float(R.rel_l2(port(x), ref()).max())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_the_port_matches_the_reference(mode):
    port, ref, x = port_and_reference(mode)
    assert gap(port, ref, x) <= TOL


@pytest.mark.parametrize("mode", sorted(MODES))
def test_the_spec_is_the_port_state_dict_in_its_order(mode):
    cfg = tiny_config(mode)
    m, c, ch = cfg["mapper"], cfg["clip"], cfg["vqgan"]["embed_dim"]
    spec = R.mapper_spec(m, c["embed_dim"], ch)
    port = program.mapper(cfg, draw(spec, SEED, 3, "cpu"), torch.device("cpu"))
    assert [(k, tuple(t.shape)) for k, t in port.state_dict().items()] == \
        [(k, tuple(s)) for k, (s, _) in spec.items()]


class _Unmasked:
    """torch.nn.functional as the port's x-transformer sees it, its SDPA told
    is_causal=False: every token attends to the future too."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def scaled_dot_product_attention(q, k, v, is_causal=False, **kw):
        return F.scaled_dot_product_attention(q, k, v, **kw)


def _no_mask(port, monkeypatch):
    xt = importlib.import_module(f"{program.PORT}.models.mappers.xtransformer")
    monkeypatch.setattr(xt, "F", _Unmasked())


def _tanh_gelu(port, monkeypatch):
    for layer in port.transformer.attn_layers.layers[1::2]:
        layer[1].net[0][1] = nn.GELU(approximate="tanh")


def _no_positions(port, monkeypatch):
    with torch.no_grad():
        port.transformer.pos_emb.emb.weight.zero_()


def _no_final_norm(port, monkeypatch):
    port.transformer.norm = nn.Identity()


FAULTS = {"no_causal_mask": _no_mask, "tanh_gelu": _tanh_gelu, "no_positions": _no_positions,
          "no_final_norm": _no_final_norm}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_a_planted_fault_fails_the_comparison(mode, fault, monkeypatch):
    port, ref, x = port_and_reference(mode)
    FAULTS[fault](port, monkeypatch)
    assert gap(port, ref, x) > 10 * TOL


@pytest.mark.parametrize("mode", sorted(MODES))
def test_a_tiny_cell_of_the_family_is_correct_and_its_control_is_not(mode, monkeypatch):
    """The batch generator at tiny width in bfloat16 (the cells' path on the CPU), judged
    by tiny_cell's limits; with the mask off the same run fails `mapper_err`."""
    cfg = tiny_config(mode)
    cfg["compute_dtype"] = "bfloat16"
    cell = C.Cell(name="tiny", chips=1, config=cfg, mix=tiny_cell.MIXES["batch"],
                  limits=dict(tiny_cell.LIMITS), sample=dict(tiny_cell.SAMPLE), end_to_end=[],
                  per_layer=[])
    traffic = C.load_module(C.BENCH / "traffic" / "batch.py")

    def run(control):
        ctx = C.Ctx(cell=cell, seed=SEED, seconds=1.0, trace=False, device=torch.device("cpu"),
                    t_start=time.perf_counter(), control=control)
        return traffic.run(ctx)

    out = run(True)
    ok, checks = C.judge(out.checks, cell.limits, out.failed)
    assert ok, checks
    ok_ctl, checks_ctl = C.judge(out.control, cell.limits, 0)
    assert not ok_ctl and checks_ctl["mapper_err"]["value"] > cell.limits["mapper_err"]
    _no_mask(None, monkeypatch)
    ok, checks = C.judge(run(False).checks, cell.limits, 0)
    assert not ok and checks["mapper_err"]["value"] > cell.limits["mapper_err"], checks


@pytest.mark.gpu
def test_the_attention_mask_off_fails_the_cell_on_the_card(monkeypatch):
    """The cell xtransformer-batch64 as the benchmark runs it (3-s window), with the
    program's mapper attending to the future: `mapper_err` reads over its limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = C.load_cell("xtransformer-batch64")
    traffic = C.load_module(C.BENCH / "traffic" / f"{cell.mix['generator']}.py")
    _no_mask(None, monkeypatch)
    ctx = C.Ctx(cell=cell, seed=2**31 + 404, seconds=3.0, trace=False,
                device=torch.device("cuda", 0), t_start=time.perf_counter())
    out = traffic.run(ctx)
    correct, checks = C.judge(out.checks, cell.limits, out.failed)
    print(json.dumps({"fault": "no_causal_mask", "checks": checks}))
    assert not correct and checks["mapper_err"]["value"] > cell.limits["mapper_err"]


def test_flop_count_of_the_512px_configuration_is_the_frozen_one():
    """Per image, counted from the reference on meta tensors (counts/flops.py): text
    tower 5.960 GFLOP; mapper 56.371 (proj 0.268, project_in and project_out 0.134
    each, per block q, k, v 0.604, to_out 0.201, the feed-forward 1.074 and the
    attention's two products 1.611 as the reference computes them, unmasked); the
    codebook search's product 8.590; the decoder at a 32 x 32 latent 1017.437."""
    cfg = json.loads((C.ROOT / f"perfbench/configs/{CONFIG}.json").read_text())
    parts = {"text": 5.960e9, "mapper": 56.371e9, "codebook": 8.590e9, "decoder": 1017.437e9}
    assert abs(sum(parts.values()) / 1088.4e9 - 1) < 1e-3
    assert abs(flops.image_flops(cfg) / 1088.4e9 - 1) < 1e-3
    block = 0.604e9 + 0.201e9 + 1.074e9 + 1.611e9
    assert abs((0.268e9 + 2 * 0.134e9 + 16 * block) / parts["mapper"] - 1) < 1e-3


def test_the_512px_configuration_keeps_its_published_widths():
    cfg = json.loads((C.ROOT / f"perfbench/configs/{CONFIG}.json").read_text())
    m, v = cfg["mapper"], cfg["vqgan"]
    assert (m["dim"], m["depth"], m["num_heads"], m["vq_image_size"] ** 2) == (256, 16, 6, 1024)
    assert (v["resolution"], v["attn_resolutions"], cfg["reduced"]) == (256, [16], [])
    assert 16 * m["vq_image_size"] == 512
    spec = R.mapper_spec(m, cfg["clip"]["embed_dim"], v["embed_dim"])
    params = sum(torch.Size(s).numel() for s, _ in spec.values())
    assert params == 149_595_392  # 570.66 MiB in float32: the zoo file's 571 MB


def test_the_causal_attention_count():
    """At the cell's B=64: 51.5 GFLOP and 201 MB of q, k, v, o in bf16, bound by the
    bytes at 60.1 us (3.35 TB/s) where the operations take 52.1 (989 TFLOP/s)."""
    ops, nbytes = xattn.sdpa(64, 1024, 6, 64)
    assert (ops, nbytes) == (2 * 64 * 6 * 1024 ** 2 * 64, 4 * 2 * 64 * 6 * 1024 * 64)
    assert xattn.sdpa(64, 1024, 6, 64, causal=False)[0] == 2 * ops
    least = xattn.least_seconds(batch=64, tokens=1024, heads=6, dim_head=64, causal=True)
    assert least == pytest.approx(nbytes / flops.PEAK_BYTES) == pytest.approx(60.0975e-6)


def _rec(id, name, session=1, parent=None, root=None, device_ms=None, attrs=None):
    return types.SimpleNamespace(id=id, name=name, session=session, parent=parent,
                                 root=id if root is None else root, device_ms=device_ms,
                                 host_ms=None, attrs=attrs or {})


ATTRS = dict(batch=64, tokens=1024, heads=6, dim_head=64, causal=True)


def _records():
    """Two renders in session 1 (two blocks each), one render in session 2, and a
    `mapper.sdpa` under a root that is no render."""
    out = []
    for root, ms in ((1, 0.1), (10, 0.3)):
        out.append(_rec(root, "render"))
        out.append(_rec(root + 1, "mapper", parent=root, root=root, device_ms=9.0))
        for j in range(2):
            a = root + 2 + 3 * j
            out += [_rec(a, "mapper.attn", parent=root + 1, root=root, device_ms=2.0),
                    _rec(a + 1, "mapper.sdpa", parent=a, root=root, device_ms=ms, attrs=ATTRS),
                    _rec(a + 2, "mapper.ff", parent=root + 1, root=root, device_ms=1.5)]
    out += [_rec(20, "request"), _rec(21, "mapper.sdpa", parent=20, root=20, device_ms=99.0,
                                      attrs=ATTRS),
            _rec(30, "render", session=2), _rec(31, "mapper.sdpa", session=2, parent=30,
                                                root=30, device_ms=99.0, attrs=ATTRS)]
    return out


@pytest.mark.parametrize("name,expected", [
    ("batch.mapper_attn_ms", 4.0), ("batch.mapper_ff_ms", 3.0),
    # four calls of 60.0975 us in 2 x 0.1 + 2 x 0.3 ms
    ("xattn_roofline", 100 * 4 * 60.0975e-6 / 0.8e-3),
])
def test_the_new_readers_on_hand_made_records(name, expected, monkeypatch):
    manifest = json.loads((C.ROOT / "BENCHMARK.json").read_text())
    entry, = (m for m in manifest["per_layer"] if m["name"] == name)
    assert entry["workloads"] == ["xtransformer-batch64"]
    assert entry["moves"] == "infer_img_per_s"
    reader = C.load_module(C.BENCH / "metrics" / f"{name}.py")
    monkeypatch.setattr(program_spans, "records", _records)
    assert reader.read(None, None) == pytest.approx(expected, rel=1e-4)
    # a program that records no such span (the parent's) has nothing to read
    monkeypatch.setattr(program_spans, "records", lambda: [_rec(1, "render")])
    assert reader.read(None, None) is None

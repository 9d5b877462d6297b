"""The port's spans (tracing.py) on the CPU: off they hand out the shared no-op and
record nothing; on (`enable()` or a `torch.profiler` session) a Predictor request,
a Generator batch and a train step record their layers, nested, with a request id;
an x-transformer mapper records its disjoint parts (SDPA inside each attention);
a profiler session is a recording session of its own and its chrome trace holds
the `ffvc.` annotations as the records nest; the cap drops the oldest records;
the root decides whether a tree is timed on the device (a stand-in CUDA event
counts): a render is, a request is not; `bench.LaunchCount` reads the kernels'
counters through `tracing.kernel_counters`.

Tiny models on the CPU, built with the port alone: a Mixer mapper written by
`checkpoint.save_model`, the "tiny" CLIP and an inline VQGAN drawn from seed 0,
the synthetic BPE table of tests/test_torch_serve.py through FFVC_BPE_PATH.
"""

import collections
import gzip
import json
import types

import pytest
import torch

from feed_forward_vqgan_clip_tpu_torch import bench, tracing
from feed_forward_vqgan_clip_tpu_torch.config import make_config
from feed_forward_vqgan_clip_tpu_torch.infer import Generator
from feed_forward_vqgan_clip_tpu_torch.io import checkpoint
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
from feed_forward_vqgan_clip_tpu_torch.ops.cutouts import MakeCutouts
from feed_forward_vqgan_clip_tpu_torch.serve.predictor import STAGES, Predictor
from feed_forward_vqgan_clip_tpu_torch.tokenizer import bpe
from feed_forward_vqgan_clip_tpu_torch.train import loop
from feed_forward_vqgan_clip_tpu_torch.train.state import make_optimizer, make_train_state

TINY_VQ = dict(n_embed=32, embed_dim=8, z_channels=8, ch=8, ch_mult=(1, 2),
               num_res_blocks=1, attn_resolutions=(4,), resolution=8)
CFG = dict(clip_model="tiny", vqgan_arch=TINY_VQ, model_type="mlp_mixer", dim=16, depth=2,
           dropout=0, vq_image_size=4, compute_dtype="float32", noise_dim=0,
           normalize_input=True)
MERGES = ["h e", "l l", "he ll", "o</w> !</w>", "hell o</w>", "w o", "r l", "wo rl",
          "worl d</w>"]
DECODE_PARTS = ("vq", "decode.norm", "decode.conv", "decode.attn")
# the tiny decoder's spans: post_quant_conv, conv_in, 2 mid blocks (2 norm + 2 conv
# each) and their attention, 2 levels of 2 blocks (one with a 1x1 shortcut inside
# its second conv span), the level-4 attentions, one upsample, norm_out, conv_out
TINY_PARTS = {"vq": 1, "decode.norm": 2 * 2 + 2 * 2 * 2 + 1,
              "decode.conv": 1 + 1 + 2 * 2 + 2 * 2 * 2 + 1 + 1, "decode.attn": 1 + 2}


@pytest.fixture(autouse=True)
def fresh_recorder(monkeypatch):
    """Each test starts and ends with tracing off and a recorder of its own."""
    monkeypatch.setattr(tracing, "_REC", tracing.Recorder())
    yield
    tracing.disable()


@pytest.fixture
def bpe_table(tmp_path, monkeypatch):
    path = tmp_path / "merges.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as fd:
        fd.write("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    monkeypatch.setenv("FFVC_BPE_PATH", str(path))
    bpe.get_tokenizer.cache_clear()
    yield
    bpe.get_tokenizer.cache_clear()


def _mapper(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return build_mapper(CFG, vq_channels=TINY_VQ["z_channels"]).init_random_(gen).eval()


@pytest.fixture
def predictor(tmp_path, bpe_table):
    path = checkpoint.save_model(str(tmp_path / "tiny_mixer.th"), _mapper(), CFG)
    pred = Predictor([path], device="cpu")
    pred.setup()
    return pred


def _serve(pred, tmp_path, seed=0):
    """One 1x1 request; -> the stages `mark` saw, in order."""
    seen = []
    pred.predict("hello world", grid_size="1x1", seed=seed, out_path=str(tmp_path / "o.png"),
                 mark=seen.append)
    return seen


def _children(recs):
    out = collections.defaultdict(list)
    for r in recs:
        out[r.parent].append(r)
    return out


def _ancestors(rec, by_id):
    while rec.parent is not None:
        rec = by_id[rec.parent]
        yield rec


def test_off_span_is_the_shared_noop_and_a_request_records_nothing(predictor, tmp_path):
    assert tracing.span("decode") is tracing.OFF
    assert tracing.span("request", device=True, model="m") is tracing.OFF
    with tracing.span("x") as s, tracing.request(7):
        assert s is tracing.OFF
    assert _serve(predictor, tmp_path) == list(STAGES)
    assert tracing.records() == [] and tracing.dropped() == 0


def test_enabled_request_records_its_layers_with_one_request_id(predictor, tmp_path):
    tracing.enable()
    marks = [_serve(predictor, tmp_path, seed=i) for i in range(2)]
    recs = tracing.records()
    assert marks == [list(STAGES)] * 2
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["request", "request"]
    assert roots[0].attrs == {"model": "tiny_mixer.th", "grid": "1x1", "route": "module"}
    assert roots[0].request != roots[1].request
    kids = _children(recs)
    by_id = {r.id: r for r in recs}
    for root in roots:
        inside = [r for r in recs if r.root == root.id]
        assert {r.request for r in inside} == {root.request}
        assert {r.session for r in inside} == {1}
        assert [r.name for r in kids[root.id]] == ["tokenize", "text", "prior", "mapper",
                                                   "decode", "fetch", "png"]
        decode, = (r for r in kids[root.id] if r.name == "decode")
        parts = collections.Counter(r.name for r in inside if decode in _ancestors(r, by_id))
        assert parts == TINY_PARTS
        for r in inside:  # a child lies inside its parent on the host clock
            if r.parent is not None:
                assert by_id[r.parent].t0_ns <= r.t0_ns <= r.t1_ns <= by_id[r.parent].t1_ns
            assert r.device_ms is None  # no CUDA: no events
    assert tracing._REC.local.request is None


def test_decode_parts_are_disjoint(predictor, tmp_path):
    """decode.attn holds no decode.norm or decode.conv; no part holds another."""
    tracing.enable()
    _serve(predictor, tmp_path)
    recs = tracing.records()
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name in DECODE_PARTS:
            assert not [a.name for a in _ancestors(r, by_id) if a.name in DECODE_PARTS], r
            assert not _children(recs)[r.id], r


def test_png_holds_its_grid_and_encode(predictor, tmp_path):
    """Each request's `png` holds one `png.grid` then one `png.encode`, disjoint
    and with no spans inside; the PNG is the same byte for byte with tracing on
    and off."""
    out = tmp_path / "o.png"
    off = []
    for grid in ("1x1", "2x2"):
        predictor.predict("hello world", grid_size=grid, seed=3, out_path=str(out))
        off.append(out.read_bytes())
    tracing.enable()
    on = []
    for grid in ("1x1", "2x2"):
        predictor.predict("hello world", grid_size=grid, seed=3, out_path=str(out))
        on.append(out.read_bytes())
    assert on == off
    recs = tracing.records()
    kids = _children(recs)
    pngs = [r for r in recs if r.name == "png"]
    assert len(pngs) == 2
    for png in pngs:
        grid, encode = kids[png.id]
        assert (grid.name, encode.name) == ("png.grid", "png.encode")
        assert png.t0_ns <= grid.t0_ns <= grid.t1_ns <= encode.t0_ns <= encode.t1_ns <= png.t1_ns
        assert not kids[grid.id] and not kids[encode.id]


def test_generator_render_and_encode_spans(predictor):
    mapper, cfg, _ = next(iter(predictor.models.values()))
    perceptor, = predictor.perceptors.values()
    (vq, _), = predictor.vqgans.values()
    gen = Generator(perceptor, mapper, vq, cfg=cfg)
    tracing.enable()
    gen.render(gen.encode_prompts(["hello world", "world"]))
    recs = tracing.records()
    assert [(r.name, r.parent is None) for r in recs if r.name in
            ("tokenize", "text", "render")] == [("tokenize", True), ("text", True),
                                                ("render", True)]
    render, = (r for r in recs if r.name == "render")
    assert render.attrs == {"batch": 2} and render.request is None
    assert [r.name for r in _children(recs)[render.id]] == ["mapper", "decode"]


MAPPER_PARTS = ("mapper.proj", "mapper.attn", "mapper.ff", "mapper.out")


def _xtransformer_spans(recs, mapper):
    """The x-transformer's spans under `mapper`: {name: [records]}; each part a
    child of `mapper` with no child of its own, but `mapper.sdpa` inside each
    `mapper.attn`."""
    kids = _children(recs)
    parts = collections.defaultdict(list)
    for r in kids[mapper.id]:
        assert r.name in MAPPER_PARTS, r.name
        parts[r.name].append(r)
        inner = kids[r.id]
        if r.name == "mapper.attn":
            assert [k.name for k in inner] == ["mapper.sdpa"] and not kids[inner[0].id]
            parts["mapper.sdpa"].append(inner[0])
        else:
            assert not inner, r.name
    return parts


@pytest.mark.parametrize("initial_proj,add_input", [(True, False), (False, True),
                                                    (False, False)])
def test_xtransformer_render_records_its_disjoint_parts(predictor, initial_proj, add_input):
    """proj, then per block attn (holding sdpa) and ff, then out, in order; the
    images with tracing on equal those with it off, bit for bit."""
    perceptor, = predictor.perceptors.values()
    (vq, _), = predictor.vqgans.values()
    depth, heads = 3, 2
    cfg = dict(CFG, model_type="xtransformer", dim=32, depth=depth, num_heads=heads,
               initial_proj=initial_proj, add_input=add_input)
    mapper = build_mapper(cfg, vq_channels=TINY_VQ["z_channels"])
    gen = Generator(perceptor, mapper.init_random_(torch.Generator().manual_seed(2)), vq, cfg=cfg)
    h = gen.encode_prompts(["hello world", "world", "hello"])
    off = gen.render(h)
    assert tracing.records() == []
    tracing.enable()
    on = gen.render(h)
    recs = tracing.records()
    assert torch.equal(on, off)
    mapper_rec, = (r for r in recs if r.name == "mapper")
    parts = _xtransformer_spans(recs, mapper_rec)
    assert {k: len(v) for k, v in parts.items()} == {
        "mapper.proj": 1, "mapper.attn": depth, "mapper.sdpa": depth, "mapper.ff": depth,
        "mapper.out": 1}
    order = [r.name for r in sorted(_children(recs)[mapper_rec.id], key=lambda r: r.t0_ns)]
    assert order == ["mapper.proj"] + ["mapper.attn", "mapper.ff"] * depth + ["mapper.out"]
    tokens = CFG["vq_image_size"] ** 2 + (0 if initial_proj or add_input else 1)
    assert {tuple(sorted(r.attrs.items())) for r in parts["mapper.sdpa"]} == {tuple(sorted(
        dict(batch=3, tokens=tokens, heads=heads, dim_head=64, causal=True).items()))}


def test_the_512px_xtransformer_makes_50_spans_a_forward():
    """At the released widths (dim 256, depth 16, 6 heads, 32 x 32 tokens), on meta
    tensors: 2 + 16 x 3 spans (proj, out; per block attn, sdpa, ff), each SDPA
    call's attributes the cell's shape."""
    cfg = dict(clip_model="ViT-B/32", model_type="xtransformer", dim=256, depth=16,
               num_heads=6, vq_image_size=32, initial_proj=True, add_input=False)
    mapper = build_mapper(cfg, vq_channels=256, dtype=torch.bfloat16,
                          device=torch.device("meta"))
    tracing.enable()
    with torch.no_grad(), tracing.span("mapper"):
        z = mapper(torch.empty(64, 512, device="meta"))
    recs = tracing.records()
    assert tuple(z.shape) == (64, 32, 32, 256)
    mapper_rec, = (r for r in recs if r.name == "mapper")
    parts = _xtransformer_spans(recs, mapper_rec)
    assert sum(len(v) for v in parts.values()) == 50 and len(parts["mapper.sdpa"]) == 16
    assert parts["mapper.sdpa"][0].attrs == dict(batch=64, tokens=1024, heads=6, dim_head=64,
                                                 causal=True)


def test_a_profiler_session_records_and_the_next_one_is_session_2(predictor, tmp_path):
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=cpu):
        assert tracing.span("request") is not tracing.OFF
        _serve(predictor, tmp_path)
    first = tracing.records()
    assert first and {r.session for r in first} == {1}
    _serve(predictor, tmp_path)  # between the sessions: off, nothing recorded
    assert len(tracing.records()) == len(first)
    with torch.profiler.profile(activities=cpu) as prof:
        _serve(predictor, tmp_path)
    second = tracing.records()[len(first):]
    assert {r.session for r in second} == {2}
    assert [r.name for r in second] == [r.name for r in first]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e["name"].startswith(tracing.PREFIX)]
    got = collections.Counter(e["name"][len(tracing.PREFIX):] for e in events)
    assert got == collections.Counter(r.name for r in second)
    spans = collections.defaultdict(list)
    for e in events:
        spans[e["name"][len(tracing.PREFIX):]].append((e["ts"], e["ts"] + e["dur"]))
    by_id = {r.id: r for r in second}
    for r in second:  # each annotation lies inside one of its recorded parent's
        if r.parent is None:
            continue
        for t0, t1 in spans[r.name]:
            assert any(p0 <= t0 and t1 <= p1 for p0, p1 in spans[by_id[r.parent].name]), r


def test_enable_opens_a_session_each_time_and_request_sets_the_id():
    tracing.enable()
    with tracing.request(41):
        with tracing.span("a", k=1):
            with tracing.span("b"):
                pass
    tracing.disable()
    with tracing.span("off"):
        pass
    tracing.enable()
    with tracing.span("c"):
        pass
    b, a, c = recs = tracing.records()
    assert [r.name for r in recs] == ["b", "a", "c"]  # closed order
    assert (b.parent, b.root, a.parent, a.root) == (a.id, a.id, None, a.id)
    assert (a.request, b.request, c.request) == (41, 41, None)
    assert (a.session, b.session, c.session) == (1, 1, 2)
    assert a.attrs == {"k": 1} and b.host_ms >= 0


def test_the_cap_drops_the_oldest_and_counts(monkeypatch):
    monkeypatch.setattr(tracing, "_REC", tracing.Recorder(cap=3))
    tracing.enable()
    for i in range(5):
        with tracing.span(f"s{i}"):
            pass
    assert [r.name for r in tracing.records()] == ["s2", "s3", "s4"]
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_train_step_records_every_stage_backward_and_adam():
    cfg = make_config(**CFG, batch_size=2, cutn=2)
    frozen = loop.build_frozen(cfg, torch.float32, device="cpu")
    mapper = build_mapper(dict(cfg), vq_channels=TINY_VQ["z_channels"])
    mapper.init_random_(torch.Generator().manual_seed(1))
    state = make_train_state(mapper.parameters(), make_optimizer(1e-3))
    size = frozen.perceptor.size
    step_fn, _ = loop.make_train_step(cfg, mapper, frozen,
                                      MakeCutouts(cut_size=size, cutn=2, pool_size=size),
                                      inp_is_tokens=True, out_is_tokens=True, same_io=True)
    tokens = torch.zeros(2, 77, dtype=torch.long)
    tokens[:, 0], tokens[:, 1], tokens[:, 2] = 49406, 320, 49407
    seen = []
    tracing.enable()
    step_fn(state, {"inp": tokens, "out": tokens}, torch.Generator().manual_seed(0),
            mark=seen.append)
    recs = tracing.records()
    assert seen == list(loop.STAGES)
    step, = (r for r in recs if r.parent is None)
    assert step.name == "step" and step.attrs == {"batch": 2}
    stages = [s for s in loop.STAGES if s not in ("backward", "adam")]
    assert [r.name for r in _children(recs)[step.id]] == (
        [f"step.{s}" for s in stages] + ["step.backward", "step.adam"])
    decode, = (r for r in recs if r.name == "decode")
    assert recs[[r.id for r in recs].index(decode.parent)].name == "step.decode"


def test_launch_count_reads_the_counters_through_the_moved_registry(monkeypatch):
    assert bench.kernel_counters is tracing.kernel_counters
    counters = tracing.kernel_counters()
    assert {"vq_argmin", "mixer_block", "mixer_stream", "mixer_token_bwd",
            "warp_forward", "mlp_ln"} <= set(counters)
    count = bench.LaunchCount()
    assert count.counters.keys() == counters.keys()
    monkeypatch.setattr(counters["mixer_block"], "launches",
                        counters["mixer_block"].launches + 3)
    assert json.loads(count.read()) == {"mixer_block": 3}


def test_launch_count_reads_the_pingpong_gemms_beside_the_launches(monkeypatch):
    """K2's GEMMs that took the ping-pong walk read under "mixer_block_pingpong",
    as `chip_smoke.py` [bench] reads them from `cli bench`'s infer leg."""
    counters = tracing.kernel_counters()
    count = bench.LaunchCount()
    block = counters["mixer_block"]
    monkeypatch.setattr(block, "launches", block.launches + 32)
    monkeypatch.setattr(block, "pingpong_launches", block.pingpong_launches + 64)
    assert json.loads(count.read()) == {"mixer_block": 32, "mixer_block_pingpong": 64}


class _FakeEvent:
    """Stands in for torch.cuda.Event: a clock tick at each record."""

    made = 0
    clock = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None

    def record(self):
        _FakeEvent.clock += 1
        self.t = _FakeEvent.clock

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(tracing, "_cuda_in_use", lambda: True)
    monkeypatch.setattr(tracing.torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "made", 0)


def test_device_timing_follows_the_root(fake_cuda, monkeypatch):
    """A root opened with device=True times itself and every span inside it (their
    own `device` unread); under a root without it, nothing records an event; the
    oldest pending pair resolves once PENDING timed spans wait."""
    monkeypatch.setattr(tracing, "PENDING", 2)
    tracing.enable()
    with tracing.span("a", device=True):
        with tracing.span("b"):
            pass
        with tracing.span("c", device=False):
            pass
    assert _FakeEvent.made == 6
    assert [r.name for r in tracing._REC.pending] == ["c", "a"]  # "b" resolved
    with tracing.span("host"):
        with tracing.span("inner", device=True):
            pass
    assert _FakeEvent.made == 6
    recs = tracing.records()
    assert [r.name for r in recs] == ["b", "c", "a", "inner", "host"]
    assert [r.device_ms for r in recs] == [1.0, 1.0, 5.0, None, None]
    assert [r.device for r in recs] == [True, True, True, False, False]
    assert not tracing._REC.pending


def test_only_a_render_puts_events_between_the_launches(fake_cuda, predictor, tmp_path):
    """A served request and a train step read the host's clock: no CUDA event; a
    batch's render times its tree, the decoder's sublayers included."""
    tracing.enable()
    _serve(predictor, tmp_path)
    assert _FakeEvent.made == 0 and tracing.records()
    tracing.clear()
    mapper, cfg, _ = next(iter(predictor.models.values()))
    perceptor, = predictor.perceptors.values()
    (vq, _), = predictor.vqgans.values()
    gen = Generator(perceptor, mapper, vq, cfg=cfg)
    h = gen.encode_prompts(["hello world"])
    assert _FakeEvent.made == 0
    gen.render(h)
    recs = [r for r in tracing.records() if r.name not in ("tokenize", "text")]
    assert _FakeEvent.made == 2 * len(recs)
    parts = collections.Counter(r.name for r in recs if r.device_ms is not None)
    assert parts == collections.Counter(render=1, mapper=1, decode=1, **TINY_PARTS)

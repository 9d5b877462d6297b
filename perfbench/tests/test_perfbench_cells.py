"""Each traffic generator rehearsed on the CPU at tiny widths: the port against
the plain reference, the control (the reference one precision down) judged
not correct, the faults planted under the timed path judged not correct, and
units of work that raise left out of the rates and tails and judged not
correct. The GPU test runs one short cell through run.py on the card."""

import importlib
import json
import statistics
import subprocess
import sys

import pytest
import torch

import tiny_cell
from perfbench.control import plant
from perfbench.harness import cell as C
from perfbench.harness.capture import Patches

PORT = "feed_forward_vqgan_clip_tpu_torch"
CASES = [("batch", "mlp_mixer"), ("serve_closed", "mlp_mixer"), ("serve_closed", "vitgan"),
         ("train", "mlp_mixer")]
E2E = {"batch": ["infer_img_per_s"], "serve_closed": ["request_p50_ms", "request_p95_ms"],
       "train": ["train_img_per_s"]}


@pytest.mark.parametrize("generator,model", CASES)
def test_port_matches_reference_and_the_control_does_not(generator, model):
    ctx, out = tiny_cell.run(generator, model, control=True)
    assert out.attempted > 0 and out.failed == 0 and ctx.setup_s > 0
    assert sorted(out.metrics) == sorted(E2E[generator]) and all(v > 0 for v in out.metrics.values())
    ok, checks = C.judge(out.checks, tiny_cell.LIMITS, out.failed)
    assert ok, checks
    assert checks["link_err"]["value"] == 0 and checks["vq_gap"]["value"] <= 0
    ok_ctl, checks_ctl = C.judge(out.control, tiny_cell.LIMITS, 0)
    assert not ok_ctl, checks_ctl


def _half_rows(monkeypatch):
    mixer = importlib.import_module(f"{PORT}.models.mappers.mixer")
    orig = mixer.Mixer.forward

    def half(self, x, generator=None):  # the second half of the batch left out
        z = orig(self, x[: (len(x) + 1) // 2], generator)
        return torch.cat([z, z])[: len(x)]

    monkeypatch.setattr(mixer.Mixer, "forward", half)


def _altered_png(monkeypatch):
    pred = importlib.import_module(f"{PORT}.serve.predictor")
    orig = pred.save_image

    def altered(img, path):
        img = img.copy()
        img[5, 5, 0] = 1.0 - img[5, 5, 0]
        orig(img, path)

    monkeypatch.setattr(pred, "save_image", altered)


def _altered_token(monkeypatch):
    bpe = importlib.import_module(f"{PORT}.tokenizer.bpe")
    orig = bpe.ClipTokenizer.tokenize

    def altered(self, texts, *a, **k):
        out = orig(self, texts, *a, **k)
        out[:, 1] += 1
        return out

    monkeypatch.setattr(bpe.ClipTokenizer, "tokenize", altered)


def _planted(name):
    def apply(monkeypatch):
        patches = Patches()
        plant(name, patches, tiny_cell.MIXES["train"]["batch"])
        return patches
    return apply


FAULTS = [("batch", "half_rows", _half_rows), ("batch", "answer", _planted("answer")),
          ("serve_closed", "answer", _planted("answer")), ("serve_closed", "png", _altered_png),
          ("serve_closed", "token", _altered_token), ("train", "unchanged", _planted("unchanged")),
          ("train", "half_batch", _planted("half_batch")), ("train", "answer", _planted("answer"))]


@pytest.mark.parametrize("generator,name,fault", FAULTS, ids=[f"{d}-{n}" for d, n, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(generator, name, fault, monkeypatch):
    patches = fault(monkeypatch)
    try:
        ctx, out = tiny_cell.run(generator)
    finally:
        if patches is not None:
            patches.undo()
    ok, checks = C.judge(out.checks, tiny_cell.LIMITS, out.failed)
    assert not ok, checks


def _handoff(monkeypatch):  # the mapper's output scaled on its way to the search
    for name in ("infer", "serve.predictor", "train.loop"):
        mod = importlib.import_module(f"{PORT}.{name}")
        orig = mod.clamp_with_grad
        monkeypatch.setattr(mod, "clamp_with_grad",
                            lambda x, lo, hi, orig=orig: orig(x * 0.999, lo, hi))


@pytest.mark.parametrize("generator", ["batch", "serve_closed", "train"])
def test_a_broken_handoff_between_stages_is_not_correct(generator, monkeypatch):
    _handoff(monkeypatch)
    ctx, out = tiny_cell.run(generator)
    ok, checks = C.judge(out.checks, tiny_cell.LIMITS, out.failed)
    assert not ok and checks["link_err"]["value"] > 0, checks


# where a unit of work raises, after the warm-up and the sampled units: the
# function patched, the calls it lets through first, and a window that holds
# a few units more
RAISERS = {"batch": ("infer", "synth", 4, 10.0),
           "serve_closed": ("serve.predictor", "save_image", 7, 10.0),
           "train": ("train.loop", "synth", 3, 2.0)}


@pytest.mark.parametrize("generator", sorted(RAISERS))
def test_units_that_raise_are_not_done_and_not_correct(generator, monkeypatch):
    mod_name, attr, let_through, seconds = RAISERS[generator]
    mod = importlib.import_module(f"{PORT}.{mod_name}")
    orig, calls = getattr(mod, attr), [0]

    def every_other(*args, **kwargs):
        calls[0] += 1
        if calls[0] > let_through and (calls[0] - let_through) % 2:
            raise RuntimeError("planted")
        return orig(*args, **kwargs)

    monkeypatch.setattr(mod, attr, every_other)
    ctx, out = tiny_cell.run(generator, seconds=seconds)
    win = out.window
    assert out.failed == win.failed > 0 and out.attempted == win.n
    assert len(win.lat) == win.done == win.n - win.failed > 0
    if generator == "serve_closed":
        assert out.metrics["request_p50_ms"] == statistics.median(1e3 * t for t in win.lat)
    else:
        rate = E2E[generator][0]
        assert out.metrics[rate] == win.done * out.items_per_unit / win.seconds
    ok, checks = C.judge(out.checks, tiny_cell.LIMITS, out.failed)
    assert not ok and checks["failed"] == {"value": out.failed, "limit": 0}
    assert list(checks)[-1] == "failed"


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "mixer-serve-1x1",
                          "--seed", "3000000011", "--seconds", "3", "--trace", "0"],
                         cwd=C.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"

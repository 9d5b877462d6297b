"""Closed-loop serving through the port's `serve.predictor.Predictor`: one
client sends a prompt, waits for the PNG, sends the next.

Mix parameters: `grid` (the request's grid, e.g. "1x1"), `requests` (the
length of the prompt sequence drawn before the window; the window takes it in
order), `corpora` (files under traffic/prompts/, one prompt a line; the
prompts are drawn uniformly from their union by the seed), `merge_table_seed`
(the synthetic BPE merge table, the same for every run: the released table is
not in the repository).

Set-up draws the weights on the device from the seed, writes them under TMPDIR
as the files a deployment loads (the mapper through the port's
`io.checkpoint.save_state_dict`, a reference `.th`; the CLIP text tower and the
VQGAN as state dicts its config names), calls `Predictor([path]).setup()`, and
serves a few requests. Each request is timed on the host clock from the call
of `predict` to its return, the PNG written (one path, overwritten); the
tails are those of the requests completed. The cell's `sample` says how many
requests (`requests` of the first `of_first_requests`, drawn from the seed)
the comparison takes.
"""

import gzip
import importlib
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from perfbench.harness import program
from perfbench.harness.capture import Capture, Patches
from perfbench.harness.cell import Outcome, median, percentile
from perfbench.reference import compare
from perfbench.reference.text import Tokenizer
from perfbench.traffic.batch import weights

PROMPTS = Path(__file__).resolve().parent / "prompts"
WARMUP = 3
PORT = program.PORT


def load_prompts(names):
    out = []
    for n in names:
        with open(PROMPTS / f"{n}.txt", encoding="utf-8") as f:
            out += [line.strip() for line in f if line.strip()]
    return out


def letter_merges(seed, trigrams=2000):
    """A synthetic merge table: the 26 x 26 letter bigrams, the same at a
    word's end, and `trigrams` merges of a bigram and a letter (each also at a
    word's end), in a seeded order; a word takes several merges, as under the
    released table."""
    rng = np.random.default_rng(seed)
    letters = "abcdefghijklmnopqrstuvwxyz"
    pairs = [a + b for a in letters for b in letters]
    merges = [f"{p[0]} {p[1]}" for p in rng.permutation(pairs)]
    merges += [f"{p[0]} {p[1]}</w>" for p in rng.permutation(pairs)]
    for t in rng.choice(len(pairs) * 26, size=trigrams, replace=False):
        ab, c = pairs[t // 26], letters[t % 26]
        merges += [f"{ab} {c}", f"{ab} {c}</w>"]
    return merges


def write_files(cfg, sds, folder):
    """The deployment's files from the benchmark's weights -> the mapper's path."""
    from feed_forward_vqgan_clip_tpu_torch.io.checkpoint import save_state_dict

    clip_path = os.path.join(folder, "clip_text.pt")
    vq_path = os.path.join(folder, "vqgan.pt")
    torch.save({k: v.cpu() for k, v in sds["clip"].items()}, clip_path)
    torch.save({k: v.cpu() for k, v in sds["vqgan"].items()}, vq_path)
    config = dict(program.mapper_config(cfg), clip_model_path=clip_path,
                  vqgan_checkpoint=vq_path, vqgan_arch=dict(cfg["vqgan"]))
    return save_state_dict(os.path.join(folder, "mapper.th"), sds["mapper"], config)


def run(ctx):
    cfg, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    folder = tempfile.mkdtemp(prefix="perfbench-")
    patches = Patches()
    try:
        return _run(ctx, cfg, mix, dev, folder, patches)
    finally:
        patches.undo()
        shutil.rmtree(folder, ignore_errors=True)


def _run(ctx, cfg, mix, dev, folder, patches):
    program.load_kernels(dev)
    merges = os.path.join(folder, "merges.txt.gz")
    with gzip.open(merges, "wt", encoding="utf-8") as f:
        f.write("#version: perfbench\n" + "\n".join(letter_merges(mix["merge_table_seed"])) + "\n")
    bpe = importlib.import_module(f"{PORT}.tokenizer.bpe")
    old_bpe = os.environ.get("FFVC_BPE_PATH")
    os.environ["FFVC_BPE_PATH"] = merges
    bpe.get_tokenizer.cache_clear()
    try:
        return _serve(ctx, cfg, mix, dev, folder, patches, merges, bpe)
    finally:
        if old_bpe is None:
            os.environ.pop("FFVC_BPE_PATH", None)
        else:
            os.environ["FFVC_BPE_PATH"] = old_bpe
        bpe.get_tokenizer.cache_clear()


def _serve(ctx, cfg, mix, dev, folder, patches, merges, bpe):
    from feed_forward_vqgan_clip_tpu_torch.serve.predictor import Predictor

    pred_mod = importlib.import_module(f"{PORT}.serve.predictor")
    vq_mod = importlib.import_module(f"{PORT}.models.vqgan")
    fused_mod = importlib.import_module(f"{PORT}.models.mappers.fused")
    sds = weights(cfg, ctx.seed, dev)
    path = write_files(cfg, sds, folder)
    del sds
    pred = Predictor([path], device=dev)
    pred.setup()
    name = os.path.basename(path)
    rng = np.random.default_rng(ctx.seed)
    prompts = load_prompts(mix["corpora"])
    order = rng.integers(0, len(prompts), size=mix["requests"])
    sample = ctx.cell.sample
    sampled = set(int(i) for i in rng.choice(sample["of_first_requests"], sample["requests"],
                                                replace=False))
    png = os.path.join(folder, "request.png")

    cap, spans = Capture(), ctx.spans
    mapper, mcfg, _ = pred.models[name]
    perceptor = pred.perceptors[(mcfg.get("clip_model"), mcfg.get("clip_model_path"))]
    vq, _ = pred.vqgans[pred_mod._vqgan_key(mcfg)]
    patches.wrap(perceptor.module, "encode_text", lambda f: cap.wrap(None, "h", f))

    def streamed(f):
        def g(m, sp, x):
            cap.take("map_in", x)
            z = f(m, sp, x)
            cap.take("z", z)
            return z
        return g

    patches.wrap(pred_mod, "streamed_mixer_forward", streamed)
    patches.item(pred._mapper_apply, name, lambda f: cap.wrap("map_in", "z", f))
    patches.wrap(vq_mod, "vector_quantize", lambda f: cap.wrap("vq_in", "zq", f))
    patches.wrap(vq, "decode_latent", lambda f: cap.wrap("dec_in", "x", f))
    if ctx.trace:
        tok = bpe.get_tokenizer()
        patches.wrap(tok, "tokenize", lambda f: spans.wrap("serve.tokenize", f))
        patches.wrap(pred_mod, "make_grid", lambda f: spans.wrap("serve.png", f))
        patches.wrap(pred_mod, "save_image", lambda f: spans.wrap("serve.png", f))
        patches.wrap(fused_mod, "mixer_stream", lambda f: spans.wrap(
            "k4", f, shape_of=lambda h, sp: h.shape[0]))
    stages = {"text": ("serve.text", "serve.prior"), "prior": ("serve.prior", "serve.mapper"),
              "mapper": ("serve.mapper", "serve.decode"), "decode": ("serve.decode", None)}

    def mark(stage):
        done, nxt = stages[stage]
        spans.end(done)
        if nxt:
            spans.begin(nxt)

    def request(i, prompt):
        with spans.span("serve.request"):
            spans.begin("serve.text")
            pred.predict(prompt, model=name, grid_size=mix["grid"], seed=i, out_path=png,
                         mark=mark if ctx.trace else None)

    for i in range(WARMUP):
        request(i, prompts[order[-1 - i]])
    ctx.end_setup()

    tokens, pngs = [], []

    def step(i):
        cap.on = i in sampled
        request(i, prompts[order[i % len(order)]])
        if cap.on:
            tokens.append(prompts[order[i % len(order)]])
            with open(png, "rb") as f:
                pngs.append(f.read())
        cap.on = False

    win = ctx.window(step)
    ctx.read_peak()
    patches.undo()
    captured = cap.cat()
    del pred, mapper, perceptor, vq, cap
    torch.cuda.empty_cache()
    checks, ctl = {}, {}
    if pngs:
        ref_tok = Tokenizer(merges)
        captured["tokens"] = torch.from_numpy(np.stack([ref_tok(p) for p in tokens])).to(dev)
        captured["png"] = pngs
        checks, ctl = compare.readings(cfg, weights(cfg, ctx.seed, dev), captured,
                                       control=ctx.control)
    lat_ms = [1e3 * t for t in win.lat]
    return Outcome(metrics={"request_p50_ms": median(lat_ms),
                            "request_p95_ms": percentile(lat_ms, 95)},
                   checks=checks, attempted=win.n, failed=win.failed, window=win,
                   items_per_unit=_grid_images(mix["grid"]), control=ctl)


def _grid_images(grid):
    gh, gw = (int(v) for v in grid.split("x"))
    return gh * gw

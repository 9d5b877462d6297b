"""Batch prompt -> image: `entry.entry`'s path, `Generator.render(
Generator.encode_tokens(tokens))`, at the mix's batch, the batches back to back.

Mix parameters: `batch` (rows a call), `pool` (token batches drawn before the
window and taken in turn), `token_ids` ([low, high) of the drawn id, placed as
`cli bench` places it: [SOT, id, EOT, 0, ...]).

Set-up draws the weights on the device from the seed (drawn again, the same,
for the reference once the window has closed and the program is freed), builds
the port's Generator over them and runs two batches (the first loads the kernels and
casts the blocks' weights). The window reports images completed over its
seconds. The cell's `sample` (workloads/<cell>.json) says how many of the first
batches (`batches` of `of_first_batches`) and rows a batch (`rows`) the
comparison takes; both are drawn from the seed.
"""

import importlib

import numpy as np
import torch

from perfbench.harness import program
from perfbench.harness.capture import Capture, Patches
from perfbench.harness.cell import Outcome
from perfbench.harness.weights import draw
from perfbench.reference import compare
from perfbench.reference import models as R

SOT, EOT = 49406, 49407
WARMUP = 2
PORT = program.PORT


def weights(cfg, seed, device):
    v, m, c = cfg["vqgan"], cfg["mapper"], cfg["clip"]
    return {"clip": draw(R.clip_text_spec(c), seed, 1, device),
            "vqgan": draw(R.vqgan_spec(v), seed, 2, device),
            "mapper": draw(R.mapper_spec(m, c["embed_dim"], v["embed_dim"]), seed, 3, device)}


def token_pool(mix, seed, device):
    rng = np.random.default_rng(seed)
    t = np.zeros((mix["pool"], mix["batch"], 77), np.int64)
    t[:, :, 0], t[:, :, 2] = SOT, EOT
    t[:, :, 1] = rng.integers(*mix["token_ids"], size=(mix["pool"], mix["batch"]))
    return torch.from_numpy(t).to(device), rng


def run(ctx):
    cfg, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    b = mix["batch"]
    program.load_kernels(dev)
    sds = weights(cfg, ctx.seed, dev)
    gen = program.generator(cfg, sds["clip"], sds["vqgan"], sds["mapper"], dev)
    del sds  # drawn again for the reference, after the window
    pool, rng = token_pool(mix, ctx.seed, dev)
    sample = ctx.cell.sample
    batches = rng.choice(sample["of_first_batches"], sample["batches"], replace=False)
    rows = {int(i): torch.from_numpy(np.sort(rng.choice(b, sample["rows"], replace=False))).to(dev)
            for i in batches}

    cap, patches, spans = Capture(), Patches(), ctx.spans
    vq_mod = importlib.import_module(f"{PORT}.models.vqgan")
    infer_mod = importlib.import_module(f"{PORT}.infer")
    fused_mod = importlib.import_module(f"{PORT}.models.mappers.fused")
    patches.wrap(gen.perceptor.module, "encode_text", lambda f: cap.wrap(None, "h", f))
    patches.wrap(gen, "_mapper_apply", lambda f: spans.wrap(
        "batch.mapper", cap.wrap("map_in", "z", f)))
    patches.wrap(vq_mod, "vector_quantize", lambda f: cap.wrap("vq_in", "zq", f))
    patches.wrap(gen.vq, "decode_latent", lambda f: cap.wrap("dec_in", "x", f))
    patches.wrap(infer_mod, "synth", lambda f: spans.wrap("batch.decode", f))
    patches.wrap(fused_mod, "mixer_block", lambda f: spans.wrap(
        "k2", f, shape_of=lambda h, w: h.shape[0]))
    try:
        for i in range(WARMUP):
            gen.render(gen.encode_tokens(pool[i % len(pool)]))
        ctx.end_setup()

        def step(i):
            cap.on, cap.rows = i in rows, rows.get(i)
            with spans.span("batch.step"):
                out = gen.render(gen.encode_tokens(pool[i % len(pool)]))
            cap.take("out", out)
            if cap.on:
                cap.data["tokens"].append(pool[i % len(pool)][cap.rows].clone())
            cap.on = False

        win = ctx.window(step)
        ctx.read_peak()
    finally:
        patches.undo()
    captured = cap.cat()
    del gen, pool, cap
    torch.cuda.empty_cache()
    checks, ctl = {}, {}
    if "out" in captured:
        checks, ctl = compare.readings(cfg, weights(cfg, ctx.seed, dev), captured,
                                       control=ctx.control)
    return Outcome(metrics={"infer_img_per_s": win.done * b / win.seconds}, checks=checks,
                   attempted=win.n, failed=win.failed, window=win, items_per_unit=b,
                   control=ctl)

"""The mapper's train step, `entry.train_entry`'s: `train.loop.make_train_step`
over the port's mapper, its frozen CLIP (both towers) and VQGAN, `MakeCutouts`
and `train.state`'s Adam, the steps back to back.

Mix parameters: `batch`, `cutn`, `lr`, `opt_dtype` (Adam's moments),
`token_ids` and `pool` as in batch.py (every row of every batch differs).

Set-up draws the weights on the device from the seed, builds that step and
drives it through its first three steps from the seed (each step's cutouts
draw from a torch.Generator seeded from (seed, step)); they warm it up and are
what the comparison reads: each step's images, the first step's gradient as
Adam's first moment holds it after one step, and each parameter's change over
the three (the loss is not compared: one precision down reads it only about
twice as far off as sound runs do). The window goes on with the same object
and reports images trained over its seconds. The reference (reference/train.py) follows the first three
steps from the same weights, tokens and generators once the program is freed,
through the codebook rows the program's search chose in each (a bfloat16
latent picks other rows than a float32 one at near ties, and a row apart
decodes to other pixels); the search itself is checked apart, as `vq_gap`
(reference/compare.py), on the latents of those steps. The stages that the
reference's step does not take from the program are judged from the
program's own input as in the batch cell: the text tower in each step, the
mapper's forward in the first (the weights both start from), and, exactly,
what each stage hands on (`link_err`).
"""

import importlib
import statistics

import numpy as np
import torch

from perfbench.harness import program
from perfbench.harness.capture import Capture, Patches
from perfbench.harness.cell import Outcome
from perfbench.harness.weights import draw, mix as mix_seed
from perfbench.reference import compare
from perfbench.reference import models as R
from perfbench.reference import train as T
from perfbench.reference.precision import EXACT, FP8

SOT, EOT = 49406, 49407
CHECKED_STEPS = 3
PORT = program.PORT


def weights(cfg, seed, device):
    v, m, c = cfg["vqgan"], cfg["mapper"], cfg["clip"]
    clip = {**R.clip_text_spec(c), **T.clip_image_spec(c)}
    return {"clip": draw(clip, seed, 11, device), "vqgan": draw(R.vqgan_spec(v), seed, 2, device),
            "mapper": draw(R.mapper_spec(m, c["embed_dim"], v["embed_dim"]), seed, 3, device)}


def batches(mix, seed, device):
    rng = np.random.default_rng(mix_seed(seed, 12))
    t = np.zeros((mix["pool"], mix["batch"], 77), np.int64)
    t[:, :, 0], t[:, :, 2] = SOT, EOT
    t[:, :, 1] = rng.integers(*mix["token_ids"], size=(mix["pool"], mix["batch"]))
    return torch.from_numpy(t).to(device)


def step_generator(seed, step, device):
    return torch.Generator(device=device).manual_seed(mix_seed(seed, 1000 + step))


def build(cfg, mix, sds, device):
    """(step_fn, state, names, frozen): the port's train step over the benchmark's
    weights."""
    from feed_forward_vqgan_clip_tpu_torch.config import make_config
    from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip_from_config
    from feed_forward_vqgan_clip_tpu_torch.models.perceptor import Perceptor
    from feed_forward_vqgan_clip_tpu_torch.ops.cutouts import MakeCutouts
    from feed_forward_vqgan_clip_tpu_torch.train.loop import FrozenModels, make_train_step
    from feed_forward_vqgan_clip_tpu_torch.train.state import make_optimizer, make_train_state

    dtype = program.DTYPES[cfg["compute_dtype"]]
    c = cfg["clip"]
    clip = make_clip_from_config(c, act=program.clip_act(cfg), dtype=dtype, device=device,
                                 image=True)
    clip.load_state_dict(sds["clip"])
    clip.eval().requires_grad_(False)
    perceptor = Perceptor(module=clip, name=cfg["clip_model"], size=c["image_size"],
                          dim=c["embed_dim"])
    frozen = FrozenModels(perceptor, program.vqgan(cfg, sds["vqgan"], device))
    mapper = program.mapper(cfg, sds["mapper"], device)
    pcfg = make_config(**program.mapper_config(cfg), batch_size=mix["batch"], cutn=mix["cutn"],
                       vqgan_arch=dict(cfg["vqgan"]))
    state = make_train_state(mapper.parameters(),
                             make_optimizer(mix["lr"], opt_dtype=mix["opt_dtype"]))
    cutouts = MakeCutouts(cut_size=c["image_size"], cutn=mix["cutn"], pool_size=c["image_size"])
    step_fn, _ = make_train_step(pcfg, mapper, frozen, cutouts, inp_is_tokens=True,
                                 out_is_tokens=True, same_io=True)
    names = [n for n, p in mapper.named_parameters() if p.requires_grad]
    return step_fn, state, names, frozen


def leaf_gaps(got: dict, ref: dict, keep=None) -> list:
    """|norm(got) - norm(ref)| / max(norm(ref), median leaf norm of ref) of each
    leaf `keep` allows (the numbers compared take the largest)."""
    norms = {k: float(v.norm()) for k, v in ref.items()}
    med = statistics.median(norms.values())
    return [abs(float(got[k].float().norm()) - norms[k]) / max(norms[k], med)
            for k in ref if keep is None or keep(k)]


def run(ctx):
    cfg, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    program.load_kernels(dev)
    spans, cap, patches = ctx.spans, Capture(), Patches()
    vq_mod = importlib.import_module(f"{PORT}.models.vqgan")
    loop_mod = importlib.import_module(f"{PORT}.train.loop")
    # the step takes its mapper's apply when it is made
    patches.wrap(loop_mod, "make_mapper_train_apply",
                 lambda make: lambda m: cap.wrap("map_in", "z", make(m)))
    try:
        sds = weights(cfg, ctx.seed, dev)
        step_fn, state, names, frozen = build(cfg, mix, sds, dev)
        del sds
    except BaseException:
        patches.undo()
        raise
    pool = batches(mix, ctx.seed, dev)
    patches.wrap(frozen.perceptor.module, "encode_text", lambda f: cap.wrap(None, "h", f))
    patches.wrap(vq_mod, "vector_quantize", lambda f: cap.wrap("vq_in", "zq", f))
    patches.wrap(frozen.vq, "decode_latent", lambda f: cap.wrap("dec_in", None, f))
    patches.wrap(loop_mod, "synth", lambda f: cap.wrap(None, "img", f))
    kern = importlib.import_module(f"{PORT}.ops.kernels.mixer_block")
    patches.wrap(kern, "mixer_token_bwd", lambda f: spans.wrap(
        "k8", f, shape_of=lambda *a, **k: a[0].shape[0]))
    stage = {"loss": ("train.forward", "train.backward"),
             "backward": ("train.backward", "train.adam"), "adam": ("train.adam", None)}

    def mark(name):
        if name in stage:
            done, nxt = stage[name]
            spans.end(done)
            if nxt:
                spans.begin(nxt)

    def one(i):
        batch = pool[i % len(pool)]
        with spans.span("train.step"):
            spans.begin("train.forward")
            return step_fn(state, {"inp": batch, "out": batch}, step_generator(ctx.seed, i, dev),
                           mark=mark if ctx.trace else None)

    try:
        # the first steps: the comparison's readings, and the warm-up
        p0 = [p.detach().clone() for p in state.params]
        cap.on = True
        for i in range(CHECKED_STEPS):
            one(i)
            if i == 0:
                grad1 = {n: m.float() / (1 - T.B1) for n, m in zip(names, state.opt_state.mu)}
        cap.on = False
        change = {n: p.detach() - q for n, p, q in zip(names, state.params, p0)}
        del p0
        ctx.end_setup()
        win = ctx.window(lambda i: one(CHECKED_STEPS + i))
        ctx.read_peak()
    finally:
        patches.undo()
    del step_fn, state, frozen
    torch.cuda.empty_cache()
    checks, ctl = readings(ctx, cfg, mix, pool, grad1, change, cap.cat())
    return Outcome(metrics={"train_img_per_s": win.done * mix["batch"] / win.seconds},
                   checks=checks, attempted=win.n, failed=win.failed, window=win,
                   items_per_unit=mix["batch"], control=ctl)


def readings(ctx, cfg, mix, pool, grad1, change, captured):
    dev = ctx.device
    sds = weights(cfg, ctx.seed, dev)
    cb = sds["vqgan"]["quantize.embedding.weight"].float()
    # the program's rows: the codebook row nearest each quantized latent it decoded
    codes = R.codebook_indices(captured["zq"].float(), cb).chunk(CHECKED_STEPS)
    noise_dtype = program.DTYPES[cfg["compute_dtype"]]
    toks = [pool[i % len(pool)] for i in range(CHECKED_STEPS)]
    images = captured["img"].chunk(CHECKED_STEPS)
    # the first step's mapper input and output: the weights both sides start from
    map_in, z = captured["map_in"].chunk(CHECKED_STEPS)[0], captured["z"].chunk(CHECKED_STEPS)[0]
    m, c, act = cfg["mapper"], cfg["clip"], R.clip_act(cfg)

    def forward(p):
        """-> (text tower over the steps' tokens, mapper over the program's first input)."""
        h = torch.cat([R.clip_text(sds["clip"], t, c, p, act=act) for t in toks])
        return h, R.mapper(sds["mapper"], map_in, m, cfg["vqgan"]["embed_dim"], p)

    def forward_errs(p_out, ref_out):
        return {"text_err": float(R.rel_l2(p_out[0], ref_out[0]).max()),
                "mapper_err": float(R.rel_l2(p_out[1], ref_out[1]).max())}

    def gen_for(i):
        return step_generator(ctx.seed, i, dev)

    def numbers(ref, got_g1, got_change, got_images):
        ref_g1, ref_change, ref_images = ref
        gnorm = {k: float(v.norm()) for k, v in ref_g1.items()}
        med = statistics.median(gnorm.values())
        moved = lambda k: gnorm[k] >= 1e-3 * med  # noqa: E731
        return {"grad_err": max(leaf_gaps(got_g1, ref_g1)),
                "update_err": max(leaf_gaps(got_change, ref_change, moved)),
                "image_err": max(float(R.rel_l2(a, b).max())
                                 for a, b in zip(got_images, ref_images))}

    ref_fwd = forward(EXACT)
    checks = dict(forward_errs((captured["h"], z), ref_fwd),
                  vq_gap=compare.vq_gap(captured["vq_in"], captured["zq"], cb),
                  link_err=compare.link_err(captured, cb))
    args = (sds, toks, gen_for, codes, images, cfg, mix["cutn"], noise_dtype, mix["lr"])
    ref = T.train3(*args, EXACT)
    checks.update(numbers(ref, grad1, change, images))
    ctl = {}
    if ctx.control:
        ctl = forward_errs(forward(FP8), ref_fwd)
        low = T.train3(*args, FP8)
        ctl.update(numbers(ref, *low))
    return checks, ctl

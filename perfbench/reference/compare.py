"""The comparison that decides `correct` for the prompt -> image path.

The harness captures, for a sample of the window's rows drawn from the seed,
what the program produced at each stage: the text tower's embedding `h`, the
mapper's input and output `z`, the codebook search's input and output `zq`,
the decoder's input and output `x`, and the final images (or the PNG). The
reference judges each stage from the program's own input to that stage, so a
fault shows in the stage that has it, and checks exactly that each stage's
input is what the stage before handed on:

    text_err     max over rows of ||h - text(tokens)|| / ||text(tokens)||
    mapper_err   max over rows of ||z - mapper(z_in)|| / ||mapper(z_in)||
    vq_gap       max over latents of (|v - zq|^2 - |v - c*|^2) / |v - c*|^2,
                 v the search's input, c* the codebook row nearest it: 0
                 where the search (K1) picked a nearest row
    decode_err   max over rows of ||x - decoder(d)|| / ||decoder(d)||, d the
                 decoder's input
    link_err     largest difference where one stage hands on to the next: the
                 mapper's input against h in float32 (tiled to its rows), the
                 search's input v against clamp(z in float32, codebook min,
                 max), zq against v + (c - v) for the codebook rows c nearest
                 zq (the straight-through's float32 arithmetic), and the
                 decoder's input against zq; exact, 0
    out_err      largest difference between the final images (floats, or the
                 PNG's bytes) and (x + 1) / 2 clamped to [0, 1], as the
                 configuration's compute dtype rounds it

Tokens come from the benchmark's inputs (the batch cell) or from the
reference's own tokenizer over the prompt (the serving cells). `control`
computes each stage in the precision below the configuration's (FP8 for the
bfloat16 stages, TF32 for the float32 codebook search) and reads it the same
way against the float32 reference.
"""

import numpy as np
import torch

from perfbench.reference import models as R
from perfbench.reference.precision import EXACT, FP8, TF32
from perfbench.reference.text import read_png

BLOCK = 4  # rows a reference call takes at once


def _blocks(fn, *xs):
    return torch.cat([fn(*(x[i:i + BLOCK] for x in xs)) for i in range(0, len(xs[0]), BLOCK)])


def stage_outputs(cfg, sds, cap, text_p, map_p, vq_p, dec_p):
    """The reference's output of each stage from the program's input to it."""
    m, v = cfg["mapper"], cfg["vqgan"]
    ch = v["embed_dim"]
    cb = sds["vqgan"]["quantize.embedding.weight"]
    act = R.clip_act(cfg)
    return {
        "h": _blocks(lambda t: R.clip_text(sds["clip"], t, cfg["clip"], text_p, act=act),
                   cap["tokens"]),
        "z": _blocks(lambda x: R.mapper(sds["mapper"], x, m, ch, map_p), cap["map_in"]),
        "zq": cb.float()[R.codebook_indices(cap["vq_in"], cb, vq_p)],
        "x": _blocks(lambda d: R.vqgan_decode(sds["vqgan"], d.float(), v, dec_p), cap["dec_in"]),
    }


def vq_gap(v, zq, cb) -> float:
    """max over latents of (|v - zq|^2 - |v - c*|^2) / |v - c*|^2, c* the
    codebook row nearest v (the reference's float32 search)."""
    v, zq, cb = v.float(), zq.float(), cb.float()
    best = (v - cb[R.codebook_indices(v, cb)]).square().sum(-1).clamp_min(1e-30)
    return float(((v - zq).square().sum(-1) - best).div(best).max())


def _gap(a, b) -> float:
    if a.shape != b.shape:
        return float("inf")
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def link_err(cap, cb) -> float:
    """The largest difference where one stage hands on to the next (module
    docstring); the captures a cell does not have are left out."""
    cb, v = cb.float(), cap["vq_in"].float()
    gaps = [_gap(v, cap["z"].float().clamp(cb.min(), cb.max())),
            _gap(cap["zq"], v + (cb[R.codebook_indices(cap["zq"], cb)] - v))]
    if "h" in cap:
        h = cap["h"].float()
        gaps.append(_gap(cap["map_in"], h.repeat(max(1, len(cap["map_in"]) // max(1, len(h))), 1)))
    if "dec_in" in cap:
        gaps.append(_gap(cap["dec_in"], cap["zq"]))
    return max(gaps)


def image_u8(x, nrow: int = 1, padding: int = 2):
    """Decoder outputs x (n, H, W, 3) in the compute dtype -> the uint8 grid a
    PNG of them holds: (x + 1) / 2 clamped in x's dtype, 255 x + 0.5 truncated."""
    img = ((x + 1.0) / 2.0).clamp(0.0, 1.0).float().cpu().numpy()
    n, h, w, c = img.shape
    cols = min(nrow, n)
    rows = -(-n // cols)
    grid = np.zeros((rows * (h + padding) + padding, cols * (w + padding) + padding, c), np.float32)
    for i in range(n):
        r, k = divmod(i, cols)
        grid[padding + r * (h + padding):][:h, padding + k * (w + padding):][:, :w] = img[i]
    return (np.clip(grid, 0.0, 1.0) * np.float32(255.0) + np.float32(0.5)).astype(np.uint8)


def readings(cfg, sds, cap, control: bool = False):
    """-> ({number: program's reading}, {number: control's reading} or {})."""
    cb = sds["vqgan"]["quantize.embedding.weight"]
    ref = stage_outputs(cfg, sds, cap, EXACT, EXACT, EXACT, EXACT)
    got = {
        "text_err": float(R.rel_l2(cap["h"], ref["h"]).max()),
        "mapper_err": float(R.rel_l2(cap["z"], ref["z"]).max()),
        "vq_gap": vq_gap(cap["vq_in"], cap["zq"], cb),
        "decode_err": float(R.rel_l2(cap["x"], ref["x"]).max()),
        "link_err": link_err(cap, cb),
    }
    if "png" in cap:
        diffs = [np.abs(read_png(b).astype(np.int32) - image_u8(xi[None]).astype(np.int32)).max()
                 for b, xi in zip(cap["png"], cap["x"])]
        got["out_err"] = float(max(diffs))
    else:
        want = ((cap["x"] + 1.0) / 2.0).clamp(0.0, 1.0).float()
        got["out_err"] = float((cap["out"].float() - want).abs().max())
    ctl = {}
    if control:
        low = stage_outputs(cfg, sds, cap, FP8, FP8, TF32, FP8)
        ctl = {
            "text_err": float(R.rel_l2(low["h"], ref["h"]).max()),
            "mapper_err": float(R.rel_l2(low["z"], ref["z"]).max()),
            "vq_gap": vq_gap(cap["vq_in"], low["zq"], cb),
            "decode_err": float(R.rel_l2(low["x"], ref["x"]).max()),
        }
    return got, ctl

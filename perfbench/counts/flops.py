"""Operations and bytes from a configuration's widths: the model FLOPs behind
`mfu.*` and the kernels' least times behind `*_roofline`.

`image_flops(cfg)` counts, with `torch.utils.flop_counter.FlopCounterMode`,
the matrix products and convolutions of the plain reference
(reference/models.py) for one prompt -> image on meta tensors: text tower,
mapper, codebook search (the expanded-L2 product), decoder. The same count
holds whatever implements the model, so a later kernel cannot change it.

A kernel's least time is the larger of its operations over the dense bf16
peak and its bytes, each read or written once, over the HBM bandwidth
(chip_smoke.py's `bound()` rule): `least_seconds(flops, nbytes)`.
"""

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import models as R

PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA's data sheet, 700 W)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
BF16, F32 = 2, 4


def _meta(spec):
    return {k: torch.empty(shape, device="meta") for k, (shape, _) in spec.items()}


@functools.lru_cache(maxsize=8)
def _image_flops(cfg_json: str) -> float:
    cfg = json.loads(cfg_json)
    c, m, v = cfg["clip"], cfg["mapper"], cfg["vqgan"]
    ch, s = v["embed_dim"], m["vq_image_size"]
    tokens = torch.zeros(1, c["context_length"], dtype=torch.long, device="meta")
    x = torch.empty(1, c["embed_dim"] + m["noise_dim"], device="meta")
    z = torch.empty(1, s, s, ch, device="meta")
    with FlopCounterMode(display=False) as fc:
        R.clip_text(_meta(R.clip_text_spec(c)), tokens, c, act=R.clip_act(cfg))
        R.mapper(_meta(R.mapper_spec(m, c["embed_dim"], ch)), x, m, ch)
        sd = _meta(R.vqgan_spec(v))
        R.codebook_indices(z, sd["quantize.embedding.weight"])
        R.vqgan_decode(sd, z, v)
    return float(fc.get_total_flops())


def image_flops(cfg) -> float:
    """Model FLOPs of one prompt -> image of configuration `cfg`."""
    return _image_flops(json.dumps(cfg, sort_keys=True))


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _mixer_widths(cfg):
    m = cfg["mapper"]
    t = m["vq_image_size"] ** 2
    return t, m["dim"], t * m["expansion"], m["dim"] * m["expansion"]


def _block_weight_bytes(cfg):
    t, d, et, ec = _mixer_widths(cfg)
    # bf16 matrices; f32 biases and the two LayerNorms' scale and shift
    return BF16 * (2 * t * et + 2 * d * ec) + F32 * (et + t + ec + d + 4 * d)


def mixer_block(cfg, b: int):
    """(flops, bytes) of one Mixer block over b rows (K2): the token mixing's
    two products over T x Et at width D, the channel mixing's two over D x Ec
    on T tokens; the block's weights, x read and the output written in bf16."""
    t, d, et, ec = _mixer_widths(cfg)
    flops = 2 * b * (2 * t * et * d + 2 * t * d * ec)
    return flops, _block_weight_bytes(cfg) + 2 * BF16 * b * t * d


def mixer_stream(cfg, b: int):
    """(flops, bytes) of the whole block stack over b rows in one launch (K4):
    every block's weights once, x read and the output written once."""
    depth = cfg["mapper"]["depth"]
    flops, _ = mixer_block(cfg, b)
    t, d, _, _ = _mixer_widths(cfg)
    return depth * flops, depth * _block_weight_bytes(cfg) + 2 * BF16 * b * t * d


def mixer_token_bwd(cfg, b: int):
    """(flops, bytes) of the token half's backward over b rows (K8): four
    products over T x Et at width D (da1, dt2, dt1, dx); reads dr (f32), x, g1,
    gelu'(a1) and the two token matrices (bf16), writes dx (f32) and the f32
    gradients of the token matrices, biases and LayerNorm."""
    t, d, et, _ = _mixer_widths(cfg)
    flops = 4 * 2 * b * et * t * d
    nbytes = (F32 * b * t * d + BF16 * b * t * d + 2 * BF16 * b * et * d + 2 * BF16 * et * t
              + F32 * b * t * d + 2 * F32 * et * t + F32 * (2 * d + et + t))
    return flops, nbytes


BOUNDS = {"k2": mixer_block, "k4": mixer_stream, "k8": mixer_token_bwd}


@functools.lru_cache(maxsize=8)
def _train_flops(cfg_json: str, cutn: int) -> float:
    from perfbench.reference import train as T

    cfg = json.loads(cfg_json)
    c, m, v = cfg["clip"], cfg["mapper"], cfg["vqgan"]
    spec = {**R.clip_text_spec(c), **T.clip_image_spec(c)}
    sds = {"clip": _meta(spec), "vqgan": _meta(R.vqgan_spec(v))}
    params = {k: t.requires_grad_(True)
              for k, t in _meta(R.mapper_spec(m, c["embed_dim"], v["embed_dim"])).items()}
    tokens = torch.zeros(1, c["context_length"], dtype=torch.long, device="meta")
    size = c["image_size"]

    def cut(img):  # the cutouts' shapes; their elementwise work is not counted
        x = torch.nn.functional.adaptive_avg_pool2d(img.permute(0, 3, 1, 2), size)
        return x.permute(0, 2, 3, 1).repeat(cutn, 1, 1, 1)

    with FlopCounterMode(display=False) as fc:
        loss = T.loss_fn(sds, params, tokens, None, cfg, cutn, None, cut=cut)
        torch.autograd.grad(loss, list(params.values()))
    return float(fc.get_total_flops())


def train_image_flops(cfg, cutn: int) -> float:
    """Model FLOPs of one image of the mapper's train step (forward and
    backward, the frozen towers' input gradients only) with `cutn` cutouts."""
    return _train_flops(json.dumps(cfg, sort_keys=True), int(cutn))

"""Offline evaluation: CLIP score statistics (and optionally FID) over a prompt set.

Port of feed_forward_vqgan_clip_tpu/eval/evaluate.py (the reference's
`evaluate`): generate with the model's own text encoder (and its prior, where
one is given), score with an independent eval perceptor (default ViT-B/32) as
logit-scaled cosine CLIP scores, and write to the run folder `eval_<name>.npy`
and `eval_<name>.th` (the per-prompt scores) and `eval_<name>.json`
{clip_score_mean, clip_score_std, clip_score_atleast_<threshold>[,
fid_<real features file>]}; optionally image grids with caption sidecars;
`nb_test` prompts drawn with `seed`. The generations resize to the eval
perceptor's input with `jax.image.resize`'s bilinear contraction
(ops/augment.resize_bilinear); the FID math runs on the host (eval/fid.py).
"""

import json
import logging
import os
from typing import Optional

import numpy as np
import torch

from feed_forward_vqgan_clip_tpu_torch.data.datasets import load_dataset
from feed_forward_vqgan_clip_tpu_torch.eval.fid import frechet_distance
from feed_forward_vqgan_clip_tpu_torch.infer import Generator
from feed_forward_vqgan_clip_tpu_torch.io.images import save_grid
from feed_forward_vqgan_clip_tpu_torch.models.inception import make_inception_fn
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import load_perceptor
from feed_forward_vqgan_clip_tpu_torch.ops.augment import resize_bilinear
from feed_forward_vqgan_clip_tpu_torch.ops.losses import normalize
from feed_forward_vqgan_clip_tpu_torch.registry import CLIP_MEAN, CLIP_STD

log = logging.getLogger(__name__)


@torch.no_grad()
def evaluate(
    model_path: str,
    data_path: str,
    *,
    batch_size: Optional[int] = None,
    out_folder: Optional[str] = None,
    clip_threshold: float = 25,
    nb_test: Optional[int] = None,
    save_images: bool = False,
    img_folder: Optional[str] = None,
    images_per_row: int = 8,
    seed: int = 42,
    clip_model: str = "ViT-B/32",
    clip_model_path: Optional[str] = None,
    compute_fid: bool = False,
    inception_features_real_path: Optional[str] = None,
    inception_weights_path: Optional[str] = None,
    prior_path: Optional[str] = None,
    device="cuda",
) -> dict:
    """-> the dict written to eval_<name>.json. Runs on the card unless `device`
    says otherwise."""
    name = os.path.basename(data_path) + "_" + clip_model.replace("/", "_")
    model_dir = os.path.dirname(model_path.rstrip("/"))
    out_folder = out_folder or model_dir or "."
    os.makedirs(out_folder, exist_ok=True)
    if save_images and not img_folder:
        img_folder = os.path.join(model_dir or ".", f"eval_{name}_images")
    if img_folder:
        os.makedirs(img_folder, exist_ok=True)

    gen = Generator.from_checkpoint(model_path, prior_path=prior_path, device=device)
    eval_perceptor = load_perceptor(clip_model, clip_model_path, device=device)
    inception_fn = None
    inception_features = []
    if compute_fid:
        if not inception_features_real_path:
            raise ValueError("FID needs inception_features_real_path")
        inception_fn = make_inception_fn(inception_weights_path, device=device)

    toks = load_dataset(data_path)
    toks = np.asarray(toks[0] if isinstance(toks, tuple) else toks)
    batch_size = batch_size or int(gen.cfg.get("batch_size"))
    if nb_test:
        toks = toks[np.random.default_rng(seed).permutation(len(toks))[:nb_test]]
    log.info("Evaluate on %d prompts...", len(toks))

    is_tokens = np.issubdtype(toks.dtype, np.integer)
    mean = torch.tensor(CLIP_MEAN, device=device)
    std = torch.tensor(CLIP_STD, device=device)
    logit_scale = eval_perceptor.logit_scale
    decode_tokens = None
    if is_tokens and save_images:
        try:
            from feed_forward_vqgan_clip_tpu_torch.tokenizer.bpe import get_tokenizer

            decode_tokens = get_tokenizer().decode
        except FileNotFoundError:
            pass

    generator = torch.Generator(device=device).manual_seed(seed)
    scores_batches = []
    for bi in range(0, len(toks), batch_size):
        chunk = toks[bi: bi + batch_size]
        if is_tokens:
            ids = torch.as_tensor(chunk.astype(np.int64), device=device)
            h = gen.encode_tokens(ids)
            if gen.cfg.get("normalize_input"):
                h = normalize(h)
        else:
            h = torch.as_tensor(chunk, dtype=torch.float32, device=device)
        xr = gen.generate(h, nb_repeats=1, generator=generator)
        if inception_fn is not None:
            inception_features.append(inception_fn(xr).cpu().numpy())
        if save_images:
            stem = os.path.join(img_folder, f"batch_{bi // batch_size:010d}")
            save_grid(xr.cpu().numpy(), stem + ".png", nrow=images_per_row)
            if decode_tokens is not None:
                with open(stem + ".txt", "w") as fd:
                    fd.write("\n".join(decode_tokens(t) for t in chunk))
        xs = resize_bilinear(xr, eval_perceptor.size)
        image_features = normalize(eval_perceptor.encode_image((xs - mean) / std).float())
        if is_tokens:
            text_features = eval_perceptor.encode_text(ids).float()
        else:
            text_features = h[:, : image_features.shape[1]]
        scores = logit_scale * (image_features * normalize(text_features)).sum(1)
        scores_batches.append(scores.cpu().numpy())

    clip_scores = np.concatenate(scores_batches)
    np.save(os.path.join(out_folder, f"eval_{name}.npy"), clip_scores)
    torch.save(torch.tensor(clip_scores), os.path.join(out_folder, f"eval_{name}.th"))
    dump = {
        "clip_score_mean": float(clip_scores.mean()),
        "clip_score_std": float(clip_scores.std()),
        f"clip_score_atleast_{clip_threshold}": float((clip_scores >= clip_threshold).mean()),
    }
    if compute_fid:
        if inception_features_real_path.endswith((".th", ".pt", ".pkl")):
            real = np.asarray(torch.load(inception_features_real_path, map_location="cpu",
                                         weights_only=False))
        else:
            real = np.load(inception_features_real_path)
        fid = frechet_distance(real, np.concatenate(inception_features))
        dump[f"fid_{os.path.basename(inception_features_real_path)}"] = fid
        log.info("FID: %s", fid)
    with open(os.path.join(out_folder, f"eval_{name}.json"), "w") as fd:
        json.dump(dump, fd)
    log.info("CLIP score mean: %s std: %s; fraction >= %s: %s", dump["clip_score_mean"],
             dump["clip_score_std"], clip_threshold,
             dump[f"clip_score_atleast_{clip_threshold}"])
    return dump

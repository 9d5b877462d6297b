"""Dataset encoders: (image, caption) pairs -> the CLIP feature files the trainers read.

Port of feed_forward_vqgan_clip_tpu/data/encode.py: the reference's
`encode_text_and_images` (a folder of image / text pairs) and
`encode_text_and_images_webdataset` (tar shards, split over processes, with a
rank-0 merge), and `merge-features`. Images are preprocessed as CLIP does, on
the host and byte for byte as the JAX package does (`preprocess_image`: PIL
bicubic resize of the short side to the perceptor's input size, centre crop,
CLIP normalisation, NHWC float32; Pillow is imported only where an image is
decoded); captions go through the port's tokenizer.
The two towers run on `device` (default "cuda") in load_perceptor's default
dtype (bfloat16); features come back float32.

The webdataset encoder decodes and preprocesses on one producer thread that
keeps the sample order (`prefetch`), spills every `spill_rows` encoded rows to
a numbered shard and memmap-merges the spills at the end, and can drop samples
below a NIMA mean opinion score (models/nima.py; weights from
`nima_weights_path` or $FFVC_NIMA_WEIGHTS, scored on the de-normalised batch,
as the reference scores pyiqa's). Without weights the filter warns and is
skipped, as the JAX package does. A process encodes the shards i with
i % count == index, where (index, count) are torch.distributed's rank and
world size when it is initialised, else (0, 1); with `merge`, rank 0
concatenates every process's output after a barrier. The tail batch is not
padded: the JAX package pads it only for XLA's static shapes.
"""

import logging
import os
import queue
import threading
from glob import glob
from io import BytesIO
from typing import Optional

import numpy as np
import torch

from feed_forward_vqgan_clip_tpu_torch.data.tar_reader import iter_shards
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import load_perceptor
from feed_forward_vqgan_clip_tpu_torch.registry import CLIP_MEAN, CLIP_STD
from feed_forward_vqgan_clip_tpu_torch.tokenizer.bpe import get_tokenizer

log = logging.getLogger(__name__)

PREPROCESS_SIZE = 224  # the reference always preprocesses at ViT-B/32 geometry


def preprocess_image(img, size: int = PREPROCESS_SIZE) -> np.ndarray:
    """CLIP preprocessing of a PIL image: bicubic short-side resize, center crop,
    normalize; NHWC."""
    from PIL import Image

    img = img.convert("RGB")
    w, h = img.size
    scale = size / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    arr = np.asarray(img, np.float32) / 255.0
    mean = np.asarray(CLIP_MEAN, np.float32)
    std = np.asarray(CLIP_STD, np.float32)
    return (arr - mean) / std


def _save_pairs(out: str, text_feats: np.ndarray, image_feats: np.ndarray):
    if out.endswith((".pkl", ".th", ".pt")):
        torch.save((torch.tensor(np.asarray(text_feats)), torch.tensor(np.asarray(image_feats))),
                   out)
    else:
        np.savez(out if out.endswith(".npz") else out + ".npz", x=text_feats, y=image_feats)


def _load_pairs(path: str):
    if path.endswith((".pkl", ".th", ".pt")):
        t, i = torch.load(path, map_location="cpu", weights_only=False)
        return np.asarray(t), np.asarray(i)
    with np.load(path) as z:
        return z["x"], z["y"]


def merge_features(inputs, out: str) -> str:
    """Concatenate feature shards (explicit paths, or one glob pattern) into one
    file. Memory is bounded by one shard: a shape pass, then a copy pass into
    disk-backed memmaps, which `.npz` outputs stream from (torch formats pickle
    one full copy)."""
    paths = sorted(glob(inputs)) if isinstance(inputs, str) else list(inputs)
    if not paths:
        raise FileNotFoundError(f"no feature shards match {inputs!r}")

    rows, dim_x, dim_y = 0, None, None
    for p in paths:  # shape pass: one shard resident at a time
        x, y = _load_pairs(p)
        if len(x) != len(y):
            raise ValueError(f"{p}: {len(x)} text rows vs {len(y)} image rows")
        rows += len(x)
        dim_x = dim_x if dim_x is not None else x.shape[1:]
        dim_y = dim_y if dim_y is not None else y.shape[1:]
        if x.shape[1:] != dim_x or y.shape[1:] != dim_y:
            raise ValueError(f"{p}: feature shape mismatch")
        del x, y

    base = out + ".merge_tmp"
    xm = np.lib.format.open_memmap(base + "_x.npy", mode="w+", dtype=np.float32,
                                   shape=(rows,) + tuple(dim_x))
    ym = np.lib.format.open_memmap(base + "_y.npy", mode="w+", dtype=np.float32,
                                   shape=(rows,) + tuple(dim_y))
    at = 0
    for p in paths:  # copy pass
        x, y = _load_pairs(p)
        xm[at:at + len(x)] = x
        ym[at:at + len(y)] = y
        at += len(x)
        del x, y
    xm.flush()
    ym.flush()
    _save_pairs(out, xm, ym)
    del xm, ym
    os.remove(base + "_x.npy")
    os.remove(base + "_y.npy")
    log.info("Merged %d shards (%d pairs) -> %s", len(paths), rows, out)
    return out


@torch.no_grad()
def _encode(perceptor, texts, imgs: np.ndarray, device):
    """(text features, image features), float32 numpy, of one batch."""
    toks = torch.from_numpy(get_tokenizer().tokenize(texts, truncate=True)).long()
    tf = perceptor.encode_text(toks.to(device)).float().cpu().numpy()
    imf = perceptor.encode_image(torch.from_numpy(imgs).to(device)).float().cpu().numpy()
    return tf, imf


def encode_text_and_images(folder: str, *, img_ext: str = "jpg", text_ext: str = "txt",
                           out: str = "features.npz", clip_model: str = "ViT-B/32",
                           clip_path: Optional[str] = None, batch_size: int = 64,
                           device="cuda") -> str:
    """Every `<name>.<text_ext>` of `folder` with its `<name>.<img_ext>`, in sorted
    order, encoded in batches of `batch_size` -> `out` ({x: text, y: image})."""
    from PIL import Image

    perceptor = load_perceptor(clip_model, clip_path, device=device)
    text_paths = sorted(glob(os.path.join(folder, "*." + text_ext)))
    img_paths = [t[: -len(text_ext)] + img_ext for t in text_paths]
    tf_list, if_list = [], []
    for i in range(0, len(text_paths), batch_size):
        texts = []
        for p in text_paths[i:i + batch_size]:
            with open(p) as fd:
                texts.append(fd.read())
        imgs = np.stack([preprocess_image(Image.open(p), perceptor.size)
                         for p in img_paths[i:i + batch_size]])
        tf, imf = _encode(perceptor, texts, imgs, device)
        tf_list.append(tf)
        if_list.append(imf)
    _save_pairs(out, np.concatenate(tf_list), np.concatenate(if_list))
    log.info("Encoded %d pairs -> %s", len(text_paths), out)
    return out


def _iter_preprocessed(tars, img_col, txt_col, size):
    """(preprocessed NHWC array, decoded text) per valid sample; a corrupt sample
    is warned about and skipped (webdataset's warn-and-continue)."""
    from PIL import Image

    for img_bytes, txt_bytes in iter_shards(tars, [img_col, txt_col]):
        try:
            img = Image.open(BytesIO(img_bytes))
            yield preprocess_image(img, size), txt_bytes.decode("utf-8", errors="replace")
        except Exception as e:
            log.warning("skipping sample: %s", e)


def _prefetched(gen, depth):
    """`gen` run on a producer thread, yielded through a bounded queue: one
    producer, so the order is kept; its exception re-raises here; a daemon
    thread, so an abandoned consumer cannot hang the exit."""
    q: queue.Queue = queue.Queue(maxsize=max(2, depth))
    end = object()
    err: list = []

    def run():
        try:
            for item in gen:
                q.put(item)
        except BaseException as e:  # re-raised below, not swallowed
            err.append(e)
        finally:
            q.put(end)

    threading.Thread(target=run, daemon=True, name="ffvc-encode-prefetch").start()
    while True:
        item = q.get()
        if item is end:
            if err:
                raise err[0]
            return
        yield item


def process_split():
    """(index, count) of this process: torch.distributed's rank and world size
    when it is initialised, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _shard_path(out: str, rank: int) -> str:
    base, ext = os.path.splitext(out)
    if ext in (".pkl", ".th", ".pt", ".npz"):
        return f"{base}_{rank}{ext}"
    return f"{out}_{rank}.npz"


def encode_text_and_images_webdataset(
    pattern: str, *, clip_model: str = "ViT-B/32", clip_path: Optional[str] = None,
    batch_size: int = 512, img_col: str = "input.jpg", txt_col: str = "output.txt",
    out: str = "features.npz", image_quality_threshold: Optional[float] = None,
    image_quality_method: str = "nima", nima_weights_path: Optional[str] = None,
    merge: bool = False, spill_rows: int = 1_000_000, prefetch: bool = True, device="cuda",
) -> str:
    """The tars matching `pattern` (this process's share), encoded in batches of
    `batch_size` -> `out` (or `<out>_<rank>` when several processes run)."""
    nima_fn = None
    if image_quality_threshold is not None:
        if image_quality_method != "nima":
            raise ValueError(
                f"unsupported image_quality_method {image_quality_method!r} (only 'nima')")
        path = nima_weights_path or os.environ.get("FFVC_NIMA_WEIGHTS")
        if path and os.path.exists(path):
            from feed_forward_vqgan_clip_tpu_torch.models.nima import make_nima_fn

            nima_fn = make_nima_fn(path, device=device)
        else:
            log.warning(
                "image_quality_threshold set but no NIMA weights found "
                "(--nima-weights-path / $FFVC_NIMA_WEIGHTS) — skipping the quality filter "
                "(the reference degrades silently on a failed pyiqa import too)")
    perceptor = load_perceptor(clip_model, clip_path, device=device)
    index, count = process_split()
    tars = [t for i, t in enumerate(sorted(glob(pattern))) if i % count == index]
    mean = np.asarray(CLIP_MEAN, np.float32)
    std = np.asarray(CLIP_STD, np.float32)

    tf_list, if_list, spills = [], [], []
    counts = dict(encoded=0, dropped=0, buffered=0)
    batch_imgs, batch_texts = [], []

    def spill():
        if not tf_list:
            return
        path = f"{out}.spill_{len(spills)}.npz"
        _save_pairs(path, np.concatenate(tf_list), np.concatenate(if_list))
        spills.append(path)
        tf_list.clear()
        if_list.clear()
        counts["buffered"] = 0

    def flush():
        if not batch_imgs:
            return
        imgs = np.stack(batch_imgs)
        texts = list(batch_texts)
        batch_imgs.clear()
        batch_texts.clear()
        if nima_fn is not None:
            # score in [0, 1]: the CLIP batch de-normalised, as the reference does
            with torch.no_grad():
                scores = nima_fn(torch.from_numpy(imgs * std + mean).to(device)).cpu().numpy()
            keep = scores >= image_quality_threshold
            counts["dropped"] += int(len(keep) - keep.sum())
            if not keep.any():
                log.info("%d encoded (%d dropped by quality filter)", counts["encoded"],
                         counts["dropped"])
                return
            imgs = imgs[keep]
            texts = [t for t, k in zip(texts, keep) if k]
        tf, imf = _encode(perceptor, texts, imgs, device)
        tf_list.append(tf)
        if_list.append(imf)
        counts["encoded"] += len(tf)
        counts["buffered"] += len(tf)
        if counts["buffered"] >= spill_rows:
            spill()
        if counts["dropped"]:
            log.info("%d encoded (%d dropped by quality filter)", counts["encoded"],
                     counts["dropped"])
        else:
            log.info("%d encoded", counts["encoded"])

    samples = _iter_preprocessed(tars, img_col, txt_col, perceptor.size)
    if prefetch:
        # tar reads, JPEG decodes and resizes overlap the encode of the batch
        # before; one producer, so the feature order is the sequential path's
        samples = _prefetched(samples, depth=2 * batch_size)
    for arr, text in samples:
        batch_imgs.append(arr)
        batch_texts.append(text)
        if len(batch_imgs) >= batch_size:
            flush()
    flush()
    log.info("Nb of images processed: %d", counts["encoded"])
    if counts["encoded"] == 0 and counts["dropped"] > 0:
        log.warning("quality filter (threshold %.3f) removed ALL %d samples — writing an "
                    "empty features file; lower --image-quality-threshold or check the NIMA "
                    "weights", image_quality_threshold, counts["dropped"])

    local_out = _shard_path(out, index) if count > 1 else out
    if spills:
        spill()  # the remainder as the last spill, then one memmap merge
        merge_features(spills, local_out)
        for s in spills:
            os.remove(s)
    else:
        empty = np.zeros((0, perceptor.dim), np.float32)
        _save_pairs(local_out, np.concatenate(tf_list) if tf_list else empty,
                    np.concatenate(if_list) if if_list else empty)
    if count > 1 and merge:
        torch.distributed.barrier()
        if index == 0:
            shards = [_shard_path(out, r) for r in range(count)]
            merge_features([s for s in shards if os.path.exists(s)], out)
    return out

"""Dataset loading: text prompts, token files, or embedding pairs; and the
trainer's per-epoch batches.

The port's own copy of feed_forward_vqgan_clip_tpu/data/datasets.py:
  * .txt file: one prompt per line -> tokenized (the port's tokenizer);
  * glob pattern: one prompt per file -> tokenized;
  * .pkl/.th/.pt (torch.save): a token tensor or an (input_feats, output_feats)
    pair;
  * .npz/.npy: the same payloads in numpy form (`tokens` / ('x', 'y') keys).

Returns a (N, 77) int array of tokens or a tuple of two float arrays.
"""

from glob import glob
from typing import Optional, Tuple, Union

import numpy as np

Dataset = Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]


def load_dataset(path: str, bpe_path: Optional[str] = None) -> Dataset:
    if path.endswith((".pkl", ".th", ".pt")):
        import torch

        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, (tuple, list)):
            return (np.asarray(obj[0]), np.asarray(obj[1]))
        return np.asarray(obj)
    if path.endswith(".npz"):
        z = np.load(path)
        if "tokens" in z:
            return z["tokens"]
        return (z["x"], z["y"])
    if path.endswith(".npy"):
        return np.load(path)
    from feed_forward_vqgan_clip_tpu_torch.tokenizer.bpe import get_tokenizer

    tok = get_tokenizer(bpe_path)
    if "*" in path:
        texts = []
        for f in sorted(glob(path)):
            with open(f) as fd:
                texts.append(fd.read().strip())
    else:
        with open(path) as fd:
            texts = [line.strip() for line in fd.readlines()]
    return tok.tokenize(texts, truncate=True)


def save_tokens(tokens: np.ndarray, out: str):
    if out.endswith((".pkl", ".th", ".pt")):
        import torch

        torch.save(torch.tensor(np.asarray(tokens)), out)
    else:
        np.savez(out if out.endswith(".npz") else out + ".npz", tokens=tokens)


def shard_for_process(n: int, process_index: int, process_count: int) -> np.ndarray:
    """Deterministic per-process index shard: a strided split, padded by
    wraparound so every process sees the same number of samples (epoch-invariant;
    the trainer uses `epoch_shard_batches`)."""
    idx = np.arange(process_index, n, process_count)
    per = -(-n // process_count)
    if len(idx) < per:
        idx = np.concatenate([idx, idx[: per - len(idx)]])
    return idx


def epoch_shard_batches(n: int, batch_size: int, *, seed: int, epoch: int,
                        process_index: int = 0, process_count: int = 1,
                        drop_last: bool = False):
    """DistributedSampler-parity per-epoch batches: a global permutation seeded
    by (seed, epoch), wraparound-padded to a multiple of process_count, strided
    across processes. -> a list of (batch_size,) global index arrays for this
    process; the last partial batch is wraparound-padded to the full size."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    order = rng.permutation(n)
    per = -(-n // process_count)
    total = per * process_count
    if total > n:  # torch's sampler pads with the head of the permutation
        order = np.concatenate([order, order[: total - n]])
    local = order[process_index::process_count]
    batches = []
    for i in range(0, per, batch_size):
        b = local[i: i + batch_size]
        if len(b) < batch_size:
            if drop_last and len(batches) > 0:
                break
            b = np.resize(np.concatenate([b, local]), batch_size)
        batches.append(b)
    return batches

"""The `tokenize` subcommand: a text file or glob -> a token array file.

The port's copy of feed_forward_vqgan_clip_tpu/data/tokenize_cli.py (the
reference's `tokenize`): a glob reads one prompt per file; a plain file reads
one prompt per line, with an optional filter on its length in characters;
tokenized in batches; written by data/datasets.save_tokens (`.npz`, or
`.pkl`/`.th`/`.pt` for the reference's torch format).
"""

from glob import glob
from typing import Optional

import numpy as np

from feed_forward_vqgan_clip_tpu_torch.data.datasets import save_tokens
from feed_forward_vqgan_clip_tpu_torch.tokenizer.bpe import get_tokenizer


def tokenize(paths: str, out: str = "tokenized.npz", max_length: Optional[int] = None,
             batch_size: Optional[int] = None) -> str:
    if "*" in paths:
        texts = []
        for f in sorted(glob(paths)):
            with open(f) as fd:
                texts.append(fd.read().strip())
    else:
        with open(paths) as fd:
            texts = [line.strip() for line in fd.readlines()]
        if max_length:
            texts = [t for t in texts if len(t) <= max_length]
    tok = get_tokenizer()
    if batch_size is None:
        batch_size = len(texts)
    chunks = [tok.tokenize(texts[i:i + batch_size], truncate=True)
              for i in range(0, len(texts), batch_size)]
    toks = np.concatenate(chunks) if chunks else np.zeros((0, 77), np.int32)
    save_tokens(toks, out)
    return out

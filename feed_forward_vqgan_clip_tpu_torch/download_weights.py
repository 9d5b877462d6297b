"""The released weights' downloader: the port's copy of
feed_forward_vqgan_clip_tpu/download_weights.py.

Idempotent fetches of the released mapper and prior checkpoints, the VQGAN
f16-16384 config and checkpoint, the ml-jku CLOOB checkpoint and the CLIP BPE
merge table (registry.MODEL_URLS, AUX_URLS, BPE_URL keep the file names and
URLs). A file that is already there is skipped; a download goes to `<file>.part`
and is renamed when complete, so an interrupted one leaves no file behind that
looks whole. urllib only.

    python -m feed_forward_vqgan_clip_tpu_torch.download_weights
"""

import logging
import os
import urllib.request
from typing import Optional

from feed_forward_vqgan_clip_tpu_torch.registry import AUX_URLS, BPE_URL, MODEL_URLS

log = logging.getLogger(__name__)


def download(url: str, target: Optional[str] = None) -> str:
    target = target or os.path.basename(url)
    if os.path.exists(target):
        log.info("Skipping %s, already exists", target)
        return target
    log.info("Fetching %s -> %s", url, target)
    tmp = target + ".part"
    urllib.request.urlretrieve(url, tmp)
    os.replace(tmp, target)
    return target


def download_all(folder: str = ".") -> None:
    """Every released file into `folder` (the working directory by default, as
    the reference does)."""
    for url in (*AUX_URLS, BPE_URL):
        download(url, os.path.join(folder, os.path.basename(url)))
    for name, url in MODEL_URLS.items():
        download(url, os.path.join(folder, name))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    download_all()

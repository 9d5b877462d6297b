"""Webdataset-style tar shard streaming (pure Python, no webdataset dependency).

The port's copy of feed_forward_vqgan_clip_tpu/data/tar_reader.py, which
replaces the reference's wds.WebDataset pipeline: iterate tar members, group
files by sample key (basename up to the first dot), and warn and continue past
a corrupt member or shard (webdataset's warn_and_continue).
"""

import logging
import tarfile
from typing import Dict, Iterator, List, Sequence

log = logging.getLogger(__name__)


def iter_tar_samples(tar_path: str) -> Iterator[Dict[str, bytes]]:
    """Yield {column_name: bytes} dicts grouped by webdataset sample key."""
    current_key = None
    current: Dict[str, bytes] = {}
    try:
        with tarfile.open(tar_path, "r|*") as tf:
            for member in tf:
                if not member.isfile():
                    continue
                name = member.name.split("/")[-1]
                if "." not in name:
                    continue
                key, col = name.split(".", 1)
                if key != current_key:
                    if current:
                        yield current
                    current_key, current = key, {}
                try:
                    current[col] = tf.extractfile(member).read()
                except Exception as e:  # corrupt member: warn and continue
                    log.warning("skipping %s/%s: %s", tar_path, name, e)
        if current:
            yield current
    except Exception as e:  # corrupt shard: warn and continue
        log.warning("skipping corrupt shard %s: %s", tar_path, e)


def iter_shards(
    tar_paths: Sequence[str], columns: Sequence[str]
) -> Iterator[List[bytes]]:
    """Stream samples that contain all requested columns, across shards in order."""
    for path in tar_paths:
        for sample in iter_tar_samples(path):
            if all(c in sample for c in columns):
                yield [sample[c] for c in columns]

"""The host stages' references against the port: the tokenizer over the prompt
corpora with the benchmark's merge table, and the PNG reader on every row filter."""

import gzip
import struct
import zlib

import numpy as np

from perfbench.reference.text import Tokenizer, read_png
from perfbench.traffic.serve_closed import letter_merges, load_prompts


def test_tokenizer_matches_the_ports(tmp_path, monkeypatch):
    from feed_forward_vqgan_clip_tpu_torch.tokenizer import bpe

    path = tmp_path / "merges.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version\n" + "\n".join(letter_merges(0)) + "\n")
    ours, port = Tokenizer(str(path)), bpe.ClipTokenizer(str(path))
    prompts = load_prompts(["MIT_states_train", "coco_birds", "made_of"])
    sample = prompts[::97] + [p for p in prompts if not p.isascii()]
    assert len(sample) > 300
    got = np.stack([ours(p) for p in sample])
    assert np.array_equal(got, port.tokenize(sample, truncate=True).astype(np.int64))


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filtered(img, f):
    """img uint8 (H, W, 3) as PNG rows under filter f (0-4)."""
    h, w, c = img.shape
    a = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        prev = a[y - 1] if y else np.zeros(w * c, np.int32)
        left = np.concatenate([np.zeros(c, np.int32), a[y, :-c]])
        ul = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        rows.append(bytes([f]) + ((a[y] - pred) % 256).astype(np.uint8).tobytes())
    head = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", head)
            + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b""))


def test_png_reader_every_filter():
    img = np.random.default_rng(0).integers(0, 256, (6, 5, 3), dtype=np.uint8)
    for f in range(5):
        assert np.array_equal(read_png(_filtered(img, f)), img), f


def test_cutouts_match_the_ports_forward_and_backward():
    """The reference's cutouts against the port's MakeCutouts on the same
    bfloat16-valued images (ties in the max pool included) and the same draws."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.cutouts import MakeCutouts
    from perfbench.reference import train as T

    torch.manual_seed(0)
    img = torch.rand(3, 40, 40, 3).to(torch.bfloat16).float()
    g_out = torch.randn(4 * 3, 32, 32, 3)
    port_in = img.clone().requires_grad_(True)
    port = MakeCutouts(cut_size=32, cutn=4, pool_size=32)(torch.Generator().manual_seed(5), port_in)
    (g_port,) = torch.autograd.grad(port, port_in, g_out)
    ref_in = img.clone().requires_grad_(True)
    ref = T.cutouts(torch.Generator().manual_seed(5), ref_in, 32, 4, torch.float32)
    (g_ref,) = torch.autograd.grad(ref, ref_in, g_out)
    assert (port - ref).abs().max() < 1e-4
    assert (g_port - g_ref).norm() / g_ref.norm() < 1e-4

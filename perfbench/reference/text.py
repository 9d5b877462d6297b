"""Plain references of the host stages: CLIP's byte-level BPE tokenizer and a
PNG reader.

The tokenizer follows OpenAI CLIP's `SimpleTokenizer` (`clip.tokenize` with
truncation): the text cleaned (html unescaped twice, typographic quotes made
plain, whitespace collapsed, lowercased), split into words by CLIP's pattern,
each word's bytes mapped to printable characters and merged by the lowest-rank
pair first, framed by <|startoftext|> and <|endoftext|> in a 77-slot context.
The prompt corpora under traffic/prompts are plain text, for which ftfy's
`fix_text` changes nothing but such quotes.
"""

import gzip
import html
import re
import struct
import zlib

import numpy as np

CONTEXT = 77
QUOTES = {"‘": "'", "’": "'", "“": '"', "”": '"'}
WORD = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                  r"|[^\W\d_]+|\d|[^\s\w]+|_+", re.IGNORECASE)


def byte_chars():
    bs = list(range(33, 127)) + list(range(161, 173)) + list(range(174, 256))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class Tokenizer:
    def __init__(self, merges_path: str):
        with gzip.open(merges_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in lines if m]
        self.bytes = byte_chars()
        vocab = list(self.bytes.values())
        vocab += [v + "</w>" for v in vocab] + ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.ids = {t: i for i, t in enumerate(vocab)}
        self.ranks = {m: i for i, m in enumerate(merges)}

    def word(self, token: str):
        parts = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            pairs = [(self.ranks.get(p, float("inf")), i)
                     for i, p in enumerate(zip(parts[:-1], parts[1:]))]
            rank, _ = min(pairs)
            if rank == float("inf"):
                break
            a, b = next(p for p in zip(parts[:-1], parts[1:]) if self.ranks.get(p) == rank)
            out, i = [], 0
            while i < len(parts):
                if i < len(parts) - 1 and parts[i] == a and parts[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        return [self.ids[p] for p in parts]

    def __call__(self, text: str) -> np.ndarray:
        """text -> int64 (77,) ids."""
        for k, v in QUOTES.items():
            text = text.replace(k, v)
        text = re.sub(r"\s+", " ", html.unescape(html.unescape(text))).strip().lower()
        toks = [self.ids["<|startoftext|>"]]
        for w in WORD.findall(text):
            toks += self.word("".join(self.bytes[b] for b in w.encode("utf-8")))
        toks.append(self.ids["<|endoftext|>"])
        if len(toks) > CONTEXT:
            toks = toks[:CONTEXT]
            toks[-1] = self.ids["<|endoftext|>"]
        out = np.zeros(CONTEXT, np.int64)
        out[:len(toks)] = toks
        return out


def read_png(data: bytes) -> np.ndarray:
    """An 8-bit grey or RGB PNG without interlace (any row filter) -> uint8 (H, W, C)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I", data[pos:pos + 4])[0], data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = head
    c = {0: 1, 2: 3}[ctype]
    if depth != 8 or interlace:
        raise ValueError("unsupported PNG")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.int32)
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        f, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f in (0, 2):  # none, up: no dependence along the row
            cur = (row + (prev if f == 2 else 0)) & 255
        else:  # sub, average, Paeth
            cur = np.zeros(w * c, np.int32)
            for x in range(w * c):
                left = cur[x - c] if x >= c else 0
                up, ul = prev[x], (prev[x - c] if x >= c else 0)
                if f == 1:
                    pred = left
                elif f == 3:
                    pred = (left + up) // 2
                else:
                    p = left + up - ul
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                    pred = left if pa <= pb and pa <= pc else (up if pb <= pc else ul)
                cur[x] = (row[x] + pred) & 255
        out[y], prev = cur, cur
    return out.reshape(h, w, c).astype(np.uint8)

"""CLIP byte-level BPE tokenizer (pure host code).

The port's own copy of feed_forward_vqgan_clip_tpu/tokenizer/bpe.py: the
`clip.tokenize` / `SimpleTokenizer.decode` surface (77-token context,
<|startoftext|> / <|endoftext|> framing, truncation, zero padding). The words
of a text not seen before go, in one call, through the g++-built merge core
(native/, `ClipTokenizer.native`) where it builds, else through the
pure-Python `ClipTokenizer.bpe`; both give the same ids.

The merge table is data, not code: pass the standard `bpe_simple_vocab_16e6.txt.gz`
(the file OpenAI CLIP ships) via `bpe_path` or the FFVC_BPE_PATH environment
variable. Vocabulary: 256 byte tokens, 256 byte+'</w>' tokens, the first 48894
merges, and the two specials, 49408 entries in all. Text is cleaned as CLIP
cleans it: tokenizer/text_fix.fix_text (ftfy's caption-relevant subset), double
html-unescape, whitespace collapse, lowercase.
"""

import functools
import gzip
import html
import os
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from feed_forward_vqgan_clip_tpu_torch import native as native_core
from feed_forward_vqgan_clip_tpu_torch.tokenizer.text_fix import fix_text

CONTEXT_LENGTH = 77
SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"

try:
    import regex as _re

    _WORD_PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # stdlib fallback (no \p classes in re)
    import re as _re  # type: ignore[no-redef]

    # functional equivalent with stdlib character classes: letters ~ [^\W\d_],
    # digits ~ \d, other ~ non-space non-word (plus _ and lone digits grouped out)
    _WORD_PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+|_+""",
        _re.IGNORECASE | _re.UNICODE,
    )


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode map (standard GPT-2/CLIP construction)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _clean(text: str) -> str:
    """CLIP's basic_clean + whitespace_clean: fix_text, double html-unescape,
    whitespace collapse, lowercase."""
    text = fix_text(text)
    text = html.unescape(html.unescape(text))
    text = _re.sub(r"\s+", " ", text)
    return text.strip().lower()


def _pairs(word: Sequence[str]):
    return set(zip(word[:-1], word[1:]))


def _read_merges(bpe_path: Optional[str]) -> List[str]:
    """The merge lines of the table at `bpe_path`, FFVC_BPE_PATH, or
    bpe_simple_vocab_16e6.txt.gz in the working directory or beside this file."""
    bpe_path = bpe_path or os.environ.get("FFVC_BPE_PATH")
    if bpe_path is None:
        for cand in (
            "bpe_simple_vocab_16e6.txt.gz",
            os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz"),
        ):
            if os.path.exists(cand):
                bpe_path = cand
                break
    if bpe_path is None:
        raise FileNotFoundError(
            "CLIP BPE merge table not found. Provide bpe_path=, set FFVC_BPE_PATH, or "
            "place bpe_simple_vocab_16e6.txt.gz in the working directory."
        )
    opener = gzip.open if bpe_path.endswith(".gz") else open
    with opener(bpe_path, "rt", encoding="utf-8") as fd:
        lines = fd.read().split("\n")
    # standard CLIP slice: drop the header line, keep 49152-256-2 merges
    return lines[1 : 49152 - 256 - 2 + 1]


class ClipTokenizer:
    """Byte-level BPE with CLIP's vocab layout and end-of-word markers."""

    def __init__(self, bpe_path: Optional[str] = None, *, merges: Optional[List[str]] = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if merges is None:
            merges = _read_merges(bpe_path)
        merge_tuples = [tuple(m.split()) for m in merges if m]

        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merge_tuples)
        vocab.extend([SOT_TOKEN, EOT_TOKEN])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merge_tuples)}
        self.sot = self.encoder[SOT_TOKEN]
        self.eot = self.encoder[EOT_TOKEN]
        self.vocab_size = len(self.encoder)
        # word -> its merged ids, the one cache of both merge paths
        self._id_cache = {SOT_TOKEN: [self.sot], EOT_TOKEN: [self.eot]}
        self.native = None  # the C++ core's table, None on the pure-Python path
        lib = native_core.get_lib()
        if lib is not None:
            # every merge's operands and result are vocabulary entries: the
            # table lowers to integer ids for the C++ core
            self.native = native_core.NativeBPE(
                [(self.encoder[a], self.encoder[b], rank, self.encoder[a + b])
                 for (a, b), rank in self.bpe_ranks.items()], lib)

    def bpe(self, token: str) -> str:
        """The pure-Python merge loop: `token`'s merged symbols, space-joined
        (uncached; `_merge_new` caches the ids)."""
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        return " ".join(word)

    def _syms(self, word: str) -> List[int]:
        return [self.encoder[c] for c in word[:-1]] + [self.encoder[word[-1] + "</w>"]]

    def _words(self, text: str) -> List[str]:
        """The text cleaned and split into words, each as byte-level symbols."""
        return ["".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
                for tok in _WORD_PAT.findall(_clean(text))]

    def _merge_new(self, words: Sequence[str]) -> None:
        """The merged ids of every word not seen before into the id cache: one
        call of the native core for all of them, else the Python loop per word."""
        cache = self._id_cache
        missing = [w for w in dict.fromkeys(words) if w not in cache]
        if missing and self.native is not None:
            cache.update(zip(missing, self.native.apply_batch([self._syms(w) for w in missing])))
        else:
            for w in missing:
                cache[w] = [self.encoder[t] for t in self.bpe(w).split(" ")]

    def encode(self, text: str) -> List[int]:
        words = self._words(text)
        self._merge_new(words)
        return [i for w in words for i in self._id_cache[w]]

    def decode(self, token_ids: Iterable[int]) -> str:
        # stop at the first eot: padding zeros after it are positional, and vocab
        # id 0 is a real token ('!'), so it must not be value-filtered
        ids: List[int] = []
        for t in token_ids:
            t = int(t)
            if t == self.eot:
                break
            if t != self.sot:
                ids.append(t)
        text = "".join(self.decoder.get(t, "") for t in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def tokenize(
        self,
        texts: Union[str, Sequence[str]],
        context_length: int = CONTEXT_LENGTH,
        truncate: bool = True,
    ) -> np.ndarray:
        """texts -> int32 (B, context_length), sot + tokens + eot, zero-padded. As
        clip.tokenize(..., truncate=True): on overflow the sequence is cut and the
        last slot forced to eot."""
        if isinstance(texts, str):
            texts = [texts]
        words = [self._words(text) for text in texts]
        self._merge_new([w for ws in words for w in ws])  # the batch's new words at once
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, (text, ws) in enumerate(zip(texts, words)):
            toks = [self.sot] + [t for w in ws for t in self._id_cache[w]] + [self.eot]
            if len(toks) > context_length:
                if not truncate:
                    raise RuntimeError(
                        f"Input {text!r} is too long for context length {context_length}"
                    )
                toks = toks[:context_length]
                toks[-1] = self.eot
            out[i, : len(toks)] = toks
        return out


@functools.lru_cache(maxsize=4)
def get_tokenizer(bpe_path: Optional[str] = None) -> ClipTokenizer:
    """A cached ClipTokenizer; with no `bpe_path`, FFVC_BPE_PATH (read at the first
    call) or the default file names."""
    return ClipTokenizer(bpe_path)

"""The port's CLIP tokenizer and text repair against the JAX package's.

The synthetic merge table of tests/test_tokenizer.py stands in for the release
vocabulary; the ids, the decoded text and the repaired text must be equal
(exact: both are integer and string code), also when the table is read from a
.txt.gz through FFVC_BPE_PATH. The port has the JAX package's pure-Python BPE
path only, so the JAX tokenizers here run that path (`_native = None`): the
optional native core splits a special-token string inside a prompt
("<|startoftext|>") into bytes, where the Python path (and CLIP's own
tokenizer) keeps it one token.
"""

import gzip

import numpy as np
import pytest

from feed_forward_vqgan_clip_tpu.tokenizer import bpe as jbpe
from feed_forward_vqgan_clip_tpu.tokenizer.text_fix import fix_text as j_fix_text
from feed_forward_vqgan_clip_tpu_torch.tokenizer import bpe
from feed_forward_vqgan_clip_tpu_torch.tokenizer.text_fix import fix_text

MERGES = [
    "h e",
    "l l",
    "he ll",
    "o</w> !</w>",
    "hell o</w>",
    "w o",
    "r l",
    "wo rl",
    "worl d</w>",
]
TEXTS = [
    "hello world",
    "Hello,   WORLD!",
    "héllo wörld 1234",
    "a photo of a cat",
    "it's the dog's toy, isn't it?",
    "cafÃ© doesnâ€™t",
    "nice 😀! ＡＢＣ",
    "&amp;lt;b&amp;gt; html",
    "<|startoftext|>hello<|endoftext|>",
    "under_score __ x",
    " ".join(["hello"] * 100),
]
# the text-repair cases of tests/test_tokenizer.py (TestTextFix)
REPAIRS = {
    "cafÃ©": "café",
    "SÃ£o Paulo": "São Paulo",
    "cafÃ\x83Â©": "café",
    "doesn’t": "doesn't",
    "doesn\x92t": "doesn't",
    "doesnâ€™t": "doesn't",
    "ＡＢＣ": "ABC",
    "é": "é",
    "a\x00b\x1b[31mc": "abc",
    "a\r\nb\rc": "a\nb\nc",
    "château én forêt": "château én forêt",
    "voilÃ !": "voilà!",
    "dÃ©jÃ  vu": "déjà vu",
    "donâ€\x1at": "don�t",
    "cafÃ© donâ€\x1at": "café don�t",
    "nice 😀!": "nice 😀!",
    "bad\ud800x": "bad�x",
    "cafÃ© 😀 donâ€™t": "café 😀 don't",
    "Ã\x83Â© donâ€\x1at": "é don�t",
    "ð\x9f\x98\x80 Ã\x83Â©": "😀 é",
}


def _jax_python_path(jtok):
    jtok._native = None
    return jtok


@pytest.fixture(scope="module")
def pair():
    return bpe.ClipTokenizer(merges=MERGES), _jax_python_path(jbpe.ClipTokenizer(merges=MERGES))


def test_vocab_layout_equals_jax(pair):
    tok, jtok = pair
    assert bpe.bytes_to_unicode() == jbpe.bytes_to_unicode()
    assert tok.encoder == jtok.encoder
    assert (tok.vocab_size, tok.sot, tok.eot) == (jtok.vocab_size, jtok.sot, jtok.eot)
    assert tok.vocab_size == 512 + len(MERGES) + 2


@pytest.mark.parametrize("text", TEXTS)
def test_ids_and_decode_equal_jax(pair, text):
    tok, jtok = pair
    ids = tok.encode(text)
    assert ids == jtok.encode(text)
    assert tok.decode(ids) == jtok.decode(ids)
    np.testing.assert_array_equal(tok.tokenize([text, "hello"]), jtok.tokenize([text, "hello"]))


def test_truncation_and_overflow_equal_jax(pair):
    tok, jtok = pair
    long = " ".join(["hello world"] * 60)
    arr = tok.tokenize(long, truncate=True)
    np.testing.assert_array_equal(arr, jtok.tokenize(long, truncate=True))
    assert arr.shape == (1, bpe.CONTEXT_LENGTH) and arr.dtype == np.int32
    assert arr[0, -1] == tok.eot
    with pytest.raises(RuntimeError):
        tok.tokenize(long, truncate=False)


@pytest.mark.parametrize("text,want", list(REPAIRS.items()))
def test_text_fix_equals_jax(text, want):
    assert fix_text(text) == j_fix_text(text) == want
    assert bpe._clean(text) == jbpe._clean(text)


def test_bpe_path_from_environment(tmp_path, monkeypatch):
    """FFVC_BPE_PATH names a gzipped table (a header line, then the merges): both
    packages read it and give the ids of the in-memory table."""
    path = tmp_path / "merges.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as fd:
        fd.write("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    monkeypatch.setenv("FFVC_BPE_PATH", str(path))
    bpe.get_tokenizer.cache_clear()
    jbpe.get_tokenizer.cache_clear()
    try:
        tok, jtok = bpe.get_tokenizer(), _jax_python_path(jbpe.get_tokenizer())
        assert tok.encoder == jtok.encoder
        mem = bpe.ClipTokenizer(merges=MERGES)
        for text in TEXTS:
            assert tok.encode(text) == jtok.encode(text) == mem.encode(text)
    finally:
        bpe.get_tokenizer.cache_clear()
        jbpe.get_tokenizer.cache_clear()


def test_missing_table_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("FFVC_BPE_PATH", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        bpe.ClipTokenizer()

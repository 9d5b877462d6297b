"""Mini-ftfy: the text-repair subset of `ftfy.fix_text` that CLIP's tokenizer
applies before BPE (clip/simple_tokenizer.py `basic_clean`).

The port's own copy of feed_forward_vqgan_clip_tpu/tokenizer/text_fix.py (the
port imports nothing of the JAX package); tests/test_torch_tokenizer.py holds
the two equal.

ftfy is not a dependency; this vendors the fixes that matter for
caption corpora, in ftfy's default order of operations:

  1. mojibake repair — UTF-8 bytes that were mis-decoded as windows-1252 /
     latin-1 ("doesnÃ¢â‚¬â„¢t" -> "doesn’t"), applied iteratively like ftfy's
     fix_encoding (double-mojibake needs two passes), gated on a conservative
     indicator pattern so correctly-encoded text is never touched;
  2. C1 control characters reinterpreted as windows-1252 (ftfy fix_c1_controls);
  3. line-break normalization (CRLF/CR/U+2028/U+2029 -> LF);
  4. terminal escapes + control-char removal (keeps \\n and \\t);
  5. halfwidth/fullwidth folding (ＡＢＣ -> ABC, ftfy fix_character_width);
  6. curly-quote uncurling (ftfy uncurl_quotes default);
  7. NFC normalization (ftfy's default normalization).

Long-tail repairs (ftfy's last three, round 4):

  8. byte-A0 restoration (ftfy restore_byte_a0) — mojibake whose 0xA0
     continuation bytes were flattened to plain spaces (cp1252 decodes 0xA0 as
     NBSP, which downstream text processing routinely converts to ' '): spaces
     sitting in UTF-8 continuation positions are restored to 0xA0 before the
     decode attempt ("voilÃ !" -> "voilà!");
  9. lossy-sequence replacement (ftfy replace_lossy_sequences) — mojibake
     whose continuation bytes were lost to a SUB character (0x1A, what lossy
     charset decoders emit for unmappable bytes): the whole broken sequence
     collapses to U+FFFD instead of poisoning the decode;
 10. surrogate repair (ftfy fix_surrogates) — UTF-16 surrogate codepoints
     leaked into a str (CESU-8 / buggy JSON decoders): pairs recombine into
     the astral character, lone surrogates become U+FFFD.

Mojibake repair is segmented at characters sloppy-1252 cannot encode (astral
emoji, CJK, …) — those are by construction already genuinely decoded, so they
bound the repairable spans the way ftfy's own segmentation does.

Remaining divergence from full ftfy (documented in PARITY.md): within one
encodable span the decode is all-or-nothing (ftfy sub-segments further, so a
span mixing raw latin-1 bytes WITH mojibake can still defeat the repair
here), and ftfy's trivia (Latin ligature expansion, lossy-flag heuristics
driven by its character tables) are out of scope for caption corpora.
"""

import re
import unicodedata

# UTF-8-as-1252 mojibake indicator: a mangled lead byte (Ã/Â/Ä/Å/â/ð as chars)
# followed by something from the windows-1252 high range's character images.
_W1252_HIGH = (
    "€‚ƒ„…†‡ˆ‰Š‹Œ"
    "Ž‘’“”•–—˜™š›"
    "œžŸ"
)
_MOJIBAKE_RE = re.compile(
    "[\xc2-\xc5\xe2\xf0][\x80-\xbf\xa0-\xff" + _W1252_HIGH + "]"
)
# altered-mojibake indicator: a mangled lead byte whose continuation image was
# flattened to a space (byte-A0 loss) or a SUB control (lossy decode). Gated
# the same way as _MOJIBAKE_RE — the repair only sticks if the repaired byte
# string decodes as UTF-8, which is the real filter.
_ALTERED_HINT_RE = re.compile("[\xc2-\xc5\xe2\xf0][ \x1a]")

# UTF-8 sequences whose 0xA0 continuation byte became a space (cp1252 maps
# 0xA0 -> NBSP; web pipelines flatten NBSP to ' '). Continuation-position
# spaces only — a space after a lead byte or between continuations; never a
# lone space. Mirrors ftfy's ALTERED_UTF8_RE.
_ALTERED_UTF8_RE = re.compile(
    b"[\xc2\xc3\xc5\xce\xd0-\xdf][ ]"
    b"|[\xe0-\xef][ ][\x80-\xbf]"
    b"|[\xe0-\xef][\x80-\xbf][ ]"
    b"|[\xe0-\xef][ ][ ]"
    b"|[\xf0-\xf4][ ][\x80-\xbf][\x80-\xbf]"
    b"|[\xf0-\xf4][\x80-\xbf][ ][\x80-\xbf]"
    b"|[\xf0-\xf4][\x80-\xbf][\x80-\xbf][ ]"
)
# UTF-8 sequences with a SUB (0x1A) where a continuation byte should be: the
# byte is unrecoverable, so the whole sequence collapses to one SUB, decoded
# later as U+FFFD. Mirrors ftfy's LOSSY_UTF8_RE.
_LOSSY_UTF8_RE = re.compile(
    b"[\xc2-\xdf][\x1a]"
    b"|[\xe0-\xef][\x1a][\x1a\x80-\xbf]"
    b"|[\xe0-\xef][\x80-\xbf][\x1a]"
    b"|[\xf0-\xf4][\x1a][\x1a\x80-\xbf][\x1a\x80-\xbf]"
    b"|[\xf0-\xf4][\x80-\xbf][\x1a][\x1a\x80-\xbf]"
    b"|[\xf0-\xf4][\x80-\xbf][\x80-\xbf][\x1a]"
)
_SURROGATE_RE = re.compile("[\ud800-\udfff]")
_SURROGATE_PAIR_RE = re.compile("[\ud800-\udbff][\udc00-\udfff]")
# runs sloppy-1252 can NOT encode (codepoint > 0xFF and not a cp1252 high-byte
# image): span boundaries for segmented mojibake repair
_NON1252_SPLIT_RE = re.compile("([^\x00-\xff" + _W1252_HIGH + "]+)")
_C1_RE = re.compile("[\x80-\x9f]")
_TERMINAL_ESCAPE_RE = re.compile(r"\x1b\[[0-9;]*[a-zA-Z]")
# controls except \t and \n (after line-break normalization)
_CONTROL_RE = re.compile("[\x00-\x08\x0b-\x1f\x7f]")
_CURLY = {"‘": "'", "’": "'", "“": '"', "”": '"'}
_LINE_BREAKS = {"\r\n": "\n", "\r": "\n", "\u2028": "\n", "\u2029": "\n", "\x85": "\n"}


def _encode_sloppy_1252(s: str) -> bytes:
    """Invert a windows-1252 mis-decode; like ftfy's sloppy-windows-1252, the
    26 codepoints 1252 leaves undefined fall back to their latin-1 bytes."""
    out = bytearray()
    for ch in s:
        try:
            out += ch.encode("cp1252")
        except UnicodeEncodeError:
            o = ord(ch)
            if o > 0xFF:
                raise
            out.append(o)
    return bytes(out)


def _decode_with_repairs(byts: bytes):
    """UTF-8 decode with the ftfy long-tail byte repairs: plain decode first;
    on failure restore flattened 0xA0 continuation bytes (spaces in
    continuation positions) and retry; then collapse SUB-lossy sequences to
    U+FFFD and retry. Returns None when nothing decodes."""
    try:
        return byts.decode("utf-8")
    except UnicodeDecodeError:
        pass
    restored = _ALTERED_UTF8_RE.sub(
        lambda m: m.group(0).replace(b" ", b"\xa0"), byts
    )
    if restored != byts:
        try:
            return restored.decode("utf-8")
        except UnicodeDecodeError:
            pass
    lossy = _LOSSY_UTF8_RE.sub(b"\x1a", restored)
    if lossy != restored:
        try:
            # each substituted SUB stands for a destroyed character
            return lossy.decode("utf-8").replace("\x1a", "�")
        except UnicodeDecodeError:
            pass
    return None


def _fix_mojibake_run(s: str) -> str:
    """ONE mojibake-repair pass on a sloppy-1252-encodable run (every char
    < 0x100 or a cp1252 high-byte image). The caller re-segments between
    passes: a repair can itself introduce chars >0xFF (U+FFFD from lossy
    replacement, a decoded astral char), which would make a second encode of
    the same span raise — re-splitting restores the encodable invariant."""
    if not (_MOJIBAKE_RE.search(s) or _ALTERED_HINT_RE.search(s)):
        return s
    fixed = _decode_with_repairs(_encode_sloppy_1252(s))
    return s if fixed is None else fixed


def _fix_mojibake(s: str) -> str:
    """Characters sloppy-1252 cannot encode (astral emoji, CJK, …) are by
    construction already genuinely decoded — they bound the repairable spans
    (ftfy-style segmentation), so "cafÃ© 😀" still repairs its latin span
    instead of aborting on the emoji. Segmentation is redone on EVERY pass
    (double-mojibake unwinds one layer per pass) because each pass can decode
    new >0xFF characters that must bound the next pass's spans."""
    for _ in range(3):
        if _MOJIBAKE_RE.search(s) is None and _ALTERED_HINT_RE.search(s) is None:
            return s
        pieces = _NON1252_SPLIT_RE.split(s)
        fixed = "".join(
            _fix_mojibake_run(p) if i % 2 == 0 else p
            for i, p in enumerate(pieces)
        )
        if fixed == s:
            break
        s = fixed
    return s


def _fix_surrogates(s: str) -> str:
    """UTF-16 surrogate codepoints leaked into a str (CESU-8 decoding, buggy
    JSON parsers, os.fsdecode surrogateescape): recombine pairs into the
    astral character, replace lone surrogates with U+FFFD (ftfy
    fix_surrogates semantics)."""
    if not _SURROGATE_RE.search(s):
        return s
    s = _SURROGATE_PAIR_RE.sub(
        lambda m: chr(
            0x10000
            + ((ord(m.group(0)[0]) - 0xD800) << 10)
            + (ord(m.group(0)[1]) - 0xDC00)
        ),
        s,
    )
    return _SURROGATE_RE.sub("�", s)


def _fix_c1(s: str) -> str:
    """Raw C1 controls are almost always windows-1252 that was decoded as
    latin-1 ("\\x92" -> right single quote)."""

    def repl(m):
        try:
            return bytes([ord(m.group(0))]).decode("cp1252")
        except UnicodeDecodeError:
            return m.group(0)

    return _C1_RE.sub(repl, s)


def _fold_width(s: str) -> str:
    out = []
    for ch in s:
        if "！" <= ch <= "｠" or "￠" <= ch <= "￦":
            out.append(unicodedata.normalize("NFKC", ch))
        else:
            out.append(ch)
    return "".join(out)


def fix_text(s: str) -> str:
    """ftfy.fix_text's caption-relevant subset; see module docstring."""
    # surrogates first: they make the string unencodable, which would mask a
    # co-occurring mojibake repair (no valid mojibake ever encodes >0xFF)
    s = _fix_surrogates(s)
    s = _fix_mojibake(s)
    s = _fix_c1(s)
    for k, v in _LINE_BREAKS.items():
        s = s.replace(k, v)
    s = _TERMINAL_ESCAPE_RE.sub("", s)
    s = _CONTROL_RE.sub("", s)
    s = _fold_width(s)
    for k, v in _CURLY.items():
        s = s.replace(k, v)
    return unicodedata.normalize("NFC", s)

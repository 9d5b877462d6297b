"""The port's data preparation against the JAX package's: CLIP preprocessing, the
folder and webdataset encoders (with a corrupt sample, the NIMA filter, the
spill and the prefetch thread), merge-features, `tokenize`, and the g++-built
BPE merge core.

Both packages read the same tiny CLIP torch file (the registry's `tiny`, numpy
draws) in float32 and the synthetic BPE table of tests/test_torch_serve.py.
Images are small PIL drawings written as JPEG or PNG. Tolerance: float32
features within 2e-4 * max(1, max |JAX|); preprocessing, tokens and merged
files exact.
"""

import io
import os
import random
import shutil
import string
import tarfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from feed_forward_vqgan_clip_tpu.data import encode as jenc
from feed_forward_vqgan_clip_tpu.data import tokenize_cli as jtok
from feed_forward_vqgan_clip_tpu.models import nima as jnima
from feed_forward_vqgan_clip_tpu.models.perceptor import load_perceptor as j_load_perceptor
from feed_forward_vqgan_clip_tpu.tokenizer.bpe import ClipTokenizer as JClipTokenizer
from feed_forward_vqgan_clip_tpu_torch import native
from feed_forward_vqgan_clip_tpu_torch.cli import build_parser
from feed_forward_vqgan_clip_tpu_torch.data import encode
from feed_forward_vqgan_clip_tpu_torch.models import nima
from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip
from feed_forward_vqgan_clip_tpu_torch.tokenizer.bpe import ClipTokenizer
from test_torch_serve import bpe_table  # noqa: F401
from test_torch_vitgan import assert_close, draw_

N_SAMPLES = 7


def _picture(i, size):
    """A drawing with structure (gradients and a block), not a flat tile."""
    w, h = size
    yy, xx = np.mgrid[0:h, 0:w]
    arr = np.stack([(xx * 255 // max(1, w - 1) + 37 * i) % 256,
                    (yy * 255 // max(1, h - 1) + 91 * i) % 256,
                    ((xx + yy + 13 * i) * 3) % 256], -1).astype(np.uint8)
    arr[h // 4:h // 2, w // 3:w // 2] = (200, 30 * i % 256, 90)
    return Image.fromarray(arr)


def _jpeg(i, size=(48, 40), fmt="JPEG"):
    buf = io.BytesIO()
    _picture(i, size).save(buf, fmt)
    return buf.getvalue()


def _caption(i):
    return f"hello world {i} hell o"


@pytest.fixture
def clip_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("clip") / "tiny_clip.pt"
    sd = draw_(make_clip("tiny", image=True), 11)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return str(path)


@pytest.fixture
def f32(monkeypatch):
    """Both packages' encoders with their perceptor in float32 (the default is
    bfloat16), the port's on the CPU."""
    monkeypatch.setattr(jenc, "load_perceptor",
                        lambda name, path: j_load_perceptor(name, path, dtype=jnp.float32))
    load = encode.load_perceptor
    monkeypatch.setattr(encode, "load_perceptor",
                        lambda *a, **k: load(*a, **{**k, "dtype": torch.float32}))


def _shards(folder, counts=(4, 3), corrupt=1):
    """Webdataset tars of JPEG/caption samples in order; sample `corrupt` of the
    first tar has undecodable image bytes."""
    i = 0
    for t, n in enumerate(counts):
        with tarfile.open(folder / f"shard-{t:03d}.tar", "w") as tf:
            for _ in range(n):
                img = b"\xff\xd8 not a jpeg" if i == corrupt else _jpeg(i)
                for name, data in ((f"{i:05d}.input.jpg", img),
                                   (f"{i:05d}.output.txt", _caption(i).encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
                i += 1
    return str(folder / "shard-*.tar")


def _pairs(path):
    return encode._load_pairs(path)


# ------------------------------------------------------------------ preprocessing


@pytest.mark.parametrize("size,mode", [((48, 40), "RGB"), ((300, 225), "RGB"),
                                       ((31, 77), "L"), ((64, 64), "RGBA")])
def test_preprocess_image_is_byte_equal_to_jax(size, mode):
    img = Image.open(io.BytesIO(_jpeg(3, size, "PNG"))).convert(mode)
    for target in (224, 32):
        got = encode.preprocess_image(img, target)
        want = jenc.preprocess_image(img, target)
        assert got.dtype == want.dtype == np.float32 and got.shape == (target, target, 3)
        assert got.tobytes() == want.tobytes()


# ------------------------------------------------------------------ encoders


def test_folder_encoder_matches_jax(bpe_table, clip_file, f32, tmp_path):  # noqa: F811
    folder = tmp_path / "pairs"
    folder.mkdir()
    for i in range(5):
        (folder / f"{i:03d}.jpg").write_bytes(_jpeg(i))
        (folder / f"{i:03d}.txt").write_text(_caption(i))
    got = encode.encode_text_and_images(str(folder), out=str(tmp_path / "port.npz"),
                                        clip_model="tiny", clip_path=clip_file, batch_size=2,
                                        device="cpu")
    want = jenc.encode_text_and_images(str(folder), out=str(tmp_path / "jax.npz"),
                                       clip_model="tiny", clip_path=clip_file, batch_size=2)
    for g, w in zip(_pairs(got), _pairs(want)):
        assert g.shape == (5, 32)
        assert_close(g, w)


def test_webdataset_encoder_matches_jax(bpe_table, clip_file, f32, tmp_path):  # noqa: F811
    pattern = _shards(tmp_path)
    got = encode.encode_text_and_images_webdataset(
        pattern, clip_model="tiny", clip_path=clip_file, batch_size=3,
        out=str(tmp_path / "port.npz"), device="cpu")
    want = jenc.encode_text_and_images_webdataset(
        pattern, clip_model="tiny", clip_path=clip_file, batch_size=3,
        out=str(tmp_path / "jax.npz"))
    (gx, gy), (wx, wy) = _pairs(got), _pairs(want)
    assert gx.shape == gy.shape == (N_SAMPLES - 1, 32)  # the corrupt sample skipped
    assert_close(gx, wx)
    assert_close(gy, wy)
    # row order: each row is its own sample's text, encoded alone
    p = encode.load_perceptor("tiny", clip_file, dtype=torch.float32, device="cpu")
    toks = encode.get_tokenizer().tokenize([_caption(i) for i in (0, 2, 6)], truncate=True)
    with torch.no_grad():
        alone = p.encode_text(torch.from_numpy(toks).long()).numpy()
    assert_close(gx[[0, 1, 5]], alone)


def _nima_file(tmp_path):
    """A NIMA on the InceptionV3 trunk (which resizes any input to 299 px), numpy
    draws with the head scaled up, in pyiqa's key names."""
    from test_torch_nima import _draws

    port = nima.NIMA("inception_v3").eval()
    sd = _draws(port, 12)
    sd["classifier.weight"] = sd["classifier.weight"] * 8
    path = tmp_path / "nima.pth"
    torch.save({(f"base_model.{k[len('backbone.'):]}" if k.startswith("backbone.") else k):
                torch.from_numpy(v) for k, v in sd.items()}, path)
    return str(path)


def test_webdataset_nima_filter_keeps_what_jax_keeps(bpe_table, clip_file, f32,  # noqa: F811
                                                     tmp_path):
    """The threshold sits in the widest gap of the port's scores, so no score of
    either package lies within 1e-4 of it; both keep the same rows."""
    pattern = _shards(tmp_path, counts=(3, 3), corrupt=-1)
    weights = _nima_file(tmp_path)
    imgs = np.stack([encode.preprocess_image(Image.open(io.BytesIO(_jpeg(i))), 32)
                     for i in range(6)])
    x01 = imgs * np.asarray(encode.CLIP_STD, np.float32) + np.asarray(encode.CLIP_MEAN,
                                                                      np.float32)
    with torch.no_grad():
        scores = nima.make_nima_fn(weights, device="cpu")(torch.from_numpy(x01)).numpy()
    jscores = np.asarray(jnima.make_nima_fn(weights)(jnp.asarray(x01)))
    s = np.sort(scores)
    gap = int(np.argmax(np.diff(s[1:-1]))) + 1
    threshold = float((s[gap] + s[gap + 1]) / 2)
    assert np.abs(scores - threshold).min() > 1e-4 and np.abs(jscores - threshold).min() > 1e-4
    keep = scores >= threshold
    assert 0 < keep.sum() < 6 and np.array_equal(keep, jscores >= threshold)
    kw = dict(clip_model="tiny", clip_path=clip_file, batch_size=4,
              image_quality_threshold=threshold, nima_weights_path=weights)
    got = encode.encode_text_and_images_webdataset(pattern, out=str(tmp_path / "port.npz"),
                                                   device="cpu", **kw)
    want = jenc.encode_text_and_images_webdataset(pattern, out=str(tmp_path / "jax.npz"), **kw)
    (gx, gy), (wx, wy) = _pairs(got), _pairs(want)
    assert len(gx) == len(wx) == int(keep.sum())
    assert_close(gx, wx)
    assert_close(gy, wy)


def test_webdataset_quality_threshold_without_weights_warns(  # noqa: F811
        bpe_table, clip_file, tmp_path, caplog, monkeypatch):
    monkeypatch.delenv("FFVC_NIMA_WEIGHTS", raising=False)
    out = encode.encode_text_and_images_webdataset(
        _shards(tmp_path), clip_model="tiny", clip_path=clip_file, batch_size=4,
        out=str(tmp_path / "f.npz"), image_quality_threshold=5.0, device="cpu")
    assert "no NIMA weights" in caplog.text and len(_pairs(out)[0]) == N_SAMPLES - 1


@pytest.mark.parametrize("variant", ["spill", "sequential", "torch_format"])
def test_webdataset_variants_equal_the_default(variant, bpe_table, clip_file,  # noqa: F811
                                               tmp_path):
    """Spilling every 2 rows, no prefetch thread, or a torch-format output give
    the default run's features, bitwise."""
    pattern = _shards(tmp_path)
    kw = dict(clip_model="tiny", clip_path=clip_file, batch_size=3, device="cpu")
    base = encode.encode_text_and_images_webdataset(pattern, out=str(tmp_path / "a.npz"), **kw)
    extra = {"spill": dict(spill_rows=2), "sequential": dict(prefetch=False),
             "torch_format": {}}[variant]
    out = str(tmp_path / ("b.pt" if variant == "torch_format" else "b.npz"))
    got = encode.encode_text_and_images_webdataset(pattern, out=out, **kw, **extra)
    for g, w in zip(_pairs(got), _pairs(base)):
        np.testing.assert_array_equal(g, w)
    assert not [f for f in os.listdir(tmp_path) if "spill" in f or "merge_tmp" in f]


def test_webdataset_process_split(bpe_table, clip_file, tmp_path, monkeypatch):  # noqa: F811
    """Process 1 of 2 encodes the odd shards into its own `_1` file."""
    pattern = _shards(tmp_path, counts=(2, 3), corrupt=-1)
    monkeypatch.setattr(encode, "process_split", lambda: (1, 2))
    out = encode.encode_text_and_images_webdataset(
        pattern, clip_model="tiny", clip_path=clip_file, batch_size=4,
        out=str(tmp_path / "f.npz"), device="cpu")
    assert out == str(tmp_path / "f.npz") and not os.path.exists(out)
    x, _ = _pairs(str(tmp_path / "f_1.npz"))
    assert len(x) == 3
    monkeypatch.undo()
    assert encode.process_split() == (0, 1)


# ------------------------------------------------------------------ merge-features


@pytest.mark.parametrize("fmt", [".npz", ".pkl"])
def test_merge_features_matches_jax(fmt, tmp_path):
    rng = np.random.default_rng(0)
    parts = []
    for r in range(3):
        x = rng.normal(size=(4 + r, 8)).astype(np.float32)
        y = rng.normal(size=(4 + r, 6)).astype(np.float32)
        encode._save_pairs(str(tmp_path / f"features_{r}{fmt}"), x, y)
        parts.append((x, y))
    pattern = str(tmp_path / f"features_*{fmt}")
    run = build_parser().parse_args(["merge-features", pattern, "--out",
                                     str(tmp_path / f"port{fmt}")])
    run.fn(run)
    want = jenc.merge_features(pattern, str(tmp_path / f"jax{fmt}"))
    (gx, gy), (wx, wy) = _pairs(str(tmp_path / f"port{fmt}")), _pairs(want)
    for g, w, j in ((gx, wx, 0), (gy, wy, 1)):
        np.testing.assert_array_equal(g, np.concatenate([p[j] for p in parts]))
        np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError):
        encode.merge_features(str(tmp_path / "none_*.npz"), str(tmp_path / "x.npz"))


# ------------------------------------------------------------------ tokenize, BPE

MERGES = ["h e", "l l", "he ll", "hell o</w>", "w o", "r l", "wo rl", "worl d</w>",
          "a b", "ab c", "abc d", "c d</w>", "e f</w>", "ab e"]


@pytest.mark.parametrize("source,out,extra", [
    ("lines", "t.npz", []), ("lines", "t.pt", ["--max-length", "12", "--batch-size", "2"]),
    ("glob", "t.npz", ["--batch-size", "3"])])
def test_tokenize_writes_what_jax_writes(source, out, extra, bpe_table, tmp_path):  # noqa: F811
    lines = ["hello world", "abcd ef", "héllo wörld 🐈", "a" * 100, "", "hello hello"]
    if source == "lines":
        src = tmp_path / "prompts.txt"
        src.write_text("\n".join(lines) + "\n")
        src = str(src)
    else:
        for i, t in enumerate(lines):
            (tmp_path / f"p{i}.txt").write_text(t + "\n")
        src = str(tmp_path / "p*.txt")
    args = build_parser().parse_args(["tokenize", src, "--out", str(tmp_path / f"port_{out}"),
                                      *extra])
    args.fn(args)
    ml = int(extra[extra.index("--max-length") + 1]) if "--max-length" in extra else None
    bs = int(extra[extra.index("--batch-size") + 1]) if "--batch-size" in extra else None
    jtok.tokenize(src, out=str(tmp_path / f"jax_{out}"), max_length=ml, batch_size=bs)
    if out.endswith(".npz"):
        with np.load(tmp_path / f"port_{out}") as g, np.load(tmp_path / f"jax_{out}") as w:
            np.testing.assert_array_equal(g["tokens"], w["tokens"])
            assert g["tokens"].dtype == w["tokens"].dtype
    else:
        got, want = (torch.load(tmp_path / f"{side}_{out}") for side in ("port", "jax"))
        assert torch.equal(got, want)


@pytest.fixture(scope="module")
def tokenizers():
    """(port native, port pure Python, JAX native); the core must build where
    g++ is installed."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native BPE core cannot be built here")
    port = ClipTokenizer(merges=MERGES)
    assert port.native is not None, "the g++ build of the BPE core failed"
    jax_native = JClipTokenizer(merges=MERGES)
    assert jax_native._native is not None
    pure = ClipTokenizer(merges=MERGES)
    pure.native = None  # the pure-Python merge loop
    return port, pure, jax_native


def _fuzz(seed, n):
    rng = random.Random(seed)
    alphabet = "abcdefhlorw é🐈" + string.punctuation[:6]
    return ["".join(rng.choice(alphabet) for _ in range(rng.randint(1, 40))) for _ in range(n)]


@pytest.mark.parametrize("kind", ["known", "fuzz", "unicode"])
def test_native_core_equals_python_and_jax(kind, tokenizers):
    port, pure, jax_native = tokenizers
    texts = {"known": ["hello", "world", "abcd", "abe", "xyz", "a", "abcabc", "ef"],
             "fuzz": _fuzz(0, 300),
             "unicode": ["héllo wörld", "🐈 abc", "ab cd", string.punctuation, "日本語 テキスト",
                         "naïve café ｆｕｌｌ"]}[kind]
    for t in texts:
        assert port.encode(t) == pure.encode(t) == jax_native.encode(t), repr(t)
    np.testing.assert_array_equal(port.tokenize(texts), pure.tokenize(texts))


def test_native_core_keeps_the_special_tokens_whole(tokenizers):
    """A literal <|startoftext|> in a text is one id, as on the JAX package's
    pure-Python path (its native core splits it into bytes)."""
    port, pure, _ = tokenizers
    jax_pure = JClipTokenizer(merges=MERGES)
    jax_pure._native = None
    text = "<|startoftext|>hello<|endoftext|> abcd"
    assert port.encode(text) == pure.encode(text) == jax_pure.encode(text)
    assert port.encode(text)[0] == port.sot


def test_native_core_builds_once_keyed_by_its_source(tokenizers):
    lib = native.get_lib()
    assert lib is not None and native.get_lib() is lib
    built = [f for f in os.listdir(native.BUILD_DIR) if f.startswith("libbpe_core_")]
    assert any(f.endswith(".so") for f in built)


def test_native_build_failure_falls_back_with_one_warning(monkeypatch, caplog, tmp_path):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on the path
    tok = ClipTokenizer(merges=MERGES)
    ClipTokenizer(merges=MERGES)
    assert tok.native is None
    assert caplog.text.count("native BPE core not built") == 1
    pure = ClipTokenizer(merges=MERGES)
    pure.native = None
    assert tok.encode("hello world") == pure.encode("hello world")

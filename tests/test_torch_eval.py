"""The port's offline evaluation against the JAX package's, on the CPU:
InceptionV3 features (models/inception.py), the Frechet distance (eval/fid.py)
and `evaluate` end to end (eval/evaluate.py, `cli evaluate`).

InceptionV3 weights are numpy draws in torchvision's names (kernels
N(0, 2/fan_in), BatchNorm statistics and affines near identity) read by the
port's `make_inception_fn` and by JAX `convert_inception`, at 75-px inputs (resized
to 299 inside). `evaluate` runs on one tiny float32 Mixer `.th` whose config
names a tiny CLIP file and a taming VQGAN checkpoint, so both packages load the
same weights; the eval perceptor is that CLIP file too.

Tolerances: features float32 within 2e-4 of max(1, max |JAX|); the Frechet
distance within 1e-6 relative; per-prompt CLIP scores (logit scale x cosine)
with the eval perceptor in float32 (both packages' loader patched) within 2e-4
of max(1, max |JAX score|), and in bfloat16 (as `evaluate` loads it) within
1e-2 of the logit scale, a cosine within 1e-2: the tiny CLIP's bf16 rounding
moves each package's cosines by up to 4.6e-3 from their float32 values, read
2.7e-3 apart between the two.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.eval import evaluate as jevaluate
from feed_forward_vqgan_clip_tpu.eval.fid import frechet_distance as j_frechet_distance
from feed_forward_vqgan_clip_tpu.io.torch_import import convert_inception
from feed_forward_vqgan_clip_tpu.models import inception as j_inception
from feed_forward_vqgan_clip_tpu.models.inception import InceptionV3Features as JInception
from feed_forward_vqgan_clip_tpu_torch import cli
from feed_forward_vqgan_clip_tpu_torch.data.datasets import save_tokens
from feed_forward_vqgan_clip_tpu_torch.eval import evaluate
from feed_forward_vqgan_clip_tpu_torch.eval.fid import frechet_distance
from feed_forward_vqgan_clip_tpu_torch.io import checkpoint
from feed_forward_vqgan_clip_tpu_torch.models import inception
from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import load_perceptor
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import make_vqgan
from test_torch_serve import CFG, TINY_VQ, _mapper, bpe_table  # noqa: F401 (a fixture)
from test_torch_train_step import _tokens


def inception_state_dict(seed):
    """torchvision inception_v3 names and shapes (with the fc, AuxLogits and
    num_batches_tracked entries a torchvision file holds), numpy draws."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in inception.InceptionV3Features().state_dict().items():
        if k.endswith("conv.weight"):
            a = rng.normal(size=v.shape) * np.sqrt(2.0 / np.prod(v.shape[1:]))
        elif k.endswith(("bn.weight", "bn.running_var")):
            a = 1.0 + 0.1 * np.abs(rng.normal(size=v.shape))
        else:
            a = 0.1 * rng.normal(size=v.shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    return sd


def test_inception_features_match_jax(tmp_path):
    sd = inception_state_dict(0)
    torch.save(sd, tmp_path / "inception.pth")
    model = inception.make_inception_fn(str(tmp_path / "inception.pth"), dtype=torch.float32,
                                        device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    x = np.random.default_rng(1).uniform(size=(2, 75, 75, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    params = convert_inception({k: v.numpy() for k, v in sd.items()})
    want = np.asarray(JInception(dtype=jnp.float32).apply(params, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 2048) and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= 2e-4 * max(1.0, float(np.abs(want).max()))


def test_inception_random_init_is_seeded_and_folded():
    a, b = (inception.make_inception_fn(None, dtype=torch.float32, device="cpu", seed=3)
            for _ in range(2))
    conv = a.Conv2d_1a_3x3
    assert torch.equal(conv.w_fold, b.Conv2d_1a_3x3.w_fold)
    torch.testing.assert_close(conv.w_fold, conv.conv.weight / np.sqrt(1.0 + inception.BN_EPS))
    with torch.no_grad():
        assert inception.make_inception_fn(None, device="cpu")(
            torch.rand(1, 80, 80, 3)).shape == (1, 2048)


@pytest.mark.parametrize("n,d", [(50, 8), (6, 16)])
def test_frechet_distance_matches_jax(n, d):
    """A full-rank case, and one with fewer samples than dims (singular
    covariances, the eps-offset fallback's ground)."""
    rng = np.random.default_rng(n)
    a, b = rng.normal(size=(n, d)), rng.normal(1.0, 2.0, size=(n + 3, d))
    got, want = frechet_distance(a, b), j_frechet_distance(a, b)
    assert np.isfinite(got) and abs(got - want) <= 1e-6 * abs(want)


@pytest.fixture
def eval_model(tmp_path):
    """A tiny Mixer `.th` whose config names a tiny CLIP file (both towers) and a
    taming VQGAN checkpoint, and a token file of 6 prompts."""
    clip = make_clip("tiny", device="cpu", image=True).init_random_(
        torch.Generator().manual_seed(0))
    torch.save(clip.state_dict(), tmp_path / "clip.pt")
    vq = make_vqgan(TINY_VQ).init_random_(torch.Generator().manual_seed(1))
    torch.save({"state_dict": vq.state_dict()}, tmp_path / "vq.ckpt")
    cfg = dict(CFG, clip_model_path=str(tmp_path / "clip.pt"),
               vqgan_checkpoint=str(tmp_path / "vq.ckpt"), batch_size=4)
    run = tmp_path / "run"
    run.mkdir()
    path = checkpoint.save_model(str(run / "model.th"), _mapper(cfg, 2), cfg)
    toks = str(tmp_path / "prompts.npz")
    save_tokens(_tokens(6), toks)
    return path, toks, str(tmp_path / "clip.pt")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_evaluate_matches_jax(eval_model, tmp_path, monkeypatch, dtype):
    """Both packages' `evaluate` on the same files, nb_test 5 of 6 prompts (the
    seeded draw), batches of 4, FID against seeded "real" features through the
    same Inception weights: per-prompt CLIP scores, the JSON keys, finite values;
    in float32 (perceptor and Inception) also the FID, renders resized to 299 px
    and features gathered over both batches."""
    path, toks, clip_path = eval_model
    if dtype == "float32":
        j_load, t_load = jevaluate.load_perceptor, evaluate.load_perceptor
        monkeypatch.setattr(jevaluate, "load_perceptor",
                            lambda *a, **k: j_load(*a, dtype=jnp.float32))
        monkeypatch.setattr(evaluate, "load_perceptor",
                            lambda *a, **k: t_load(*a, dtype=torch.float32, **k))
        j_inc, t_inc = j_inception.make_inception_fn, evaluate.make_inception_fn
        monkeypatch.setattr(j_inception, "make_inception_fn",
                            lambda p: j_inc(p, dtype=jnp.float32))
        monkeypatch.setattr(evaluate, "make_inception_fn",
                            lambda p, **k: t_inc(p, dtype=torch.float32, **k))
    torch.save(inception_state_dict(2), tmp_path / "inception.pth")
    real = tmp_path / "real.npy"
    np.save(real, np.random.default_rng(3).normal(size=(12, 2048)).astype(np.float32))
    kw = dict(nb_test=5, clip_model="tiny", clip_model_path=clip_path, compute_fid=True,
              inception_features_real_path=str(real),
              inception_weights_path=str(tmp_path / "inception.pth"))
    want = jevaluate.evaluate(path, toks, out_folder=str(tmp_path / "jax"), **kw)
    got = evaluate.evaluate(path, toks, out_folder=str(tmp_path / "port"), device="cpu", **kw)
    assert sorted(got) == sorted(want) == sorted([
        "clip_score_mean", "clip_score_std", "clip_score_atleast_25", "fid_real.npy"])
    assert all(np.isfinite(v) for v in got.values())
    name = "eval_prompts.npz_tiny"
    s_got = np.load(tmp_path / "port" / f"{name}.npy")
    s_want = np.load(tmp_path / "jax" / f"{name}.npy")
    assert s_got.shape == s_want.shape == (5,)
    err = float(np.abs(s_got - s_want).max())
    if dtype == "float32":
        assert err <= 2e-4 * max(1.0, float(np.abs(s_want).max()))
        # 1e-5 relative: the two read 5e-8 apart; one batch dropped moves the FID
        # 8e-3, an align_corners resize to 299 px 5e-4
        assert abs(got["fid_real.npy"] - want["fid_real.npy"]) <= 1e-5 * abs(want["fid_real.npy"])
    else:
        assert err <= 1e-2 * float(np.exp(4.6052))  # the tiny CLIP's logit scale
    assert torch.equal(torch.load(tmp_path / "port" / f"{name}.th"), torch.tensor(s_got))
    with open(tmp_path / "port" / f"{name}.json") as fd:
        assert json.load(fd) == got


def test_evaluate_defaults_and_images(eval_model, bpe_table, tmp_path):  # noqa: F811
    """Artifacts in the model's folder, the config's batch size, image grids with
    caption sidecars; a pair file scores its input features against the images."""
    path, toks, clip_path = eval_model
    out = evaluate.evaluate(path, toks, save_images=True, clip_model="tiny",
                            clip_model_path=clip_path, device="cpu")
    run = tmp_path / "run"
    folder = run / "eval_prompts.npz_tiny_images"
    assert sorted(p.name for p in folder.iterdir()) == [
        "batch_0000000000.png", "batch_0000000000.txt", "batch_0000000001.png",
        "batch_0000000001.txt"]
    assert len((folder / "batch_0000000001.txt").read_text().splitlines()) == 2
    assert (run / "eval_prompts.npz_tiny.json").exists() and "fid" not in str(out)
    feats = load_perceptor("tiny", clip_path, device="cpu").encode_text(
        torch.from_numpy(_tokens(6)).long()).float().numpy()
    pairs = str(tmp_path / "pairs.npz")
    np.savez(pairs, x=feats, y=feats)
    scores = evaluate.evaluate(path, pairs, clip_model="tiny", clip_model_path=clip_path,
                               device="cpu")
    assert np.isfinite(list(scores.values())).all()
    with pytest.raises(ValueError, match="inception_features_real_path"):
        evaluate.evaluate(path, toks, compute_fid=True, clip_model="tiny",
                          clip_model_path=clip_path, device="cpu")


def test_cli_evaluate_runs_on_the_cpu(eval_model, tmp_path):
    path, toks, clip_path = eval_model
    cli.main(["evaluate", path, toks, "--clip-model", "tiny", "--clip-model-path", clip_path,
              "--batch-size", "3", "--clip-threshold", "0", "--out-folder",
              str(tmp_path / "cli"), "--device", "cpu"])
    with open(tmp_path / "cli" / "eval_prompts.npz_tiny.json") as fd:
        out = json.load(fd)
    assert sorted(out) == ["clip_score_atleast_0.0", "clip_score_mean", "clip_score_std"]

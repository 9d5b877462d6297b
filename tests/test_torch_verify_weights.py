"""verify-weights and download-weights, offline.

A tiny mapper `.th` written by the port, under a released mapper's file name,
with its CLIP and VQGAN as weight files its config names and a companion prior
`.th` of the released prior's name, so that both packages' Generators load the
same weights:

  * the port's golden round trip (written, then matched), a perturbed mapper
    weight reported as a mismatch, absent models reported, the CLI's exit code;
  * across packages: goldens written by the JAX package's verify_weights
    verify in the port within `atol`, and the port's in the JAX package;
  * ops/jax_random.py against jax.random: the uniform and the bits bitwise,
    the normal within 1e-4 (XLA's erfinv);
  * download-weights from `file://` URLs of a monkeypatched registry.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu import download_weights as j_download_weights
from feed_forward_vqgan_clip_tpu import registry as j_registry
from feed_forward_vqgan_clip_tpu import verify_weights as j_verify_weights
from feed_forward_vqgan_clip_tpu_torch import cli, download_weights, registry, verify_weights
from feed_forward_vqgan_clip_tpu_torch.io import checkpoint
from feed_forward_vqgan_clip_tpu_torch.models import flow
from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import make_vqgan
from feed_forward_vqgan_clip_tpu_torch.ops import jax_random
from test_torch_flow import random_prior
from test_torch_serve import CFG, TINY_VQ, _mapper, bpe_table  # noqa: F401
from test_torch_vitgan import draw_

MAPPER = "cc12m_32x1024_mlp_mixer_clip_ViTB32_256x256_v0.3.th"
PRIOR = registry.PRIOR_MODELS[MAPPER]


@pytest.fixture
def weights(tmp_path, bpe_table):  # noqa: F811
    """-> the weights folder: the mapper and its prior under the zoo's names."""
    folder = tmp_path / "weights"
    folder.mkdir()
    clip_path = folder / "tiny_clip.pt"
    torch.save({k: torch.from_numpy(v) for k, v in draw_(make_clip("tiny", image=True),
                                                         11).items()}, clip_path)
    vq = make_vqgan(TINY_VQ)
    sd = {k: torch.from_numpy(v) for k, v in draw_(vq, 12).items()}
    # a codebook of the mapper's spread (its latents N(0, 0.1^2)), so that its
    # output picks many codes, and a gentler output layer, so that the renders
    # do not saturate: the images show the mapper
    sd["quantize.embedding.weight"] = torch.from_numpy(
        0.1 * np.random.default_rng(5).normal(size=(32, 8)).astype(np.float32))
    sd["decoder.conv_out.weight"] *= 0.2
    torch.save({"state_dict": sd}, folder / "vq.ckpt")
    cfg = dict(CFG, clip_model_path=str(clip_path), vqgan_checkpoint=str(folder / "vq.ckpt"))
    checkpoint.save_model(str(folder / MAPPER), _mapper(CFG, 0), cfg)
    port_flow, pcfg = random_prior(32, 32, 2, 3)
    flow.save_prior(str(folder / PRIOR), port_flow, pcfg)
    return folder


def _perturb(t):
    """t plus noise of its own scale (a constant shift would vanish in the next
    LayerNorm or the VQ's nearest code)."""
    t += t.std() * torch.randn(t.shape, generator=torch.Generator().manual_seed(0))


def _verify(pkg, weights_dir, tmp_path, models=None, **kw):
    return pkg.verify_weights(str(weights_dir), models=models or [MAPPER],
                              goldens_dir=str(tmp_path / "goldens"),
                              out=str(tmp_path / "report.json"), **kw)


def test_golden_round_trip_and_perturbed_weight(weights, tmp_path):
    r1 = _verify(verify_weights, weights, tmp_path, device="cpu")
    assert r1["models"][MAPPER]["status"] == "golden_written"
    golden = dict(np.load(tmp_path / "goldens" / f"{MAPPER}.npz"))
    assert sorted(golden) == ["fixed_z_sha", "fixed_z_thumb", "prior_sample", "prior_sha",
                              "prior_thumb", "prompt_sha", "prompt_thumb", "text_embed"]
    assert golden["prompt_thumb"].shape == (2, 32, 32, 3)
    r2 = _verify(verify_weights, weights, tmp_path, device="cpu")
    assert r2["models"][MAPPER]["status"] == "ok"
    assert all(p["status"] == "match" for p in r2["models"][MAPPER]["probes"].values())
    with open(tmp_path / "report.json") as fd:
        assert json.load(fd)["summary"] == {"ok": 1, "fail": 0, "absent": 0, "atol": 2e-2}

    path = str(weights / MAPPER)
    obj = torch.load(path, weights_only=False)
    _perturb(obj["state_dict"]["final_proj.weight"])
    torch.save(obj, path)
    r3 = _verify(verify_weights, weights, tmp_path, device="cpu")
    probes = r3["models"][MAPPER]["probes"]
    assert r3["models"][MAPPER]["status"] == "FAIL" and r3["summary"]["fail"] == 1
    assert probes["prompt_thumb"]["status"] == "mismatch"
    assert probes["fixed_z_thumb"]["status"] == "match"  # the VQGAN alone did not change


def test_absent_models_are_reported(tmp_path):
    r = verify_weights.verify_weights(str(tmp_path / "nowhere"), goldens_dir=str(tmp_path / "g"),
                                      out=str(tmp_path / "r.json"), device="cpu")
    assert r["summary"]["absent"] == len(r["models"]) == len(registry.RELEASED_MODELS)
    assert r["summary"]["fail"] == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_goldens_carry_across_packages(weights, tmp_path, writer):
    """Goldens one package writes verify in the other within the default atol;
    the fixed-z probe (JAX's own uniform draw) to float32 rounding."""
    first, second = (j_verify_weights, verify_weights)
    if writer == "port":
        first, second = second, first
    kw = lambda pkg: {"device": "cpu"} if pkg is verify_weights else {}  # noqa: E731
    assert _verify(first, weights, tmp_path, update_goldens=True,
                   **kw(first))["models"][MAPPER]["status"] == "golden_written"
    report = _verify(second, weights, tmp_path, **kw(second))["models"][MAPPER]
    assert report["status"] == "ok", report
    assert set(report["probes"]) >= {"text_embed", "fixed_z_thumb", "prompt_thumb",
                                     "prior_sample", "prior_thumb"}
    assert report["probes"]["fixed_z_thumb"]["max_abs_diff"] <= 1e-5


def test_cli_verify_weights_exit_code(weights, tmp_path):
    argv = ["verify-weights", "--weights-dir", str(weights), "--models", MAPPER,
            "--goldens-dir", str(tmp_path / "g"), "--out", str(tmp_path / "r.json"),
            "--device", "cpu"]
    cli.main(argv)
    cli.main(argv[:1] + ["--update-goldens"] + argv[1:])
    path = str(weights / MAPPER)
    obj = torch.load(path, weights_only=False)
    _perturb(obj["state_dict"]["final_proj.weight"])
    torch.save(obj, path)
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 1


@pytest.mark.parametrize("shape", [(5,), (1, 4, 4, 8), (1, 16, 16, 256), (2, 3, 7)])
def test_jax_random_draws(shape):
    key = jax.random.PRNGKey(verify_weights.Z_SEED)
    np.testing.assert_array_equal(jax_random.random_bits(verify_weights.Z_SEED, shape),
                                  np.asarray(jax.random.bits(key, shape)))
    np.testing.assert_array_equal(jax_random.uniform(verify_weights.Z_SEED, shape),
                                  np.asarray(jax.random.uniform(key, shape)))
    np.testing.assert_allclose(jax_random.normal(verify_weights.Z_SEED, shape),
                               np.asarray(jax.random.normal(key, shape)), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(jax_random.uniform(7, shape, -2.0, 3.0), np.asarray(
        jax.random.uniform(jax.random.PRNGKey(7), shape, minval=-2.0, maxval=3.0)))


def test_registry_urls_equal_jax():
    assert registry.MODEL_URLS == j_registry.MODEL_URLS
    assert registry.AUX_URLS == j_registry.AUX_URLS
    assert registry.BPE_URL == j_download_weights.BPE_URL


def test_download_weights_from_file_urls(tmp_path, monkeypatch):
    """Every file fetched from a `file://` URL under its zoo name, no `.part`
    left; a second run skips the files that are there; the CLI runs it."""
    src = tmp_path / "src"
    src.mkdir()
    urls = {}
    for i, name in enumerate(["a.th", "prior_b.th", "vq.yaml", "vq.ckpt", "bpe.txt.gz"]):
        (src / f"remote_{name}").write_bytes(bytes([i]) * (100 + i))
        urls[name] = (src / f"remote_{name}").as_uri()
    monkeypatch.setattr(download_weights, "MODEL_URLS",
                        {"a.th": urls["a.th"], "prior_b.th": urls["prior_b.th"]})
    monkeypatch.setattr(download_weights, "AUX_URLS", (urls["vq.yaml"], urls["vq.ckpt"]))
    monkeypatch.setattr(download_weights, "BPE_URL", urls["bpe.txt.gz"])
    out = tmp_path / "out"
    out.mkdir()
    download_weights.download_all(str(out))
    want = {"a.th", "prior_b.th", "remote_vq.yaml", "remote_vq.ckpt", "remote_bpe.txt.gz"}
    assert set(os.listdir(out)) == want
    assert (out / "a.th").read_bytes() == (src / "remote_a.th").read_bytes()
    fetched = []
    real = download_weights.urllib.request.urlretrieve
    monkeypatch.setattr(download_weights.urllib.request, "urlretrieve",
                        lambda url, path: fetched.append(url) or real(url, path))
    (out / "a.th").unlink()
    download_weights.download_all(str(out))
    assert fetched == [urls["a.th"]] and set(os.listdir(out)) == want
    monkeypatch.chdir(out)
    (out / "prior_b.th").unlink()
    cli.main(["download-weights"])
    assert fetched[1:] == [urls["prior_b.th"]] and set(os.listdir(out)) == want

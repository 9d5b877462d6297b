"""The port's VGG16 features (models/vgg.py) and diversity loss (ops/losses.py)
against the JAX package's, on the CPU.

VGG16 weights are numpy draws (kernels N(0, 2/fan_in), biases N(0, 0.01^2)) in
torchvision's names, and in taming-LPIPS's, read by the port's `load_vgg16` and
by JAX `convert_vgg16`; 32-px inputs (relu5_3 at 2 x 2). The port's maps are
NCHW, JAX's NHWC. Tolerances: features float32 within 2e-4 of
max(1, max |JAX|) per slice; the diversity loss within 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.io.torch_import import convert_vgg16
from feed_forward_vqgan_clip_tpu.models.vgg import VGG16Features as JVGG16Features
from feed_forward_vqgan_clip_tpu.ops import losses as jlosses
from feed_forward_vqgan_clip_tpu_torch.models import vgg
from feed_forward_vqgan_clip_tpu_torch.ops import losses

LPIPS_SLICE = {i: k + 1 for k, ids in enumerate(vgg.VGG16_SLICES) for i in ids}


def vgg_state_dict(seed, layout="torchvision"):
    """VGG16 conv weights from numpy draws, in torchvision's `features.N` names,
    taming-LPIPS's `net.sliceK.N` (with two of LPIPS's heads beside them, which
    the readers drop) or the bare `sliceK.N`."""
    rng = np.random.default_rng(seed)
    sd, cin = {}, 3
    for i, cout in vgg.VGG16_CHANNELS.items():
        w = rng.normal(size=(cout, cin, 3, 3)) * np.sqrt(2.0 / (9 * cin))
        name = {"torchvision": f"features.{i}", "lpips": f"net.slice{LPIPS_SLICE[i]}.{i}",
                "slices": f"slice{LPIPS_SLICE[i]}.{i}"}[layout]
        sd[f"{name}.weight"] = torch.from_numpy(w.astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy((0.01 * rng.normal(size=cout)).astype(np.float32))
        cin = cout
    if layout == "lpips":
        sd["lin0.model.1.weight"] = torch.ones(1, 64, 1, 1)
        sd["lin1.model.1.weight"] = torch.ones(1, 128, 1, 1)
    return sd


def jax_vgg_features(sd, x):
    """JAX VGG16Features (float32) on `convert_vgg16(sd)`: 5 NHWC maps."""
    params = convert_vgg16({k: v.numpy() for k, v in sd.items()})
    return [np.asarray(f) for f in JVGG16Features().apply(params, jnp.asarray(x))]


@pytest.mark.parametrize("layout", ["torchvision", "lpips", "slices"])
def test_vgg16_features_match_jax(layout, tmp_path):
    sd = vgg_state_dict(0, layout)
    path = str(tmp_path / "vgg.pth")
    torch.save({"state_dict": sd} if layout == "lpips" else sd, path)
    model = vgg.load_vgg16(path, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    x = np.random.default_rng(1).uniform(-2, 2, size=(2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    want = jax_vgg_features(sd, x)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= 2e-4 * max(1.0, float(np.abs(w).max()))


def test_load_vgg16_raises_and_seeds(tmp_path):
    sd = vgg_state_dict(2)
    del sd["features.28.weight"]
    torch.save(sd, tmp_path / "partial.pth")
    with pytest.raises(KeyError, match="features.28"):
        vgg.load_vgg16(str(tmp_path / "partial.pth"), device="cpu")
    with pytest.raises(NotImplementedError):
        vgg.load_vgg16(str(tmp_path), device="cpu")
    a, b, c = (vgg.load_vgg16(None, device="cpu", seed=s) for s in (3, 3, 4))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
    assert not torch.equal(a.features[0].weight, c.features[0].weight)
    assert float(a.features[0].bias.abs().max()) == 0.0


def _maps(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, s, s, c)).astype(np.float32) for s, c in ((8, 4), (4, 6),
                                                                          (2, 8))]


def test_normalize_tensor_matches_jax():
    (f, *_) = _maps(5, 3)
    got = losses.normalize_tensor(torch.from_numpy(f).permute(0, 3, 1, 2))
    want = np.asarray(jlosses.normalize_tensor(jnp.asarray(f)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["between_same_prompts", "all"])
@pytest.mark.parametrize("repeat,bs", [(2, 3), (3, 2), (1, 4)])
def test_diversity_loss_matches_jax(mode, repeat, bs):
    maps = _maps(6 + repeat, repeat * bs)
    got = float(losses.diversity_loss([torch.from_numpy(m).permute(0, 3, 1, 2) for m in maps],
                                      repeat, bs, mode))
    want = float(jlosses.diversity_loss([jnp.asarray(m) for m in maps], repeat, bs, mode))
    assert abs(got - want) <= 1e-5 * abs(want)
    if mode == "between_same_prompts" and repeat == 1:
        assert want == got == 0.0
    else:
        assert want > 0


def test_diversity_loss_rejects_an_unknown_mode():
    with pytest.raises(ValueError):
        losses.diversity_loss([torch.zeros(2, 3, 4, 4)], 2, 1, "pairs")

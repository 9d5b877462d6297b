"""The port's NIMA scorer and its InceptionResNetV2 trunk against the JAX package's.

The port's NIMA (numpy draws into every entry, BatchNorm statistics included)
gives its state dict, in pyiqa's key space (`base_model.` prefix), to the JAX
package's `convert_nima`, whose params drive the JAX NIMA. Images are [0, 1]
NHWC numpy draws at 96 px. Tolerances: the mean opinion score within 2e-3
absolute and relative (the JAX package's own oracle bound,
tests/test_nima.py); each block of the IRv2 trunk, and the pooled features of
both trunks, float32 within 2e-4 * max(1, max |JAX|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.io import torch_import as ti
from feed_forward_vqgan_clip_tpu.models import inception as jinception
from feed_forward_vqgan_clip_tpu.models import inception_resnet as jir
from feed_forward_vqgan_clip_tpu.models import nima as jnima
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import nima_state_dict
from feed_forward_vqgan_clip_tpu_torch.models import inception_resnet as tir
from feed_forward_vqgan_clip_tpu_torch.models import nima
from test_torch_vitgan import assert_close, normal

SIZE = 96


def _draws(module, seed):
    """numpy draws into `module`'s state dict: kernels N(0, 1/fan_in), norm
    scales 1 + N(0, 0.1), shifts and means N(0, 0.1), variances
    0.5 + |N(0, 0.1)|."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if v.dim() >= 2:
            a = rng.normal(size=v.shape) / np.sqrt(np.prod(v.shape[1:]))
        elif k.endswith("running_var"):
            a = 0.5 + np.abs(0.1 * rng.normal(size=v.shape))
        else:
            a = 0.1 * rng.normal(size=v.shape) + k.endswith("bn.weight")
        sd[k] = torch.from_numpy(np.asarray(a, np.float32))
    module.load_state_dict(sd)
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module", params=["inception_resnet_v2", "inception_v3"])
def pair(request):
    """(backbone, port NIMA, JAX NIMA, JAX params) on the same draws."""
    port = nima.NIMA(request.param).eval()
    sd = _draws(port, 3)
    with torch.no_grad():  # the head scaled to logits of std 1.5: a softmax far from flat
        x = torch.from_numpy(_x01())
        logits = port.classifier(port.backbone((x - port.mean) / port.std))
        sd["classifier.weight"] *= 1.5 / float(logits.std())
        sd["classifier.bias"] *= 1.5 / float(logits.std())
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    params = ti.convert_nima({f"base_model.{k}" if k.startswith("backbone.") else k: v
                              for k, v in sd.items()})
    return request.param, port, jnima.NIMA(backbone=request.param), params


def _x01(b=2, seed=4):
    return np.random.default_rng(seed).uniform(size=(b, SIZE, SIZE, 3)).astype(np.float32)


def test_mos_and_features_match_jax(pair):
    backbone, port, jm, params = pair
    x = _x01()
    with torch.no_grad():
        mos = port(torch.from_numpy(x)).numpy()
        h = (torch.from_numpy(x) - port.mean) / port.std
        feats = port.backbone(h).numpy()
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    np.testing.assert_allclose(mos, want, atol=2e-3, rtol=2e-3)
    assert 1.0 <= mos.min() and mos.max() <= 10.0 and np.ptp(mos) > 1e-3
    trunk = (jir.InceptionResNetV2Features() if backbone == "inception_resnet_v2" else
             jinception.InceptionV3Features())
    m, s = (nima.TRUNKS[backbone][2:])
    hj = (jnp.asarray(x) - jnp.asarray(m)) / jnp.asarray(s)
    want_f = jax.jit(trunk.apply)({"params": params["params"]["backbone"]}, hj)
    assert_close(feats, want_f)


def test_nima_state_dict_round_trip(pair):
    _, port, _, params = pair
    for k, v in nima_state_dict(jax.tree.map(np.asarray, params)).items():
        np.testing.assert_array_equal(v.numpy(), port.state_dict()[k].numpy(), err_msg=k)


BLOCKS = [  # port block, JAX block, input (H, W, C)
    ("mixed_5b", lambda: jir.Mixed5b(), (9, 9, 192)),
    ("repeat.0", lambda: jir.Block35(), (7, 7, 320)),
    ("mixed_6a", lambda: jir.Mixed6a(), (9, 9, 320)),
    ("repeat_1.0", lambda: jir.Block17(), (5, 5, 1088)),
    ("mixed_7a", lambda: jir.Mixed7a(), (5, 5, 1088)),
    ("repeat_2.0", lambda: jir.Block8(), (3, 3, 2080)),
    ("block8", lambda: jir.Block8(scale=1.0, no_relu=True), (3, 3, 2080)),
]


@pytest.mark.parametrize("name,jblock,hwc", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_irv2_block_matches_jax(name, jblock, hwc):
    trunk = tir.InceptionResNetV2Features().eval()
    sd = _draws(trunk, 5)
    params = ti.convert_inception_resnet(sd)["params"]
    jname = name.replace("repeat_1.", "repeat_1_").replace("repeat_2.", "repeat_2_").replace(
        "repeat.", "repeat_")
    x = normal(6, 2, *hwc)
    with torch.no_grad():
        got = trunk.get_submodule(name)(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = jblock().apply({"params": params[jname]}, jnp.asarray(x))
    assert_close(got.permute(0, 2, 3, 1), want)


def test_mixed_5b_pool_leaves_out_the_padding():
    x = torch.ones(1, 192, 5, 5)
    pool = tir.Mixed5b().branch3[0]
    np.testing.assert_array_equal(pool(x).numpy(), np.ones((1, 192, 5, 5), np.float32))


# --------------------------------------------------------------- head matching

F = 12


def _trunk_sd(backbone):
    stem = "conv2d_1a" if backbone == "inception_resnet_v2" else "Conv2d_1a_3x3"
    return {f"base_model.{stem}.conv.weight": np.zeros((2, 3, 3, 3), np.float32)}


def _head(seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(10, F)).astype(np.float32), rng.normal(size=10).astype(np.float32)


@pytest.mark.parametrize("case", ["named", "by_shape", "aux_logits", "module_prefix"])
def test_head_matching_equals_jax(case):
    w, b = _head(1)
    sd = _trunk_sd("inception_v3")
    if case == "named":  # a named head beside an unnamed (10, F) matrix
        sd.update({"classifier.2.weight": w, "classifier.2.bias": b,
                   "base_model.proj.weight": _head(2)[0], "base_model.proj.bias": _head(2)[1]})
    elif case == "by_shape":
        sd.update({"scorer.weight": w, "scorer.bias": b})
    elif case == "aux_logits":  # the train-time aux head never wins
        sd.update({"base_model.AuxLogits.fc.weight": _head(3)[0],
                   "base_model.AuxLogits.fc.bias": _head(3)[1],
                   "base_model.fc.weight": w, "base_model.fc.bias": b})
    else:
        sd = {f"module.{k}": v for k, v in sd.items()}
        sd.update({"module.head.weight": w, "module.head.bias": b})
    backbone, got = nima.convert_nima({k: torch.from_numpy(v) for k, v in sd.items()})
    assert backbone == "inception_v3" == nima.detect_nima_backbone(sd) == \
        jnima.detect_nima_backbone(sd)
    np.testing.assert_array_equal(got["classifier.weight"].numpy(), w)
    np.testing.assert_array_equal(got["classifier.bias"].numpy(), b)
    assert not any("AuxLogits" in k for k in got)


def test_head_matching_picks_what_jax_picks():
    """The JAX converter on a whole NIMA file (its trunk must convert) picks the
    same head as the port's, with an aux head and an unnamed matrix beside it."""
    port = nima.NIMA("inception_v3")
    sd = {f"base_model.{k}": v.numpy() for k, v in port.state_dict().items()
          if k.startswith("backbone.")}
    sd = {k.replace("base_model.backbone.", "base_model."): v for k, v in sd.items()}
    w, b = _head(4)
    sd.update({"base_model.AuxLogits.fc.weight": _head(5)[0][:, :8],
               "base_model.AuxLogits.fc.bias": _head(5)[1],
               "base_model.fc.weight": np.pad(w, ((0, 0), (0, 2048 - F))),
               "base_model.fc.bias": b})
    params = ti.convert_nima(sd)["params"]
    _, got = nima.convert_nima({k: torch.from_numpy(v) for k, v in sd.items()})
    np.testing.assert_array_equal(got["classifier.weight"].numpy(),
                                  np.asarray(params["classifier"]["kernel"]).T)
    np.testing.assert_array_equal(got["classifier.bias"].numpy(),
                                  np.asarray(params["classifier"]["bias"]))


@pytest.mark.parametrize("case", ["ambiguous", "none"])
def test_head_matching_raises_as_jax(case):
    sd = _trunk_sd("inception_resnet_v2")
    if case == "ambiguous":
        for name in ("classifier", "head"):
            w, b = _head(6)
            sd.update({f"{name}.weight": w, f"{name}.bias": b})
    with pytest.raises(KeyError) as port:
        nima.convert_nima({k: torch.from_numpy(v) for k, v in sd.items()})
    with pytest.raises(KeyError) as jx:
        ti.convert_nima(sd)
    assert str(port.value) == str(jx.value)


def test_make_nima_fn_reads_a_pyiqa_file(tmp_path):
    port = nima.NIMA("inception_resnet_v2").eval()
    sd = _draws(port, 8)
    path = tmp_path / "nima.pth"
    torch.save({f"base_model.{k[len('backbone.'):]}" if k.startswith("backbone.")
                else k.replace("classifier.", "classifier.2."): torch.from_numpy(v)
                for k, v in sd.items()}, path)
    fn = nima.make_nima_fn(str(path), device="cpu")
    assert fn.backbone_name == "inception_resnet_v2"
    x = torch.from_numpy(_x01(1, 9))
    with torch.no_grad():
        np.testing.assert_array_equal(fn(x).numpy(), port(x).numpy())
    a, b = (nima.make_nima_fn(None, device="cpu", seed=s) for s in (1, 1))
    assert torch.equal(a.classifier.weight, b.classifier.weight)

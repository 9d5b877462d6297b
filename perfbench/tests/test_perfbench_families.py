"""The reference's mapper families and CLIP activation come from the
configuration file: a family is a file found by its `model_type`, the towers'
activation follows the configuration's `clip_model` on both sides, and every
key of a configuration's `mapper` object reaches the port's `build_mapper`.
Moving the two families into files of their own changed no weight and no
output."""

import hashlib
import json
import shutil
import subprocess
import sys

import pytest
import torch

import tiny_cell
from perfbench.harness import cell as C
from perfbench.harness import program
from perfbench.harness.weights import draw
from perfbench.reference import models as R
from perfbench.reference import train as T

ROOT = C.ROOT
SEED = 2**31 + 11

# Computed on the tree before the families moved into reference/mappers/ (the
# commit whose reference/models.py held `mixer_spec`, `vitgan_spec`, `mixer` and
# `vitgan`), with `_spec_digest` and `_checksum` below. A spec's digest is the
# sha256 of its JSON list of [key, shape, [kind, std]] in draw order: the
# order harness/weights.draw slices one randn in, so the same digest means
# the same weights from every seed.
FROZEN_SPECS = {
    ("mixer32x1024-vitb32-f16", "clip"): (
        302, "5ee62b0271b49e82ce56fa42856e4b5d19787a7ce679ec1a38d25b61e3fe2c99"),
    ("mixer32x1024-vitb32-f16", "vqgan"): (
        197, "851dbac5fa7b250475286f7c0d270b80559a55b5b4e39091fb034b379bfdd367"),
    ("mixer32x1024-vitb32-f16", "mapper"): (
        392, "9e5ca77d89a5e453e12bbac6384f5247c7e8792f23ae054af2e07c5bbadefa23"),
    ("vitgan32x1024-vitb32-f16", "clip"): (
        302, "5ee62b0271b49e82ce56fa42856e4b5d19787a7ce679ec1a38d25b61e3fe2c99"),
    ("vitgan32x1024-vitb32-f16", "vqgan"): (
        197, "851dbac5fa7b250475286f7c0d270b80559a55b5b4e39091fb034b379bfdd367"),
    ("vitgan32x1024-vitb32-f16", "mapper"): (
        489, "8e538a3ccc876b56a9a47926b2a70200a96a64f783def560281cd0ea9b419b49"),
}
# The float32 reference at tiny_cell's widths on the CPU, weights and inputs
# from SEED (`_tiny_outputs`): (position-weighted sum, sum of magnitudes) in
# float64. The same on 1, 3 and 8 threads there; the tolerance below leaves
# room for another BLAS's rounding only.
FROZEN_CHECKSUMS = {
    "mlp_mixer": (119.76801380003064, 1496.5786493710475),
    "vitgan": (12.594780377283424, 1677.5997076642234),
    "clip_text": (15.808158599690888, 127.89596655592322),
    "clip_image": (-23.485442650475076, 96.35923747997731),
}


def _spec_digest(spec):
    rows = [[k, list(shape), [kind, std]] for k, (shape, (kind, std)) in spec.items()]
    return len(rows), hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def _checksum(out):
    f = out.double().flatten()
    w = torch.linspace(1.0, 2.0, len(f), dtype=torch.float64)
    return float((f * w).sum()), float(f.abs().sum())


def _tokens_and_images(c, n=4, seed=SEED):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.zeros(n, c["context_length"], dtype=torch.long)
    tokens[:, 0], tokens[:, 2] = 49406, 49407
    tokens[:, 1] = torch.randint(300, 40000, (n,), generator=g)
    images = torch.randn(n, c["image_size"], c["image_size"], 3, generator=g)
    return tokens, images


def _tiny_outputs(name):
    if name in ("mlp_mixer", "vitgan"):
        cfg = tiny_cell.config(name)
        c, m, ch = cfg["clip"], cfg["mapper"], cfg["vqgan"]["embed_dim"]
        sd = draw(R.mapper_spec(m, c["embed_dim"], ch), SEED, 3, "cpu")
        x = torch.randn(4, c["embed_dim"], generator=torch.Generator().manual_seed(SEED))
        return R.mapper(sd, x, m, ch)
    cfg = tiny_cell.config()
    c, act = cfg["clip"], R.clip_act(cfg)
    sd = draw({**R.clip_text_spec(c), **T.clip_image_spec(c)}, SEED, 11, "cpu")
    tokens, images = _tokens_and_images(c)
    if name == "clip_text":
        return R.clip_text(sd, tokens, c, act=act)
    return T.clip_image(sd, images, c, act=act)


@pytest.mark.parametrize("cfg_name,part", sorted(FROZEN_SPECS))
def test_the_specs_are_the_frozen_ones(cfg_name, part):
    cfg = json.loads((ROOT / f"perfbench/configs/{cfg_name}.json").read_text())
    c, v = cfg["clip"], cfg["vqgan"]
    spec = {"clip": lambda: {**R.clip_text_spec(c), **T.clip_image_spec(c)},
            "vqgan": lambda: R.vqgan_spec(v),
            "mapper": lambda: R.mapper_spec(cfg["mapper"], c["embed_dim"], v["embed_dim"])}[part]()
    assert _spec_digest(spec) == FROZEN_SPECS[cfg_name, part]


@pytest.mark.parametrize("name", sorted(FROZEN_CHECKSUMS))
def test_the_tiny_reference_outputs_are_the_frozen_ones(name):
    got = _checksum(_tiny_outputs(name))
    assert got == pytest.approx(FROZEN_CHECKSUMS[name], rel=1e-6)


TOY_FAMILY = '''"""A family added as a file: one Linear from the input to every latent."""

from perfbench.reference import models as R
from perfbench.reference.precision import EXACT


def spec(m, clip_dim, channels):
    out = {}
    R._dense("proj.", m["vq_image_size"] ** 2 * channels, clip_dim + m["noise_dim"], out)
    return out


def forward(sd, x, m, channels, P=EXACT):
    with P.matmul_mode():
        s = m["vq_image_size"]
        return R.linear(x, sd["proj.weight"], sd["proj.bias"], P).reshape(-1, s, s, channels)
'''

TOY_CHECK = '''
import json, sys
sys.path.insert(0, ".")
import torch
from perfbench.counts import flops
from perfbench.reference import models as R
cfg = json.load(open("perfbench/configs/toy.json"))
c, m, ch = cfg["clip"], cfg["mapper"], cfg["vqgan"]["embed_dim"]
spec = R.mapper_spec(m, c["embed_dim"], ch)
sd = {k: torch.randn(shape) for k, (shape, _) in spec.items()}
z = R.mapper(sd, torch.randn(2, c["embed_dim"] + m["noise_dim"]), m, ch)
wide = json.loads(json.dumps(cfg))
wide["mapper"]["noise_dim"] = 8
extra = 2 * 8 * m["vq_image_size"] ** 2 * ch
try:
    R.mapper_spec(dict(m, model_type="absent_family"), c["embed_dim"], ch)
    error = None
except ValueError as e:
    error = str(e)
print(json.dumps({"keys": {k: list(s) for k, (s, _) in spec.items()}, "z": list(z.shape),
                  "image": flops.image_flops(wide) - flops.image_flops(cfg) - extra,
                  "train": flops.train_image_flops(cfg, 2), "error": error}))
'''


def test_a_mapper_family_is_added_as_a_new_file(tmp_path):
    """A later change adds reference/mappers/<model_type>.py and a configuration
    naming it; the weights, the reference's forward and both FLOP counts take it
    with no other file changed, and a family with no file names the file to add."""
    shutil.copytree(C.BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "perfbench/reference/mappers/toy_linear.py").write_text(TOY_FAMILY)
    cfg = tiny_cell.config()
    cfg["mapper"] = {"model_type": "toy_linear", "vq_image_size": 4, "noise_dim": 0}
    (tmp_path / "perfbench/configs/toy.json").write_text(json.dumps(cfg))
    out = subprocess.run([sys.executable, "-c", TOY_CHECK], cwd=tmp_path, capture_output=True,
                         text=True, check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    ch = cfg["vqgan"]["embed_dim"]
    assert got["keys"] == {"proj.weight": [16 * ch, 32], "proj.bias": [16 * ch]}
    assert got["z"] == [2, 4, 4, ch]
    assert got["image"] == 0  # the input's 8 more widths cost the family's Linear alone
    assert got["train"] > 0
    missing = tmp_path / "perfbench/reference/mappers/absent_family.py"
    assert str(missing.resolve()) in got["error"]


@pytest.mark.parametrize("model_type", ["no_such_family", "../train", "a.b"])
def test_a_family_with_no_file_names_the_file_to_add(model_type):
    with pytest.raises(ValueError, match="add .*reference/mappers/"):
        R.mapper_spec({"model_type": model_type}, 32, 8)


GELU_MODEL = "openclip/ViT-B-32/laion2b_e16"  # the released laion2b Mixers' CLIP
OTHER = {"gelu": "quick_gelu", "quick_gelu": "gelu"}


@pytest.mark.parametrize("name,act", [
    ("ViT-B/32", "quick_gelu"), ("RN50", "quick_gelu"), ("tiny", "quick_gelu"),
    (GELU_MODEL, "gelu"), ("openclip/ViT-B-32-quickgelu/laion400m_e32", "quick_gelu"),
    ("openclip/ViT-H-14/laion2b_s32b_b79k", "gelu"),
])
def test_the_clip_activation_follows_the_model_name(name, act):
    """The reference repeats the port's naming rule (`make_clip`): the same
    activation from the same `clip_model` on both sides."""
    assert R.clip_act({"clip_model": name}) == program.clip_act({"clip_model": name}) == act


@pytest.mark.parametrize("cfg_name", ["mixer32x1024-vitb32-f16", "vitgan32x1024-vitb32-f16"])
def test_the_configurations_keep_quick_gelu(cfg_name):
    cfg = json.loads((ROOT / f"perfbench/configs/{cfg_name}.json").read_text())
    assert R.clip_act(cfg) == program.clip_act(cfg) == "quick_gelu"


def test_the_clip_activation_follows_the_configuration():
    """With an OpenCLIP GELU `clip_model` the reference's towers match the port's
    towers as the harness builds them (text: `program.text_perceptor`; image: the
    train generator's `build`), and sit farther from their QuickGELU form than
    from the port, so a tower either side built with QuickGELU would fail. In
    float32 the port's towers read the reference's to rounding on the CPU; in
    bfloat16 the port's own gap is wider than the activation's
    (`test_a_wrong_clip_activation_at_full_width_on_the_card`)."""
    build = C.load_module(C.BENCH / "traffic" / "train.py").build
    cfg = tiny_cell.config()
    cfg["compute_dtype"] = "float32"
    cfg["clip_model"] = GELU_MODEL
    c = cfg["clip"]
    # the port sizes a mapper's input by the CLIP model's name unless told; here
    # the name is a ViT-B/32's and the tower tiny
    cfg["mapper"]["clip_dim"] = c["embed_dim"]
    cpu = torch.device("cpu")
    sds = {"clip": draw({**R.clip_text_spec(c), **T.clip_image_spec(c)}, SEED, 11, cpu),
           "vqgan": draw(R.vqgan_spec(cfg["vqgan"]), SEED, 2, cpu),
           "mapper": draw(R.mapper_spec(cfg["mapper"], c["embed_dim"], cfg["vqgan"]["embed_dim"]),
                          SEED, 3, cpu)}
    tokens, images = _tokens_and_images(c, n=8)
    text_sd = {k: v for k, v in sds["clip"].items() if k in R.clip_text_spec(c)}
    _, _, _, frozen = build(cfg, tiny_cell.MIXES["train"], sds, cpu)
    with torch.no_grad():
        port = {"text": program.text_perceptor(cfg, text_sd, cpu).encode_text(tokens).float(),
                "image": frozen.perceptor.encode_image(images).float()}

    def ref(act):
        return {"text": R.clip_text(sds["clip"], tokens, c, act=act),
                "image": T.clip_image(sds["clip"], images, c, act=act)}

    assert R.clip_act(cfg) == "gelu"
    gelu, quick = ref("gelu"), ref("quick_gelu")
    limit = tiny_cell.LIMITS["text_err"]
    for tower in ("text", "image"):
        gap = float(R.rel_l2(port[tower], gelu[tower]).max())
        apart = float(R.rel_l2(quick[tower], gelu[tower]).min())
        assert gap <= limit and apart > gap, (tower, gap, apart)


def activation_readings(cfg, sd, tokens, images, device):
    """Each tower of the port, in the configuration's compute dtype and built with
    the activation its `clip_model` names ("sound") or the other ("fault"),
    against the float32 reference with the named activation: `err`, the widest
    row's relative gap (what `text_err` reads of the text tower), and `margin`,
    the mean over rows of the gap to the reference with the other activation less
    the gap to the named one (above 0: the tower is nearer the named form)."""
    from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip_from_config

    c, named = cfg["clip"], R.clip_act(cfg)
    with torch.no_grad():
        ref = {a: {"text": R.clip_text(sd, tokens, c, act=a),
                   "image": T.clip_image(sd, images, c, act=a)} for a in (named, OTHER[named])}
        out = {}
        for case, act in (("sound", program.clip_act(cfg)), ("fault", OTHER[named])):
            tower = make_clip_from_config(c, act=act, dtype=program.DTYPES[cfg["compute_dtype"]],
                                          device=device, image=True)
            tower.load_state_dict(sd)
            got = {"text": tower.eval().encode_text(tokens).float(),
                   "image": tower.encode_image(images).float()}
            for part, g in got.items():
                near = R.rel_l2(g, ref[named][part])
                far = R.rel_l2(g, ref[OTHER[named]][part])
                out[f"{part}.{case}"] = {"err": float(near.max()),
                                         "margin": float((far - near).mean())}
            del tower
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("clip_model", [GELU_MODEL, "ViT-B/32"])
def test_a_wrong_clip_activation_at_full_width_on_the_card(clip_model):
    """At the cells' ViT-B/32 width in bfloat16 on the card: the rows the batch
    cell compares (two batches of eight of its token pool) and 64 images, the
    train cell's cutouts of a step; over three seeds. `text_err` reads a tower
    built with the wrong activation about as it reads a sound one (PERF.md),
    so no limit on it can tell them apart; the margin does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    batch = C.load_module(C.BENCH / "traffic" / "batch.py")
    train = C.load_module(C.BENCH / "traffic" / "train.py")
    cfg = json.loads((ROOT / "perfbench/configs/mixer32x1024-vitb32-f16.json").read_text())
    cfg["clip_model"] = clip_model
    mix = json.loads((ROOT / "perfbench/traffic/batch256.json").read_text())
    rows = []
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        sd = train.weights(cfg, seed, dev)["clip"]
        pool, _ = batch.token_pool(mix, seed, dev)
        tokens = torch.cat([pool[0, :8], pool[1, :8]])
        g = torch.Generator(device=dev).manual_seed(seed)
        size = cfg["clip"]["image_size"]
        images = torch.randn(64, size, size, 3, generator=g, device=dev)
        rows.append(dict(seed=seed, **activation_readings(cfg, sd, tokens, images, dev)))
        del sd
        torch.cuda.empty_cache()
    print(json.dumps({"clip_model": clip_model, "readings": rows}))
    for r in rows:
        assert r["text.sound"]["err"] <= 0.05, r
        for part in ("text", "image"):
            assert r[f"{part}.sound"]["margin"] > 0 > r[f"{part}.fault"]["margin"], (part, r)


@pytest.mark.parametrize("initial_proj,add_input", [(False, True), (False, False)])
def test_every_mapper_key_reaches_the_port(initial_proj, add_input):
    from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
    from feed_forward_vqgan_clip_tpu_torch.models.mappers.xtransformer import XTransformer

    cfg = tiny_cell.config()
    cfg["mapper"] = {"model_type": "xtransformer", "dim": 64, "depth": 2, "vq_image_size": 4,
                     "num_heads": 2, "noise_dim": 0, "initial_proj": initial_proj,
                     "add_input": add_input}
    keys = program.mapper_config(cfg)
    assert keys == dict(cfg["mapper"], clip_model="tiny", compute_dtype="bfloat16", dropout=0.0)
    m = build_mapper(keys, vq_channels=cfg["vqgan"]["embed_dim"], device=torch.device("meta"))
    assert isinstance(m, XTransformer)
    assert (m.initial_proj, m.add_input) == (initial_proj, add_input)
    assert "proj.weight" not in m.state_dict()
    rows = 16 + (0 if add_input else 1)
    assert tuple(m.state_dict()["transformer.pos_emb.emb.weight"].shape) == (rows, 64)

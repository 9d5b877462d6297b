"""The released 512-px OpenCLIP Mixer
(`cc12m_1x1024_mlp_mixer_openclip_laion2b_ViTB32_512x512_v0.4.th`) on the CPU,
against the benchmark's plain reference (perfbench/reference, plain float32
torch) on seeded random weights, float32.

- The Mixer at 32 x 32 latents (T = 1024 tokens), depth 1, at a small width:
  the module route and the stream route's plain form (what K4 computes) within
  1e-5 of max |reference| (the same float32 products summed in another order).
- The OpenCLIP text tower at the tiny width, loaded by the Predictor's loader
  from an `openclip/...` name, against the reference with exact GELU within
  1e-5; with QuickGELU planted where the port picks the activation, the same
  comparison fails by far (the two activations differ by up to ~2e-2 an
  element).
- The released widths on meta tensors: 151,799,040 parameters (579.1 MiB in
  float32, the zoo's "580MB"), the reference's spec equal to the port's.
- K4's plan and workspace at the released widths on 132 SMs (the H100's
  count), as pure Python, and the flagship's plan as it was.
"""

import json
import math
from pathlib import Path

import pytest
import torch

from feed_forward_vqgan_clip_tpu_torch.models import clip_vit
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
from feed_forward_vqgan_clip_tpu_torch.models.mappers.fused import (
    make_mapper_apply,
    mapper_route,
    prepare_streamed_params,
    streamed_mixer_forward,
)
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import load_perceptor
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_stream import (
    StreamPlan,
    _workspaces,
    stream_partial_floats,
    stream_plan,
)
from feed_forward_vqgan_clip_tpu_torch.registry import CLIP_VIT_CONFIGS
from perfbench.harness import program
from perfbench.harness.weights import draw
from perfbench.reference import models as R

REPO = Path(__file__).resolve().parents[1]
CONFIG = json.loads(
    (REPO / "perfbench/configs/mixer1x1024-openclip-vitb32-f16-512px.json").read_text())
RELEASED_PARAMS = 151_799_040
SMS = 132
TOL = 1e-5


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


def _mixer_and_weights(dim=16, channels=4, clip_dim=8, seed=5):
    """The configuration's Mixer (T = 1024, depth 1, expansion 4) at a small
    width, float32, holding the reference's seeded weights."""
    m = dict(CONFIG["mapper"], dim=dim)
    sd = draw(R.mapper_spec(m, clip_dim, channels), seed, 3, "cpu")
    cfg = dict(m, clip_model=CONFIG["clip_model"], clip_dim=clip_dim, dropout=0.0,
               compute_dtype="float32")
    mapper = build_mapper(cfg, vq_channels=channels)
    mapper.load_state_dict(sd)
    return mapper.eval(), sd, m


def test_the_configuration_is_the_released_512px_openclip_mixer():
    m = CONFIG["mapper"]
    assert (m["model_type"], m["dim"], m["depth"], m["vq_image_size"], m["expansion"]) == (
        "mlp_mixer", 1024, 1, 32, 4)
    assert CONFIG["source"].endswith(
        "/0.4/cc12m_1x1024_mlp_mixer_openclip_laion2b_ViTB32_512x512_v0.4.th")
    assert CONFIG["reduced"] == [] and CONFIG["vqgan"]["resolution"] == 256
    # OpenCLIP's ViT-B-32 has OpenAI's widths; both sides give it exact GELU
    assert CONFIG["clip"] == CLIP_VIT_CONFIGS["ViT-B/32"]
    assert R.clip_act(CONFIG) == program.clip_act(CONFIG) == "gelu"


@pytest.mark.parametrize("route", ["module", "stream_plain"])
def test_mixer_at_1024_tokens_matches_the_reference(route):
    mapper, sd, m = _mixer_and_weights()
    x = torch.randn(2, 8, generator=torch.Generator().manual_seed(1))
    ref = R.mapper(sd, x, m, 4)
    with torch.no_grad():
        if route == "module":
            assert mapper_route(mapper, len(x), x.device) == "module"
            got = make_mapper_apply(mapper)(x)
        else:  # K4's plain form: the whole stack stacked and LN2-folded
            got = streamed_mixer_forward(mapper, prepare_streamed_params(mapper), x)
    assert got.shape == ref.shape == (2, 32, 32, 4)
    assert _rel(got, ref) <= TOL


def _text_tower_file(tmp_path, seed=7):
    c = CLIP_VIT_CONFIGS["tiny"]
    sd = draw(R.clip_text_spec(c), seed, 1, "cpu")
    path = tmp_path / "clip_text.pt"
    torch.save(sd, path)
    return sd, c, str(path)


@pytest.mark.parametrize("planted", [False, True], ids=["exact_gelu", "quick_gelu_planted"])
def test_openclip_text_tower_takes_exact_gelu(tmp_path, monkeypatch, planted):
    """The Predictor's loader on an `openclip/<arch>/<tag>` name and a text-only
    state dict: exact GELU, as the reference; a tower given QuickGELU where the
    port picks the activation (`parse_openclip`) fails the same comparison."""
    sd, c, path = _text_tower_file(tmp_path)
    name = "openclip/tiny/laion2b_e16"
    if planted:
        monkeypatch.setattr(clip_vit, "parse_openclip", lambda n: ("tiny", "quick_gelu"))
    tower = load_perceptor(name, path, dtype=torch.float32, device="cpu", image=False)
    tokens = torch.zeros(3, 77, dtype=torch.long)
    tokens[:, 0], tokens[:, 1:4] = 49406, torch.tensor([[320, 1125, 539], [4000, 12, 9],
                                                         [8000, 30000, 7]])
    tokens[torch.arange(3), torch.tensor([4, 4, 4])] = 49407
    got = tower.encode_text(tokens)
    ref = R.clip_text(sd, tokens, c, act=R.clip_act({"clip_model": name}))
    err = float(R.rel_l2(got, ref).max())
    if planted:
        assert err > 100 * TOL, err
    else:
        assert err <= TOL, err


def test_released_widths_hold_151799040_parameters():
    meta = torch.device("meta")
    mapper = build_mapper(program.mapper_config(CONFIG), vq_channels=CONFIG["vqgan"]["embed_dim"],
                          device=meta)
    n = sum(p.numel() for p in mapper.parameters())
    spec = R.mapper_spec(CONFIG["mapper"], CONFIG["clip"]["embed_dim"],
                         CONFIG["vqgan"]["embed_dim"])
    assert n == sum(math.prod(shape) for shape, _ in spec.values()) == RELEASED_PARAMS
    assert round(n * 4 / 2**20, 1) == 579.1
    assert {k: tuple(v.shape) for k, v in mapper.state_dict().items()} == {
        k: tuple(shape) for k, (shape, _) in spec.items()}
    assert mapper.proj.weight.numel() == 512 * 256 * 32 * 32
    # one row (a 1x1 request) up to 8 take K4 on the card, more rows K2 a block
    cuda = torch.device("cuda")
    assert [mapper_route(mapper, n, cuda) for n in (1, 4, 8, 9)] == [
        "stream", "stream", "stream", "block"]


def test_k4_plan_at_the_released_widths():
    """B = 1, T = 1024, D = 1024, Et = Ec = 4096: g1 and g3 have 256 output tiles
    (two waves on 132 SMs) and keep K whole; r and out (64 tiles, K = 4096) cut K
    in two. The partials of the larger split GEMM set the f32 workspace."""
    args = (1, 1024, 1024, 4096, 4096)
    plan = stream_plan(*args, SMS)
    assert plan == StreamPlan(tiles=(256, 64, 256, 64), splits=(1, 2, 1, 2),
                              k_split=(16, 32, 16, 32))
    assert plan.barriers(1) == 6
    assert stream_partial_floats(plan, *args) == 2 * 1024 * 1024
    # what a launch allocates (on meta tensors): out, buf, r, xn 2 MiB each in bf16,
    # g1 and g3 8 MiB each, the f32 partials 8 MiB, the barrier's counter
    x = torch.empty(1, 1024, 1024, dtype=torch.bfloat16, device="meta")
    spaces = _workspaces(x, 4096, 4096, stream_partial_floats(plan, *args))
    assert sum(t.numel() * t.element_size() for t in spaces) == 32 * 2**20 + 4


def test_k4_flagship_plan_is_unchanged():
    """The flagship (T = 256, D = 1024, depth 32) at one row and at 8 rows."""
    one = stream_plan(1, 256, 1024, 1024, 4096, SMS)
    assert one == StreamPlan(tiles=(64, 16, 64, 16), splits=(1, 2, 2, 8), k_split=(4, 8, 8, 8))
    assert one.barriers(32) == 32 * 7  # the six phases and g3's sum phase
    assert stream_partial_floats(one, 1, 256, 1024, 1024, 4096) == 8 * 256 * 1024
    eight = stream_plan(8, 256, 1024, 1024, 4096, SMS)
    assert eight == StreamPlan(tiles=(512, 128, 512, 128), splits=(1, 1, 1, 1),
                               k_split=(4, 16, 16, 64))

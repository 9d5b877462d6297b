"""The port's composed train step against the JAX package's `make_train_step`.

Tiny geometry, float32: CLIP "tiny" (both towers), Mixer dim 16 depth 2 over 4x4
tokens, a two-level VQGAN rendering 8x8 images pooled to 32-px cutouts, batch 3,
repeat 2, cutn 2, normalize_input, input loss, L2 and TV terms. The JAX modules
draw their weights from their own init; the port gets them through
io/from_jax.py. The loss and every mapper gradient must agree, three times:

  * augmentations neutralised: noise_fac 0, the JAX side's identity centre crop,
    the port's aug list emptied;
  * Ji and Er applied at numpy-pinned draws on both sides (`ji_apply` with the
    `Ji` code's saturation and hue factors, `er_apply` with one box for the
    batch, and the per-sample application masks);
  * the default set Af, Pe, Ji, Er at numpy-pinned draws (`af_apply` angles and
    shifts, `pe_apply` corner points, each with its masks): the warps' forward
    and exact image gradient inside the whole chain;
  * `pool: false` with the `Cc` code: the 8-px renders tiled unpooled and cut
    to 32-px crops (a warp whose output frame is not its input's, border
    padding), noise 0.

Twice with the diversity term (`diversity_coef` 0.5, both modes): VGG16
features of 16-px renders from numpy weights on both sides. Once with a VitGAN
Generator in the Mixer's place (3 heads over dim 16, 8 x 8
latent tokens, 16-px renders), the default set at numpy-pinned draws. And once
with the fused image tower (FFVC_FUSED_CLIP's path, K11's plain
version on the CPU) against JAX's fused tower in interpret mode: augmentations
neutralised, a CLIP of vision width 128 (the kernel gate's widths) and batch 4
(16 crops of 17 tokens, 272 rows, which the gate's row tiles divide).

Tolerances: loss 1e-5 relative; each mapper grad within 1e-4 of its max |JAX
grad| plus 1e-3 of the largest grad of all (f32 sums in other orders through
the whole chain; the floor covers the token-FF output bias, whose grad is zero
but for rounding because the next LayerNorms remove a per-token shift).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.config import make_config as j_make_config
from feed_forward_vqgan_clip_tpu.config import vqgan_arch_config as j_vqgan_arch
from feed_forward_vqgan_clip_tpu.models.mappers import build_mapper as j_build_mapper
from feed_forward_vqgan_clip_tpu.models.perceptor import load_perceptor as j_load_perceptor
from feed_forward_vqgan_clip_tpu.models.vqgan import make_vqgan as j_make_vqgan
from feed_forward_vqgan_clip_tpu.io.torch_import import convert_vgg16
from feed_forward_vqgan_clip_tpu.models.vgg import VGG16Features as JVGG16Features
from feed_forward_vqgan_clip_tpu.ops import augment as jaug
from feed_forward_vqgan_clip_tpu.models import clip_fused as jclip_fused
from feed_forward_vqgan_clip_tpu.models import clip_vit as jclip
from feed_forward_vqgan_clip_tpu.models import perceptor as jperceptor
from feed_forward_vqgan_clip_tpu.ops.cutouts import MakeCutouts as JMakeCutouts
from feed_forward_vqgan_clip_tpu.registry import CLIP_VIT_CONFIGS
from feed_forward_vqgan_clip_tpu.train import loop as jloop
from feed_forward_vqgan_clip_tpu_torch.config import make_config
from feed_forward_vqgan_clip_tpu_torch.entry import train_entry
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import (
    clip_state_dict,
    mixer_state_dict,
    vitgan_generator_state_dict,
    vqgan_state_dict,
)
from feed_forward_vqgan_clip_tpu_torch.models import clip_fused
from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip, make_clip_from_config
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import Perceptor
from feed_forward_vqgan_clip_tpu_torch.models.vgg import VGG16Features
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import make_vqgan
from feed_forward_vqgan_clip_tpu_torch.ops import augment
from feed_forward_vqgan_clip_tpu_torch.ops.cutouts import MakeCutouts
from feed_forward_vqgan_clip_tpu_torch.train import loop
from feed_forward_vqgan_clip_tpu_torch.train.loop import FrozenModels, make_train_step
from feed_forward_vqgan_clip_tpu_torch.train.state import make_optimizer, make_train_state
from test_torch_vgg import vgg_state_dict

TINY_VQ = dict(n_embed=32, embed_dim=8, z_channels=8, ch=8, ch_mult=(1, 2),
               num_res_blocks=1, attn_resolutions=(4,), resolution=8)
BS, REPEAT, CUTN, SIZE = 3, 2, 2, 32
KNOBS = dict(clip_model="tiny", vqgan_arch=TINY_VQ, model_type="mlp_mixer", dim=16, depth=2,
             dropout=0, vq_image_size=4, batch_size=BS, repeat=REPEAT, cutn=CUTN,
             cut_size=SIZE, pool_size=SIZE, noise_dim=0, lr=1e-3, compute_dtype="float32",
             aug_dtype="float32", noise_fac=0.0, normalize_input=True, input_loss=True,
             input_loss_coef=0.5, l2_coef=0.1, tv_coef=0.1)
# a VitGAN Generator in the Mixer's place: 8 x 8 latent tokens (16-px renders),
# 3 heads over dim 16 (an inner width of 15)
VITGAN_KNOBS = dict(KNOBS, model_type="vitgan", vq_image_size=8, num_heads=3)
MAPPER_STATE_DICT = {"mlp_mixer": mixer_state_dict, "vitgan": vitgan_generator_state_dict}


def _tokens(bs=BS):
    g = np.random.default_rng(3)
    toks = np.zeros((bs, 77), np.int32)
    toks[:, 0] = 49406
    for i in range(bs):
        n = 3 + 2 * i
        toks[i, 1:1 + n] = g.integers(2, 49000, size=n)
        toks[i, 1 + n] = 49407
    return toks


def _pinned_draws(rng):
    """Ji factors and masks, one Er box with its masks, and Af angles and shifts and
    Pe corner points (distortion 0.7) with their masks, for the cutout batch."""
    n = CUTN * REPEAT * BS
    d = dict(
        sf=rng.uniform(0.9, 1.1, size=n).astype(np.float32),
        hf=rng.uniform(-0.1, 0.1, size=n).astype(np.float32),
        ji_on=rng.uniform(size=n) < 0.7,
        box=tuple(np.float32([v]) for v in (5.3, 7.8, 12.0, 9.0)),  # x0, y0, ew, eh
        er_on=rng.uniform(size=n) < 0.7,
    )
    base = np.float32([[0, 0], [SIZE - 1, 0], [SIZE - 1, SIZE - 1], [0, SIZE - 1]])
    signs = np.float32([[1, 1], [-1, 1], [-1, -1], [1, -1]])
    start = np.broadcast_to(base, (n, 4, 2)).astype(np.float32)
    d.update(
        af=tuple(rng.uniform(-lim, lim, size=n).astype(np.float32)
                 for lim in (15.0, 0.1 * SIZE, 0.1 * SIZE)),  # angle (degrees), tx, ty
        af_on=rng.uniform(size=n) < 0.7,
        pe=(start, (start + rng.uniform(size=(n, 4, 2)) * SIZE * 0.35 * signs).astype(
            np.float32)),
        pe_on=rng.uniform(size=n) < 0.7,
    )
    return d


def _jax_augs(d, geometric):
    ones = np.ones_like(d["sf"])

    def af(key, x):
        return jnp.where(d["af_on"][:, None, None, None], jaug.af_apply(x, *d["af"]), x)

    def pe(key, x):
        return jnp.where(d["pe_on"][:, None, None, None], jaug.pe_apply(x, *d["pe"]), x)

    def ji(key, x):
        out = jaug.ji_apply(x.astype(jnp.float32), ones, ones, d["sf"], d["hf"], None)
        return jnp.where(d["ji_on"][:, None, None, None], out.astype(x.dtype), x)

    def er(key, x):
        return jnp.where(d["er_on"][:, None, None, None], jaug.er_apply(x, *d["box"]), x)

    return ([af, pe] if geometric else []) + [ji, er]


def _port_augs(d, geometric):
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    ones = torch.ones(len(d["sf"]))

    def af(gen, x):
        out = augment.af_apply(x, *map(t, d["af"]))
        return torch.where(t(d["af_on"])[:, None, None, None], out, x)

    def pe(gen, x):
        out = augment.pe_apply(x, *map(t, d["pe"]))
        return torch.where(t(d["pe_on"])[:, None, None, None], out, x)

    def ji(gen, x):
        out = augment.ji_apply(x.float(), ones, ones, t(d["sf"]), t(d["hf"]), None)
        return torch.where(t(d["ji_on"])[:, None, None, None], out.to(x.dtype), x)

    def er(gen, x):
        box = [t(v) for v in d["box"]]
        return torch.where(t(d["er_on"])[:, None, None, None], augment.er_apply(x, *box), x)

    return ([af, pe] if geometric else []) + [ji, er]


def _rigs(clip_cfg=None, knobs=KNOBS, vgg_sd=None):
    """The JAX loss_fn with its params, and the port's train step on the same
    weights; the "tiny" CLIP, or one built from `clip_cfg`; the mapper of
    `knobs`; the VGG16 of the diversity term from the torchvision state dict
    `vgg_sd`, where given."""
    cfg = j_make_config(augs=["Cc"], **knobs)
    if clip_cfg is None:
        perceptor = j_load_perceptor("tiny", dtype=jnp.float32)
    else:
        jm = jclip.make_clip_from_config(clip_cfg, dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32),
                     jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
        perceptor = jperceptor.Perceptor(jm, jp, "tiny", SIZE, clip_cfg["embed_dim"])
    arch = j_vqgan_arch(cfg)
    vq = j_make_vqgan(arch, dtype=jnp.float32)
    vq_params = jax.jit(vq.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 8)))
    # a codebook of unit spread instead of the init's [0, 2/n_embed): with codes that
    # close, the tiny decoder's per-channel GroupNorms see near-constant groups and
    # E[x^2] - E[x]^2 cancels, so rounding alone would move the grads by ~1e-3
    codebook = np.random.default_rng(5).normal(size=(32, 8)).astype(np.float32)
    # and a gentler output layer, so no pixel saturates: at a clamped pixel the TV
    # term's neighbour differences are exactly 0, where jnp.abs's gradient is 1 and
    # torch's (the reference's) 0
    dec = dict(vq_params["params"]["decoder"])
    dec["conv_out"] = jax.tree.map(lambda a: 0.2 * a, dec["conv_out"])
    vq_params = {"params": {**vq_params["params"], "codebook": jnp.asarray(codebook),
                            "decoder": dec}}
    vgg_module = vgg_params = tvgg = None
    if vgg_sd is not None:
        vgg_module = JVGG16Features(dtype=jnp.float32)
        vgg_params = convert_vgg16({k: v.numpy() for k, v in vgg_sd.items()})
        tvgg = VGG16Features()
        tvgg.load_state_dict(vgg_sd)
        tvgg.eval().requires_grad_(False)
    frozen = jloop.FrozenModels(perceptor, vq, vq_params, vgg_module, vgg_params, None)
    mapper = j_build_mapper(dict(cfg), vq_channels=8, dtype=jnp.float32)
    params = jax.jit(mapper.init)(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 32 + int(knobs["noise_dim"]))))
    jmc = JMakeCutouts(cut_size=SIZE, cutn=CUTN, augs=["Cc"], pool_size=SIZE, noise_fac=0.0)
    _, loss_fn = jloop.make_train_step(cfg, mapper, frozen, jmc, inp_is_tokens=True,
                                       out_is_tokens=True)
    fz = {"clip": perceptor.params, "vq": vq_params}
    if vgg_params is not None:
        fz["vgg"] = vgg_params

    clip = (make_clip("tiny", device="cpu", image=True) if clip_cfg is None
            else make_clip_from_config(clip_cfg, device="cpu", image=True))
    clip.load_state_dict(clip_state_dict(perceptor.params))
    tvq = make_vqgan(TINY_VQ, device="cpu")
    tvq.load_state_dict(vqgan_state_dict(vq_params))
    tfrozen = FrozenModels(Perceptor(clip.eval().requires_grad_(False), "tiny", 32, 32),
                           tvq.eval().requires_grad_(False), vgg=tvgg)
    tmap = build_mapper(dict(knobs), vq_channels=8, device="cpu")
    tmap.load_state_dict(MAPPER_STATE_DICT[knobs["model_type"]](params))
    mc = MakeCutouts(cut_size=SIZE, cutn=CUTN, pool_size=SIZE, augs=["Ji", "Er"],
                     noise_fac=0.0)
    step, tloss_fn = make_train_step(make_config(augs=["Ji", "Er"], **knobs), tmap, tfrozen,
                                     mc, inp_is_tokens=True, out_is_tokens=True)
    return (loss_fn, params, fz, jmc, frozen), (step, tloss_fn, tmap, mc, tfrozen)


@pytest.mark.parametrize("augs", ["neutralised", "ji_er_pinned", "af_pe_ji_er_pinned",
                                  "unpooled_center_crop"])
def test_train_step_loss_and_grads_match_jax(rng, augs):
    (loss_fn, params, fz, jmc, _), (_, tloss_fn, tmap, mc, _) = _rigs()
    if augs == "neutralised":
        mc.augs = []
    elif augs == "unpooled_center_crop":  # the JAX side's augs are ["Cc"] already
        jmc.pool = mc.pool = False
        mc.augs = augment.build_augment_pipeline(["Cc"], SIZE)
    else:
        draws = _pinned_draws(rng)
        geometric = augs.startswith("af_pe")
        jmc.augs = _jax_augs(draws, geometric)
        mc.augs = _port_augs(draws, geometric)
    toks = _tokens()
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, fz, {"inp": jnp.asarray(toks), "out": jnp.asarray(toks)},
        jax.random.PRNGKey(0))
    tt = torch.from_numpy(toks).long()
    loss, metrics = tloss_fn({"inp": tt, "out": tt}, torch.Generator().manual_seed(0))
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    for k in ("dists", "l2", "tv", "diversity"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-5, atol=1e-7)
    want = mixer_state_dict(jax.tree.map(np.asarray, j_grads))
    got = {n: p.grad for n, p in tmap.named_parameters()}
    assert sorted(want) == sorted(got)
    top = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        err = float((got[n] - g).abs().max())
        assert err <= 1e-4 * (float(g.abs().max()) + 1e-3 * top), n


def test_vitgan_train_step_matches_jax(rng):
    """The step with a VitGAN Generator mapper (its module path, as on the card)
    and the default augmentations Af, Pe, Ji, Er at numpy-pinned draws: loss and
    every mapper gradient, within the tolerances above."""
    (loss_fn, params, fz, jmc, _), (_, tloss_fn, tmap, mc, _) = _rigs(knobs=VITGAN_KNOBS)
    draws = _pinned_draws(rng)
    jmc.augs = _jax_augs(draws, True)
    mc.augs = _port_augs(draws, True)
    toks = _tokens()
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, fz, {"inp": jnp.asarray(toks), "out": jnp.asarray(toks)},
        jax.random.PRNGKey(0))
    tt = torch.from_numpy(toks).long()
    loss, _ = tloss_fn({"inp": tt, "out": tt}, torch.Generator().manual_seed(0))
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    want = vitgan_generator_state_dict(jax.tree.map(np.asarray, j_grads))
    got = {n: p.grad for n, p in tmap.named_parameters()}
    assert sorted(want) == sorted(got)
    top = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        err = float((got[n] - g).abs().max())
        assert err <= 1e-4 * (float(g.abs().max()) + 1e-3 * top), n


@pytest.mark.parametrize("mode", ["between_same_prompts", "all"])
def test_diversity_train_step_matches_jax(rng, mode):
    """The step with `diversity_coef` 0.5: VGG16 features of the 16-px renders
    (the Mixer over 8 x 8 tokens; relu5_3 at 1 x 1) from the same numpy weights on
    both sides, noise_dim 4 with the batch's noise rows (one per repeat, so the
    repeats of a prompt differ), the default augmentations Af, Pe, Ji, Er at
    numpy-pinned draws: loss (1e-5 relative), the `diversity` metric (1e-4
    relative, and > 0: the sum of the normalised differences of features that
    went through 13 float32 convolutions of another library; 2.0e-5 read in
    "all" mode) and every mapper gradient within 1e-4 of its max |JAX grad| plus
    1e-6 of the
    largest grad of all (the floor above is 1e-7: the token-FF output bias, zero
    but for rounding, reads 1.2e-7 of the largest grad here, where the VGG16
    term's grads add in)."""
    knobs = dict(KNOBS, vq_image_size=8, noise_dim=4, diversity_coef=0.5, diversity_mode=mode)
    (loss_fn, params, fz, jmc, _), (_, tloss_fn, tmap, mc, _) = _rigs(
        knobs=knobs, vgg_sd=vgg_state_dict(9))
    draws = _pinned_draws(rng)
    jmc.augs = _jax_augs(draws, True)
    mc.augs = _port_augs(draws, True)
    toks = _tokens()
    noise = rng.normal(size=(REPEAT, 4)).astype(np.float32)
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, fz, {"inp": jnp.asarray(toks), "out": jnp.asarray(toks),
                     "noise": jnp.asarray(noise)}, jax.random.PRNGKey(0))
    tt = torch.from_numpy(toks).long()
    loss, metrics = tloss_fn({"inp": tt, "out": tt, "noise": torch.from_numpy(noise)},
                             torch.Generator().manual_seed(0))
    loss.backward()
    assert float(j_metrics["diversity"]) > 0
    assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    for k in ("dists", "l2", "tv"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(metrics["diversity"]), float(j_metrics["diversity"]),
                               rtol=1e-4)
    want = mixer_state_dict(jax.tree.map(np.asarray, j_grads))
    got = {n: p.grad for n, p in tmap.named_parameters()}
    assert sorted(want) == sorted(got)
    top = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        err = float((got[n] - g).abs().max())
        assert err <= 1e-4 * (float(g.abs().max()) + 1e-2 * top), n


def test_build_frozen_draws_the_vgg_only_for_the_diversity_term(monkeypatch):
    """build_frozen builds the VGG16 (random from seed + 1 without `vgg_path`)
    where `diversity_coef` is set, and make_train_step needs it there."""
    cfg = make_config(**dict(KNOBS, vq_image_size=8))
    assert loop.build_frozen(cfg, torch.float32, device="cpu").vgg is None
    frozen = loop.build_frozen(make_config(**dict(cfg, diversity_coef=1.0)), torch.float32,
                               device="cpu", seed=3)
    want = VGG16Features().init_random_(torch.Generator().manual_seed(4))
    assert torch.equal(frozen.vgg.features[0].weight, want.features[0].weight)
    mc = MakeCutouts(cut_size=SIZE, cutn=CUTN, pool_size=SIZE, augs=[], noise_fac=0.0)
    with pytest.raises(ValueError, match="VGG16"):
        make_train_step(make_config(**dict(cfg, diversity_coef=1.0)), build_mapper(
            dict(cfg), vq_channels=8, device="cpu"), frozen._replace(vgg=None), mc,
            inp_is_tokens=True, out_is_tokens=True)


def test_train_entry_takes_another_mapper_and_perceptor():
    """entry.train_entry with `mapper_config`: a VitGAN mapper, the tiny CLIP (its
    32-px input is the cutouts' size) and the tiny VQGAN (its channels the
    mapper's); two steps move every parameter with a grad, losses finite."""
    cfg = dict(clip_model="tiny", model_type="vitgan", dim=16, depth=1, vq_image_size=8,
               num_heads=3, vqgan_arch=TINY_VQ)
    step_fn, state, batch = train_entry("cpu", batch=2, cutn=2, mapper_config=cfg)
    assert sum(p.numel() for p in state.params) == sum(
        p.numel() for p in build_mapper(cfg, vq_channels=8).parameters())
    before = [p.detach().clone() for p in state.params]
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        state, metrics = step_fn(state, batch, gen)
        assert bool(torch.isfinite(metrics["loss"]))
    assert all(not torch.equal(a, p.detach()) for a, p in zip(before, state.params))


def test_train_step_with_fused_tower_matches_jax(monkeypatch):
    clip_cfg = dict(CLIP_VIT_CONFIGS["tiny"], vision_width=128, vision_heads=4)
    real_j = jclip_fused.make_clip_image_apply
    monkeypatch.setattr(jclip_fused, "make_clip_image_apply",
                        lambda module, fused=None: real_j(module, fused=True, interpret=True))
    calls = []
    real = clip_fused.encode_image_fused
    monkeypatch.setattr(clip_fused, "encode_image_fused",
                        lambda m, x: calls.append(x.shape) or real(m, x))
    monkeypatch.setattr(loop, "make_clip_image_apply",
                        lambda module: clip_fused.make_clip_image_apply(module, fused=True))
    (loss_fn, params, fz, _, _), (_, tloss_fn, tmap, mc, _) = _rigs(clip_cfg)
    mc.augs = []
    toks = _tokens(4)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, fz, {"inp": jnp.asarray(toks), "out": jnp.asarray(toks)},
        jax.random.PRNGKey(0))
    tt = torch.from_numpy(toks).long()
    loss, _ = tloss_fn({"inp": tt, "out": tt}, torch.Generator().manual_seed(0))
    loss.backward()
    assert calls == [(CUTN * REPEAT * 4, SIZE, SIZE, 3)]
    assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    want = mixer_state_dict(jax.tree.map(np.asarray, j_grads))
    got = {n: p.grad for n, p in tmap.named_parameters()}
    top = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        err = float((got[n] - g).abs().max())
        assert err <= 1e-4 * (float(g.abs().max()) + 1e-3 * top), n


def test_train_step_updates_state_with_adam():
    """train_step runs loss, backward and the cast-state Adam in place: the step
    count, the loss EMA and the parameters move; the launch-free CPU path."""
    _, (step, _, tmap, _, _) = _rigs()
    state = make_train_state(tmap.parameters(), make_optimizer(1e-3, opt_dtype="bfloat16"))
    before = [p.detach().clone() for p in state.params]
    tt = torch.from_numpy(_tokens()).long()
    gen = torch.Generator().manual_seed(0)
    state, metrics = step(state, {"inp": tt, "out": tt}, gen)
    state, metrics = step(state, {"inp": tt, "out": tt}, gen)
    assert state.step == 2 and state.opt_state.count == 2
    assert set(metrics) == {"loss", "dists", "diversity", "l2", "tv"}
    assert bool(torch.isfinite(metrics["loss"]))
    assert abs(float(state.avg_loss) - 1.0) > 0
    assert all(m.dtype == torch.bfloat16 for m in state.opt_state.mu)
    moved = [not torch.equal(a, p.detach()) for a, p in zip(before, state.params)]
    assert sum(moved) >= len(moved) - 2  # all but grads that are zero

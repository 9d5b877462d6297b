"""The port's trainer (train/loop.train, train/state.py, data/datasets.py,
io/checkpoint.py, cli.py) on the CPU, at the tiny config of
tests/test_train_e2e.py, and its host-side pieces against the JAX package's.

Tolerances: the interrupted-and-resumed run equals the uninterrupted one bit
for bit (the per-step generator, the (seed, step)-keyed noise rows and exact
checkpoint round trips); batches and noise rows equal JAX's exactly (both are
numpy); Adam, clipping, the cosine schedule and the EMA within 1e-6 relative of
JAX's over 5 updates (float32 sums in another order); the JAX package's
`load_model` of the port's checkpoint gives the port's mapper output within
1e-5 (float32, the same weights).
"""

import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from feed_forward_vqgan_clip_tpu import config as jconfig
from feed_forward_vqgan_clip_tpu.data import datasets as jdata
from feed_forward_vqgan_clip_tpu.io import checkpoint as jckpt
from feed_forward_vqgan_clip_tpu.train import state as jstate
from feed_forward_vqgan_clip_tpu_torch import cli
from feed_forward_vqgan_clip_tpu_torch import config
from feed_forward_vqgan_clip_tpu_torch.data import datasets
from feed_forward_vqgan_clip_tpu_torch.infer import Generator
from feed_forward_vqgan_clip_tpu_torch.io import checkpoint
from feed_forward_vqgan_clip_tpu_torch.train import loop
from feed_forward_vqgan_clip_tpu_torch.train.state import make_optimizer, make_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_VQ = dict(n_embed=32, embed_dim=8, z_channels=8, ch=8, ch_mult=(1, 2),
               num_res_blocks=1, attn_resolutions=(4,), resolution=8)


def _cfg(folder, **kw):
    cfg = dict(clip_model="tiny", vqgan_arch=TINY_VQ, model_type="mlp_mixer", dim=16, depth=1,
               dropout=0, vq_image_size=4, batch_size=8, repeat=1, cutn=2, cut_size=32,
               pool_size=32, lr=1e-3, epochs=100, max_steps=3, log_interval=2,
               folder=str(folder), compute_dtype="float32", noise_dim=0, seed=0)
    cfg.update(kw)
    return config.make_config(**cfg)


@pytest.fixture
def token_data(tmp_path):
    path = os.path.join(tmp_path, "toks.npz")
    toks = np.zeros((16, 77), np.int32)
    toks[:, 0] = 49406
    toks[:, 1] = np.arange(16) + 5
    toks[:, 2] = 49407
    np.savez(path, tokens=toks)
    return path


@pytest.fixture
def feature_data(tmp_path):
    path = os.path.join(tmp_path, "feats.npz")
    rng = np.random.default_rng(0)
    np.savez(path, x=rng.normal(size=(16, 32)).astype(np.float32),
             y=rng.normal(size=(16, 32)).astype(np.float32))
    return path


def test_token_dataset_artifacts_resume_and_checkpoint_read_by_jax(tmp_path, token_data):
    """Train on tokens, check the run folder, resume, generate from the
    checkpoint, and read it with the JAX package's load_model."""
    state = loop.train(_cfg(tmp_path, path=token_data, max_steps=2), device="cpu")
    assert state.step == 2
    for name in ("checkpoint.th", "opt.th", "progress.png", "fixed_batch_progress.png",
                 "progress_0000000000.png"):
        assert (tmp_path / name).exists(), name
    assert not (tmp_path / "checkpoint_ema.th").exists()
    assert torch.load(tmp_path / "checkpoint.th", weights_only=False)["step"] == 2

    state = loop.train(_cfg(tmp_path, path=token_data, max_steps=4), device="cpu")
    assert state.step == 4 and state.opt_state.count == 4

    gen = Generator.from_checkpoint(str(tmp_path / "checkpoint.th"), device="cpu")
    h = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 32)).astype(np.float32))
    imgs = gen.generate(h, nb_repeats=2, seed=1)
    assert imgs.shape == (4, 8, 8, 3) and float(imgs.min()) >= 0 and float(imgs.max()) <= 1

    jmapper, jparams, jcfg, jnoise = jckpt.load_model(str(tmp_path / "checkpoint.th"))
    mapper, _, _ = checkpoint.load_model(str(tmp_path / "checkpoint.th"), device="cpu")
    want = np.asarray(jmapper.apply(jparams, jnp.asarray(h.numpy())))
    np.testing.assert_allclose(mapper(h).detach().numpy(), want, atol=1e-5)
    assert jnoise is None and int(jcfg.get("depth")) == 1


def test_feature_pairs_all_knobs(tmp_path, feature_data):
    """input_loss, l2, tv, normalize_input, repeat 2, a noise bank, EMA, the
    cosine schedule, clipping, dropout 0.1 and bf16 moments in one run; then
    generation with the restored bank."""
    cfg = _cfg(tmp_path, path=feature_data, input_loss=True, l2_coef=0.1, tv_coef=0.1,
               normalize_input=True, repeat=2, noise_dim=8, nb_noise=4, use_ema=True,
               ema_decay=0.9, scheduler="cosine", clip_grad_norm=1.0, max_steps=3, dropout=0.1,
               opt_dtype="bfloat16")
    state = loop.train(cfg, device="cpu")
    assert state.step == 3
    assert all(m.dtype == torch.bfloat16 for m in state.opt_state.mu + state.opt_state.nu)
    sd, _, step, _, noise = checkpoint.load_checkpoint(str(tmp_path / "checkpoint.th"))
    assert step == 3 and noise.shape == (4, 8)
    ema, *_ = checkpoint.load_checkpoint(str(tmp_path / "checkpoint_ema.th"))
    assert sorted(ema) == sorted(sd)
    assert any(not torch.equal(ema[k], sd[k]) for k in sd)
    opt = torch.load(tmp_path / "opt.th", weights_only=False)
    assert opt["step"] == opt["count"] == 3 and sorted(opt["mu"]) == sorted(sd)

    gen = Generator.from_checkpoint(str(tmp_path / "checkpoint.th"), device="cpu")
    assert gen.noise_bank is not None
    h = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 32)).astype(np.float32))
    assert gen.generate(h, nb_repeats=3, seed=0).shape == (3, 8, 8, 3)


def test_resume_reproduces_uninterrupted_run_bitwise(tmp_path, feature_data):
    """4 steps uninterrupted against 2 + 2 resumed: equal parameters and EMA,
    bit for bit, with a noise bank, dropout masks and clipping in the step."""
    kw = dict(path=feature_data, noise_dim=8, nb_noise=4, use_ema=True, log_interval=100,
              dropout=0.1, clip_grad_norm=1.0)
    a = loop.train(_cfg(tmp_path / "a", max_steps=4, **kw), device="cpu")
    loop.train(_cfg(tmp_path / "b", max_steps=2, **kw), device="cpu")
    b = loop.train(_cfg(tmp_path / "b", max_steps=4, **kw), device="cpu")
    assert a.step == b.step == 4
    for pa, pb in zip(a.params, b.params):
        assert torch.equal(pa, pb)
    for ea, eb in zip(a.ema_params, b.ema_params):
        assert torch.equal(ea, eb)


@pytest.mark.parametrize("family", [
    dict(model_type="vitgan", vq_image_size=8, num_heads=3),
    dict(model_type="simple_vitgan", num_heads=3),
    dict(model_type="xtransformer", num_heads=2),
], ids=lambda f: f["model_type"])
def test_other_mapper_families_resume_bitwise_and_load_in_jax(tmp_path, feature_data, family):
    """train() with each non-Mixer mapper: 4 steps uninterrupted against 2 + 2
    resumed, parameters, EMA and Adam moments bit for bit; the checkpoint that
    the run wrote is read by both packages' load_model to the same outputs
    (float32, within 1e-5 of max |JAX|)."""
    kw = dict(path=feature_data, use_ema=True, log_interval=100, **family)
    a = loop.train(_cfg(tmp_path / "a", max_steps=4, **kw), device="cpu")
    loop.train(_cfg(tmp_path / "b", max_steps=2, **kw), device="cpu")
    b = loop.train(_cfg(tmp_path / "b", max_steps=4, **kw), device="cpu")
    assert a.step == b.step == 4 and b.opt_state.count == 4
    for pa, pb in zip(a.params + a.ema_params + a.opt_state.mu, b.params + b.ema_params
                      + b.opt_state.mu):
        assert torch.equal(pa, pb)

    path = str(tmp_path / "b" / "checkpoint.th")
    mapper, got_cfg, _ = checkpoint.load_model(path, device="cpu")
    jmapper, jparams, jcfg, _ = jckpt.load_model(path)
    assert got_cfg["model_type"] == jcfg.get("model_type") == family["model_type"]
    for p, q in zip(mapper.parameters(), b.params):
        assert torch.equal(p, q)
    h = np.random.default_rng(0).normal(size=(2, 32)).astype(np.float32)
    want = np.asarray(jmapper.apply(jparams, jnp.asarray(h)))
    with torch.no_grad():
        got = mapper(torch.from_numpy(h)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("cutouts", [
    dict(pool=False, augs=["Re", "Af", "Pe", "Ji", "Er"]),
    dict(pool_size=48, augs=["Af", "Pe", "Ji"], fuse_geometric=True, interpolate=True,
         interp_size=32),
], ids=["unpooled_re", "fused_interpolate"])
def test_cutout_configs_resume_bitwise(tmp_path, feature_data, cutouts):
    """The other cutout modes through train(): the unpooled 8-px renders cut by Re
    to 32 px, and 48-px pools through the fused Af-then-Pe warp, averaged down to
    32 px; 4 steps against 2 + 2 resumed, bit for bit."""
    kw = dict(path=feature_data, use_ema=True, log_interval=100, **cutouts)
    a = loop.train(_cfg(tmp_path / "a", max_steps=4, **kw), device="cpu")
    loop.train(_cfg(tmp_path / "b", max_steps=2, **kw), device="cpu")
    b = loop.train(_cfg(tmp_path / "b", max_steps=4, **kw), device="cpu")
    assert a.step == b.step == 4
    for pa, pb in zip(a.params + a.ema_params + a.opt_state.mu, b.params + b.ema_params
                      + b.opt_state.mu):
        assert torch.equal(pa, pb)


def test_cli_train_on_the_cpu(tmp_path, feature_data):
    cfg = dict(_cfg(tmp_path / "run", path=feature_data, max_steps=1))
    cfg["vqgan_arch"] = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY_VQ.items()}
    path = tmp_path / "run.yaml"
    path.write_text(yaml.safe_dump(cfg))
    cli.main(["train", str(path), "--device", "cpu"])
    assert checkpoint.checkpoint_exists(str(tmp_path / "run"))
    args = cli.build_parser().parse_args(["bench"])  # the last JAX subcommand, now ported
    assert args.command == "bench" and args.mode == "all"


@pytest.mark.parametrize("n,bs,epoch,proc,count,drop_last", [
    (16, 8, 0, 0, 1, False), (16, 8, 3, 0, 1, False), (21, 8, 1, 0, 1, False),
    (21, 8, 1, 0, 1, True), (5, 8, 0, 0, 1, False), (21, 4, 2, 1, 3, False),
])
def test_epoch_batches_equal_jax(n, bs, epoch, proc, count, drop_last):
    kw = dict(seed=7, epoch=epoch, process_index=proc, process_count=count, drop_last=drop_last)
    got = datasets.epoch_shard_batches(n, bs, **kw)
    want = jdata.epoch_shard_batches(n, bs, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(datasets.shard_for_process(n, proc, count),
                                  jdata.shard_for_process(n, proc, count))


@pytest.mark.parametrize("step", [0, 1, 5, 123])
def test_noise_rows_equal_jax(step):
    """The JAX trainer's `batch_for` draw: default_rng((seed, step)).permutation(
    len(bank))[:repeat]."""
    want = np.random.default_rng((3, step)).permutation(10)[:2]
    np.testing.assert_array_equal(loop.noise_bank_rows(3, step, 10, 2), want)


def test_trainer_draws_the_noise_rows_of_each_step(tmp_path, feature_data, monkeypatch):
    seen = []
    real = loop.make_train_step

    def spy(*a, **k):
        step_fn, loss_fn = real(*a, **k)

        def wrapped(state, batch, gen, mark=None):
            seen.append((state.step, batch["noise"].numpy().copy()))
            return step_fn(state, batch, gen, mark)

        return wrapped, loss_fn

    monkeypatch.setattr(loop, "make_train_step", spy)
    loop.train(_cfg(tmp_path, path=feature_data, noise_dim=8, nb_noise=4, repeat=2,
                    log_interval=100), device="cpu")
    bank, *_ = checkpoint.load_checkpoint(str(tmp_path / "checkpoint.th"))[4:]
    assert [s for s, _ in seen] == [0, 1, 2]
    for s, rows in seen:
        np.testing.assert_array_equal(rows, bank.numpy()[loop.noise_bank_rows(0, s, 4, 2)])


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("scheduler", [None, "cosine"])
def test_optimizer_and_ema_equal_jax(scheduler, clip, opt_dtype):
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(scheduler=scheduler, max_steps=5, clip_grad_norm=clip, opt_dtype=opt_dtype)
    jst = jstate.make_train_state({k: jnp.asarray(v) for k, v in init.items()},
                                  jstate.make_optimizer(1e-2, **kw), use_ema=True, ema_decay=0.9)
    params = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in shapes]
    st = make_train_state(params, make_optimizer(1e-2, **kw), use_ema=True, ema_decay=0.9)
    # grad norms from about 0.07 to 40: clipping acts at some steps and not others
    for scale in (0.01, 5.0, 0.3, 2.0, 0.05):
        grads = {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
        jst = jst.apply_gradients({k: jnp.asarray(v) for k, v in grads.items()})
        for p, k in zip(params, shapes):
            p.grad = torch.from_numpy(grads[k])
        st.apply_gradients()
    assert st.step == int(jst.step) == 5
    for i, k in enumerate(shapes):
        for got, want in ((params[i], jst.params[k]), (st.ema_params[i], jst.ema_params[k])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.detach().numpy(), want,
                                       atol=1e-6 * np.abs(want).max())


def test_config_copy_equals_jax():
    assert config.DEFAULTS == jconfig.DEFAULTS
    path = os.path.join(REPO, "configs", "smoke.yaml")
    assert dict(config.load_config(path)) == dict(jconfig.load_config(path))
    cfg = config.make_config(vqgan_arch=TINY_VQ)
    assert config.vqgan_arch_config(cfg) == jconfig.vqgan_arch_config(jconfig.make_config(
        vqgan_arch=TINY_VQ))
    assert config.resolved_clip_geometry(cfg) == jconfig.resolved_clip_geometry(cfg)


def test_eval_resize_is_jax_bilinear():
    """The in-train eval's resize against jax.image.resize(..., "bilinear") at the
    flagship's 256 -> 224 (antialiased) and at a tiny upsample: within 1e-5."""
    rng = np.random.default_rng(0)
    for h, s in ((256, 224), (8, 32)):
        x = rng.random((2, h, h, 3)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, s, s, 3), "bilinear"))
        got = loop.resize_bilinear(torch.from_numpy(x), s).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_in_train_eval_runs(tmp_path, feature_data, capsys):
    """eval_path: the eval pass runs at each log step and prints its means."""
    state = loop.train(_cfg(tmp_path, path=feature_data, eval_path=feature_data, max_steps=1),
                       device="cpu")
    assert state.step == 1
    out = capsys.readouterr().out
    assert "Eval dists: " in out and "Eval clip score: " in out


MERGES = ["h e", "l l", "he ll", "hell o</w>", "w o", "r l", "wo rl", "worl d</w>"]


def test_dataset_loaders_equal_jax(tmp_path):
    """Every format load_dataset reads gives JAX's arrays; prompts go through the
    port's tokenizer (.txt: one prompt a line; a glob: one a file)."""
    table = tmp_path / "merges.txt.gz"
    with gzip.open(table, "wt", encoding="utf-8") as fd:
        fd.write("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    (tmp_path / "prompts.txt").write_text("hello world\nworld hello\nhello\n")
    for i, text in enumerate(("hello", "world")):
        (tmp_path / f"p{i}.prompt").write_text(text + "\n")
    toks = np.arange(2 * 77, dtype=np.int32).reshape(2, 77)
    x, y = (np.random.default_rng(i).normal(size=(3, 4)).astype(np.float32) for i in (0, 1))
    np.savez(tmp_path / "t.npz", tokens=toks)
    np.savez(tmp_path / "xy.npz", x=x, y=y)
    np.save(tmp_path / "t.npy", toks)
    torch.save(torch.from_numpy(toks), tmp_path / "t.th")
    torch.save((torch.from_numpy(x), torch.from_numpy(y)), tmp_path / "xy.pt")
    datasets.save_tokens(toks, str(tmp_path / "saved.npz"))
    for name in ("prompts.txt", "p*.prompt", "t.npz", "xy.npz", "t.npy", "t.th", "xy.pt",
                 "saved.npz"):
        path = str(tmp_path / name)
        got = datasets.load_dataset(path, bpe_path=str(table))
        want = jdata.load_dataset(path, bpe_path=str(table))
        for g, w in zip(*((v if isinstance(v, tuple) else (v,)) for v in (got, want))):
            np.testing.assert_array_equal(g, w)
    assert datasets.load_dataset(str(tmp_path / "prompts.txt"), str(table)).shape == (3, 77)


def test_profile_dir_writes_a_trace(tmp_path, feature_data):
    """profile_dir: a torch.profiler trace of steps [10, 15)."""
    loop.train(_cfg(tmp_path, path=feature_data, max_steps=16, log_interval=100,
                    profile_dir=str(tmp_path / "trace")), device="cpu")
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0

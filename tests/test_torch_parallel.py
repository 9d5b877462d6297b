"""Multi-device training on torch.distributed against the JAX package's mesh.

The port's processes are real OS processes of one Gloo process group
(parallel/multiproc.run_processes, a `file://` rendezvous in tmp_path, a
deadline each), running tests/torch_parallel_workers.py; the JAX side runs on
the 8 virtual CPU devices of tests/conftest.py.

  * make_mesh's shape rules and rank layout against JAX make_mesh;
  * the tensor-parallel plan of each mapper family against JAX
    `mapper_param_sharding`, through io/from_jax.py's names;
  * one train step on 2 ranks {data: 2} against JAX's step on a {data: 2} mesh
    and against the port's single-device step, on the same global batch and
    weights, augmentations neutralised: without noise, with the bank's rows,
    with noise drawn at the global shape, and with the diversity term over the
    whole batch;
  * one step on 2 ranks {model: 2} against JAX on {data: 1, model: 2}
    (gathered gradients, the global norm of the clipping), and each family's
    tensor-parallel forward and input gradient against its unsharded module,
    dropout on;
  * the whole trainer on 4 ranks {data: 2, model: 2}; a resume there bitwise;
    a 2-rank checkpoint resumed in 1 process; mesh_shape {data: 1} bitwise;
  * train_prior on 2 ranks against 1, its bitwise resume, JAX's file split;
  * the webdataset encoder on 2 ranks through the CLI;
  * utils.maybe_initialize_distributed's triggers.

Tolerances are test_torch_train_step.py's: loss 1e-5 relative, each gradient
within 1e-4 of its max |reference| plus 1e-3 of the largest of all (float32
sums in other orders).
"""

import functools
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_prior as tprior
import test_torch_train_step as tts
from feed_forward_vqgan_clip_tpu.io.checkpoint import load_model as j_load_model
from feed_forward_vqgan_clip_tpu.models.mappers import build_mapper as j_build_mapper
from feed_forward_vqgan_clip_tpu.parallel import mesh as jmesh
from feed_forward_vqgan_clip_tpu.train import loop as jloop
from feed_forward_vqgan_clip_tpu.train import prior as jprior
from feed_forward_vqgan_clip_tpu_torch import utils
from feed_forward_vqgan_clip_tpu_torch.data import encode
from feed_forward_vqgan_clip_tpu_torch.io import checkpoint as ckpt_io
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import mapper_state_dict, mixer_state_dict
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
from feed_forward_vqgan_clip_tpu_torch.parallel import mesh, multiproc
from feed_forward_vqgan_clip_tpu_torch.train import prior
from feed_forward_vqgan_clip_tpu_torch.train.state import make_optimizer, make_train_state
from test_torch_encode import _shards, clip_file  # noqa: F401
from test_torch_serve import bpe_table  # noqa: F401
from test_torch_vgg import vgg_state_dict

TESTS = str(Path(__file__).resolve().parent)
TIMEOUT = 240


def run(tmp, n, worker, job=None, **kw):
    """torch_parallel_workers.<worker> on n processes; -> their outputs."""
    os.makedirs(tmp, exist_ok=True)
    if job is not None:
        torch.save(job, os.path.join(tmp, "job.pt"))
    return multiproc.run_processes(n, f"torch_parallel_workers:{worker}", tmp=str(tmp),
                                   timeout=TIMEOUT, device="cpu", pythonpath=[TESTS], **kw)


def load(tmp, name, rank=0):
    return torch.load(os.path.join(tmp, f"{name}_{rank}.pt"), weights_only=False)


def assert_grads_close(got, want, floor=1e-3):
    top = max(float(g.abs().max()) for g in want.values())
    assert sorted(got) == sorted(want)
    for n, g in want.items():
        err = float((got[n] - g).abs().max())
        assert err <= 1e-4 * (float(g.abs().max()) + floor * top), (n, err)


# ------------------------------------------------------------------------ the mesh

SHAPES = [None, {"data": 8}, {"model": 2}, {"data": 4, "model": 2}, {"data": 2},
          {"data": 2, "model": 4}, {"model": 8}, {"data": 3}, {"data": 4, "model": 4},
          {"model": 3}]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_mesh_shape_resolves_as_jax(shape):
    """Over 8 devices: the defaults, a missing axis, and JAX's error text."""
    try:
        jm = jmesh.make_mesh(shape, jax.devices()[:8])
        want = (jm.shape["data"], jm.shape["model"])
    except ValueError as e:
        want = str(e)
    try:
        got = mesh.resolve_shape(shape, 8)
    except ValueError as e:
        got = str(e)
    assert got == want


@pytest.mark.parametrize("shape", [None, {"data": 1}, {"model": 1}, {"data": 2}],
                         ids=str)
def test_single_process_mesh(shape):
    """Without a process group make_mesh is the single device 1 x 1 (no groups);
    a shape it cannot cover raises as JAX's does on one device."""
    try:
        jm = jmesh.make_mesh(shape, jax.devices()[:1])
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("{", r"\{").replace("}", r"\}")):
            mesh.make_mesh(shape)
        return
    m = mesh.make_mesh(shape)
    assert (m.data, m.model) == (jm.shape["data"], jm.shape["model"]) == (1, 1)
    assert m.data_group is None and m.model_group is None and mesh.is_primary()


def test_gradient_mean_over_one_data_rank_sends_nothing(monkeypatch):
    """At d == 1 (a world of one, or each rank of a TP-only mesh) the mean is
    the identity: no collective, the gradients and metrics the same objects,
    an absent gradient left absent."""
    def no_collective(*a, **k):
        raise AssertionError("a collective at d == 1")

    monkeypatch.setattr(torch.distributed, "all_reduce", no_collective)
    a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))
    a.grad = torch.arange(3.0)
    metrics = {"loss": torch.tensor(2.0, dtype=torch.bfloat16)}
    for m in (mesh.Mesh(), mesh.Mesh(data=1, model=2, data_group=object())):
        grad = a.grad
        assert mesh.all_reduce_grads_mean([a, b], m, metrics) is metrics
        assert a.grad is grad and b.grad is None


MAPPERS = {
    "mlp_mixer": dict(clip_model="tiny", model_type="mlp_mixer", dim=16, depth=2,
                      vq_image_size=4, noise_dim=0, dropout=0.1),
    "vitgan": dict(clip_model="tiny", model_type="vitgan", dim=16, depth=2, vq_image_size=8,
                   num_heads=4, noise_dim=0, dropout=0.1),
    "xtransformer": dict(clip_model="tiny", model_type="xtransformer", dim=32, depth=2,
                         vq_image_size=2, noise_dim=0, dropout=0.1),
}


def _split_axis(a):
    """The one axis along which `a` varies (the marker's), or None."""
    axes = [ax for ax in range(a.ndim) if a.shape[ax] > 1 and np.any(np.diff(a, axis=ax))]
    assert len(axes) <= 1
    return axes[0] if axes else None


@pytest.mark.parametrize("family", sorted(MAPPERS))
def test_tp_plan_equals_jax_sharding(family):
    """Each leaf of JAX's mapper params filled with the index along its 'model'
    axis (zero where replicated), converted by io/from_jax.py: the port's
    tensors that vary, and along which axis, are mapper_tp_plan's."""
    cfg = MAPPERS[family]
    jm = j_build_mapper(dict(cfg), vq_channels=8, dtype=jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32)))
    shardings = jmesh.mapper_param_sharding(
        jmesh.make_mesh({"data": 4, "model": 2}, jax.devices()[:8]), params)

    def marker(leaf, sharding):
        spec = tuple(sharding.spec) + (None,) * (leaf.ndim - len(sharding.spec))
        if "model" not in spec:
            return np.zeros(leaf.shape, np.float32)
        ax = spec.index("model")
        shape = [1] * leaf.ndim
        shape[ax] = leaf.shape[ax]
        return np.broadcast_to(np.arange(1, leaf.shape[ax] + 1, dtype=np.float32)
                               .reshape(shape), leaf.shape).copy()

    sd = mapper_state_dict(jax.tree.map(marker, params, shardings), cfg)
    got = {k: ax for k, v in sd.items() if (ax := _split_axis(np.asarray(v))) is not None}
    plan = mesh.mapper_tp_plan(build_mapper(dict(cfg), vq_channels=8, device="meta"))
    assert got == plan and len(plan) >= 3 * cfg["depth"]


# ------------------------------------------------------------- one step, DP and TP

def _step_job(knobs, params, tfrozen, toks, noise=None, mesh_shape=None, **kw):
    return dict(knobs=knobs, clip_sd=tfrozen.perceptor.module.state_dict(),
                vq_sd=tfrozen.vq.state_dict(), vq_arch=tts.TINY_VQ,
                vgg_sd=tfrozen.vgg.state_dict() if tfrozen.vgg is not None else None,
                mapper_sd=mapper_state_dict(jax.tree.map(np.asarray, params), knobs),
                tokens=toks, noise=noise, mesh_shape=mesh_shape, **kw)


DP_CASES = {
    "no_noise": dict(noise_dim=0),
    "bank_noise": dict(noise_dim=4),
    "drawn_noise": dict(noise_dim=4),
    "diversity_all": dict(noise_dim=4, vq_image_size=8, diversity_coef=0.5,
                          diversity_mode="all"),
}


@pytest.mark.parametrize("case", sorted(DP_CASES))
def test_data_parallel_step_matches_jax_and_one_device(case, tmp_path, monkeypatch, rng):
    """2 ranks {data: 2}, 2 rows each, against JAX's loss_fn on a {data: 2} mesh
    and the port's single-device loss_fn over the 4 rows: loss and every
    gradient. Drawn noise is the rank-independent generator's draw at the
    global shape (JAX's normal is fed that draw); the diversity term ("all")
    is the global batch's."""
    knobs = dict(tts.KNOBS, batch_size=4, **DP_CASES[case])
    monkeypatch.setattr(jloop, "make_train_step", functools.partial(
        jloop.make_train_step, mesh=jmesh.make_mesh({"data": 2}, jax.devices()[:2])))
    vgg_sd = vgg_state_dict(9) if case == "diversity_all" else None
    (loss_fn, params, fz, _, _), (_, tloss_fn, tmap, mc, tfrozen) = tts._rigs(
        knobs=knobs, vgg_sd=vgg_sd)
    mc.augs = []
    toks = tts._tokens(4)
    batch = {"inp": jnp.asarray(toks), "out": jnp.asarray(toks)}
    noise = None
    if case.startswith("bank") or case == "diversity_all":
        noise = rng.normal(size=(tts.REPEAT, 4)).astype(np.float32)
        batch["noise"] = jnp.asarray(noise)
    elif case == "drawn_noise":
        drawn = torch.randn(tts.REPEAT * 4, 4, generator=torch.Generator().manual_seed(0))
        real_normal = jax.random.normal
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, **k: (
            jnp.asarray(drawn.numpy()) if tuple(shape) == tuple(drawn.shape)
            else real_normal(key, shape, *a, **k)))
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, fz, batch, jax.random.PRNGKey(0))
    monkeypatch.undo()

    tt = torch.from_numpy(toks).long()
    tb = {"inp": tt, "out": tt}
    if noise is not None:
        tb["noise"] = torch.from_numpy(noise)
    one, one_metrics = tloss_fn(tb, torch.Generator().manual_seed(0))
    one.backward()
    run(tmp_path, 2, "step", _step_job(knobs, params, tfrozen, toks, noise, {"data": 2}))
    outs = [load(tmp_path, "step", r) for r in range(2)]
    got = outs[0]
    assert outs[1]["metrics"] == got["metrics"]
    for k in got["params"]:
        assert torch.equal(outs[1]["params"][k], got["params"][k]), k
    for ref in (float(j_loss), one.item()):
        assert abs(got["metrics"]["loss"] - ref) <= 1e-5 * abs(ref)
    if case == "diversity_all":
        assert one_metrics["diversity"] > 0
        np.testing.assert_allclose(got["metrics"]["diversity"], float(one_metrics["diversity"]),
                                   rtol=1e-5)
    assert_grads_close(got["grads"], mapper_state_dict(jax.tree.map(np.asarray, j_grads), knobs))
    assert_grads_close(got["grads"], {n: p.grad for n, p in tmap.named_parameters()})


def test_data_parallel_dropout_draws_the_single_device_masks(tmp_path):
    """Dropout 0.1 (the Mixer's module path) with noise drawn at the global
    shape: 2 ranks {data: 2} against the port's single-device loss_fn over the
    4 rows, both from the step generator seeded 0 (JAX's dropout draws are its
    own, so no JAX side): loss and every gradient."""
    knobs = dict(tts.KNOBS, batch_size=4, noise_dim=4, dropout=0.1)
    (_, params, _, _, _), (_, tloss_fn, tmap, mc, tfrozen) = tts._rigs(knobs=knobs)
    mc.augs = []
    toks = tts._tokens(4)
    tt = torch.from_numpy(toks).long()
    one, _ = tloss_fn({"inp": tt, "out": tt}, torch.Generator().manual_seed(0))
    one.backward()
    run(tmp_path, 2, "step", _step_job(knobs, params, tfrozen, toks, None, {"data": 2}))
    got = load(tmp_path, "step")
    assert abs(got["metrics"]["loss"] - one.item()) <= 1e-5 * abs(one.item())
    assert_grads_close(got["grads"], {n: p.grad for n, p in tmap.named_parameters()})


def test_tensor_parallel_step_matches_jax_and_one_device(tmp_path, monkeypatch):
    """2 ranks {model: 2} (the Mixer's FFNs split, its module path), with noise
    rows and global-norm clipping, against JAX's loss_fn on {data: 1, model: 2}
    with mapper_param_sharding's placement (gradients gathered) and the port's
    single-device step: loss, every gradient, the clipping's global norm and
    the updated parameters. The gradient floor is test_torch_train_step.py's
    diversity test's, 1e-2 of the largest gradient, for the same tensor: the
    token-FF output bias, whose gradient is zero but for rounding (1.1e-7 of
    the largest here, where the split FFNs sum in another order)."""
    knobs = dict(tts.KNOBS, noise_dim=4)
    jm = jmesh.make_mesh({"data": 1, "model": 2}, jax.devices()[:2])
    monkeypatch.setattr(jloop, "make_train_step",
                        functools.partial(jloop.make_train_step, mesh=jm))
    (loss_fn, params, fz, _, _), (step, _, tmap, mc, tfrozen) = tts._rigs(knobs=knobs)
    mc.augs = []
    toks = tts._tokens()
    noise = np.random.default_rng(4).normal(size=(tts.REPEAT, 4)).astype(np.float32)
    placed = jax.tree.map(jax.device_put, params, jmesh.mapper_param_sharding(jm, params))
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        placed, fz, {"inp": jnp.asarray(toks), "out": jnp.asarray(toks),
                     "noise": jnp.asarray(noise)}, jax.random.PRNGKey(0))
    monkeypatch.undo()
    clip = 0.05
    state = make_train_state(tmap.parameters(), make_optimizer(1e-3, clip_grad_norm=clip))
    tt = torch.from_numpy(toks).long()
    state, metrics = step(state, {"inp": tt, "out": tt, "noise": torch.from_numpy(noise)},
                          torch.Generator().manual_seed(0))
    run(tmp_path, 2, "step", _step_job(knobs, params, tfrozen, toks, noise, {"model": 2},
                                       clip_grad_norm=clip))
    got = load(tmp_path, "step")
    for k, v in load(tmp_path, "step", 1)["params"].items():
        assert torch.equal(v, got["params"][k]), k
    assert abs(got["metrics"]["loss"] - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    assert abs(got["metrics"]["loss"] - float(metrics["loss"])) <= 1e-5 * float(metrics["loss"])
    assert_grads_close(got["grads"], mixer_state_dict(jax.tree.map(np.asarray, j_grads)),
                       floor=1e-2)
    one = {n: p.grad for n, p in tmap.named_parameters()}
    assert_grads_close(got["grads"], one, floor=1e-2)
    norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in one.values()])))
    assert norm > clip and abs(got["global_norm"] - norm) <= 1e-5 * norm
    # Adam's first step moves each parameter by lr * g / (|g| + 1e-8), which
    # rounding decides where g is at its floor (the zero-but-for-rounding bias):
    # the elements whose gradient is above 1e-3 of the largest, within 1% of lr
    top = max(float(g.abs().max()) for g in one.values())
    for n, p in tmap.named_parameters():
        live = (one[n].abs() > 1e-3 * top).numpy()
        np.testing.assert_allclose(got["params"][n].numpy()[live], p.detach().numpy()[live],
                                   rtol=0, atol=1e-5, err_msg=n)


def test_tensor_parallel_forward_equals_the_module(tmp_path):
    """Each family's mapper split over 2 model ranks against the unsharded
    module, dropout 0.1 drawn from one generator: output and input gradient."""
    mappers = {}
    for i, (family, cfg) in enumerate(sorted(MAPPERS.items())):
        m = build_mapper(dict(cfg), vq_channels=8)
        sd = {k: torch.from_numpy(np.random.default_rng(i).normal(
            scale=0.3, size=v.shape).astype(np.float32)) for k, v in m.state_dict().items()}
        x = np.random.default_rng(10 + i).normal(size=(3, 32)).astype(np.float32)
        mappers[family] = (cfg, sd, x)
    run(tmp_path, 2, "tp_forward", dict(mappers=mappers))
    for rank in range(2):
        for family, ((z, gx), (tz, tgx)) in load(tmp_path, "tp_forward", rank).items():
            for a, b in ((tz, z), (tgx, gx)):
                err = float((a - b).abs().max())
                assert err <= 1e-5 * max(1.0, float(b.abs().max())), (family, err)


# ----------------------------------------------------------------- the whole trainer

def test_trainer_on_four_ranks(tmp_path):
    """multiproc.run_dryrun on {data: 2, model: 2}: equal parameters on every
    rank, files written by rank 0 alone, the eval run; the JAX package's
    load_model reads the gathered .th, whose weights are rank 0's."""
    tmp = multiproc.run_dryrun(4, tmp=str(tmp_path), timeout=TIMEOUT, device="cpu",
                               worker="torch_parallel_workers:dryrun", pythonpath=[TESTS])
    _, jparams, jcfg, noise = j_load_model(os.path.join(tmp, "run", "checkpoint.th"))
    assert jcfg["mesh_shape"] == {"data": 2, "model": 2} and noise.shape == (4, 8)
    want = torch.load(os.path.join(tmp, "params_0.pt"))
    got = mixer_state_dict(jax.tree.map(np.asarray, jparams))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v.numpy(), err_msg=k)


def _files(folder):
    """The run folder's checkpoint, EMA and Adam state as tensors."""
    out = {}
    for name in ("checkpoint", "checkpoint_ema"):
        sd, _, step, _, noise = ckpt_io.load_checkpoint(ckpt_io.checkpoint_path(folder, name))
        out.update({f"{name}.{k}": v for k, v in sd.items()}, **{f"{name}.noise": noise})
    opt = ckpt_io.load_optimizer(folder)
    out.update({f"mu.{k}": v for k, v in opt["mu"].items()})
    out.update({f"nu.{k}": v for k, v in opt["nu"].items()})
    return step, out


def test_trainer_resume_on_four_ranks_is_bitwise(tmp_path):
    """{data: 2, model: 2}: 4 steps against 2 + 2 resumed: every rank's
    parameters and the files (parameters, EMA, Adam's moments) bitwise equal."""
    runs = [("a", dict(max_steps=4, log_interval=2)), ("b", dict(max_steps=2, log_interval=2)),
            ("b", dict(max_steps=4, log_interval=2))]
    multiproc.write_dryrun_data(str(tmp_path))
    run(tmp_path, 4, "trainer_runs", dict(runs=runs))
    for r in range(4):
        a, b = load(tmp_path, "a_4", r), load(tmp_path, "b_4", r)
        assert all(torch.equal(a[k], b[k]) for k in a)
    (sa, fa), (sb, fb) = _files(str(tmp_path / "a")), _files(str(tmp_path / "b"))
    assert sa == sb == 4 and sorted(fa) == sorted(fb)
    for k, v in fa.items():
        assert torch.equal(v, fb[k]), k


def test_two_rank_checkpoint_resumes_in_one_process(tmp_path):
    """A {data: 2} run's files resume in one process (no mesh): it starts from
    the 2-rank parameters and carries on. And in one process, mesh_shape
    {data: 1} gives the parameters of no mesh_shape, bit for bit."""
    multiproc.write_dryrun_data(str(tmp_path))
    run(tmp_path, 2, "trainer_runs", dict(runs=[("c", dict(mesh_shape={"data": 2}))]))
    two = load(tmp_path, "c_2")
    sd = ckpt_io.load_checkpoint(ckpt_io.checkpoint_path(str(tmp_path / "c")))[0]
    assert all(torch.equal(sd[k], v) for k, v in two.items())
    run(tmp_path, 1, "trainer_runs", dict(runs=[
        ("c", dict(mesh_shape=None, max_steps=3, batch_size=4)), ("plain", dict(mesh_shape=None)),
        ("data1", dict(mesh_shape={"data": 1}))]))
    assert ckpt_io.load_checkpoint(ckpt_io.checkpoint_path(str(tmp_path / "c")))[2] == 3
    c3 = load(tmp_path, "c_3")
    assert any(not torch.equal(c3[k], v) for k, v in two.items())
    plain, data1 = load(tmp_path, "plain_2"), load(tmp_path, "data1_2")
    assert all(torch.equal(plain[k], v) for k, v in data1.items())


# ------------------------------------------------------------------------ the prior

def test_prior_on_two_ranks(tmp_path):
    """train_prior {data: 2} against one process on the same global batches:
    the printed losses and the parameters after 4 steps; at 2 ranks, 4 steps
    against 2 + 2 resumed, bitwise; a directory of shards of unequal sizes,
    each rank on its files, both ranks ending equal."""
    data = tmp_path / "pairs.npz"
    tprior._pairs(data, n=64)
    shards = tmp_path / "shards"
    shards.mkdir()
    for i, n in enumerate((20, 9, 14)):
        tprior._pairs(shards / f"s{i}.npz", seed=10 + i, n=n)

    def cfg(name, steps, mesh_shape, path=data):
        return dict(tprior._cfg(tmp_path / name, path, log_interval=1, max_steps=steps,
                                mesh_shape=mesh_shape))

    two = run(tmp_path, 2, "prior_runs", dict(runs=[  # the last prints of a step count
        ("s", cfg("s", 3, {"data": 2}, shards)), ("p", cfg("p", 4, {"data": 2})),
        ("q", cfg("q", 2, {"data": 2})), ("q", cfg("q", 4, {"data": 2}))]))
    one = run(tmp_path, 1, "prior_runs", dict(runs=[("o", cfg("o", 4, None))]))
    losses_two, losses_one = tprior._losses(two[0]), tprior._losses(one[0])
    assert sorted(losses_one) == [0, 1, 2, 3] and not tprior._losses(two[1])
    for s, v in losses_one.items():
        assert abs(losses_two[s] - v) <= 1e-5 * abs(v), s
    p, q, o = load(tmp_path, "p_4"), load(tmp_path, "q_4"), load(tmp_path, "o_4")
    assert all(torch.equal(a, b) for a, b in zip(p, q))
    assert all(torch.equal(a, b) for a, b in zip(p, load(tmp_path, "p_4", 1)))
    assert all(torch.equal(a, b) for a, b in zip(load(tmp_path, "s_3"), load(tmp_path, "s_3", 1)))
    for a, b in zip(p, o):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_prior_file_split_equals_jax(tmp_path, monkeypatch):
    """A directory of shards: the seeded shuffle, then file i to rank i % 2 —
    each rank's rows those JAX's _load_pairs gives its process."""
    shards = tmp_path / "shards"
    shards.mkdir()
    for i in range(5):
        tprior._pairs(shards / f"s{i}.npz", seed=10 + i, n=3 + i)
    for index in range(2):
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda index=index: index)
        wx, wy = jprior._load_pairs(str(shards), 7)
        monkeypatch.undo()
        gx, gy = prior._load_pairs(str(shards), 7, index, 2)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


# ----------------------------------------------------------------------- the encoder

def test_webdataset_encoder_on_two_ranks(bpe_table, clip_file, tmp_path,  # noqa: F811
                                         monkeypatch):
    """`cli encode-text-and-images-webdataset --merge` on 2 ranks: rank r encodes
    the tars i with i % 2 == r (JAX's split) into f_<r>.npz, as one process
    given that split does; rank 0's merge is their concatenation."""
    pattern = _shards(tmp_path, counts=(2, 3, 2), corrupt=-1)
    out = str(tmp_path / "f.npz")
    run(tmp_path / "mp", 2, "cli", dict(argv=[
        "encode-text-and-images-webdataset", pattern, "--clip-model", "tiny", "--clip-path",
        clip_file, "--batch-size", "2", "--out", out, "--merge", "--device", "cpu"]))
    parts = []
    for r, rows in ((0, 4), (1, 3)):
        monkeypatch.setattr(encode, "process_split", lambda r=r: (r, 2))
        want = encode.encode_text_and_images_webdataset(
            pattern, clip_model="tiny", clip_path=clip_file, batch_size=2,
            out=str(tmp_path / f"want_{r}.npz"), device="cpu")
        monkeypatch.undo()
        got = np.load(str(tmp_path / f"f_{r}.npz"))
        ref = np.load(str(tmp_path / f"want_{r}_{r}.npz"))
        assert len(got["x"]) == rows and want
        for k in ("x", "y"):
            np.testing.assert_array_equal(got[k], ref[k])
        parts.append(got)
    merged = np.load(out)
    for k in ("x", "y"):
        np.testing.assert_array_equal(merged[k], np.concatenate([p[k] for p in parts]))


# ---------------------------------------------------------------- the rendezvous

@pytest.fixture
def clean_env(monkeypatch):
    for k in utils.EXPLICIT + utils.TORCHRUN + ("FFVC_DIST_BACKEND", "FFVC_DIST_TIMEOUT"):
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append(dict(kw, backend=backend)))
    return calls


@pytest.mark.parametrize("env,want", [
    (dict(FFVC_COORDINATOR_ADDRESS="localhost:1234", FFVC_NUM_PROCESSES="2",
          FFVC_PROCESS_ID="1"), dict(init_method="tcp://localhost:1234", world_size=2, rank=1)),
    (dict(FFVC_INIT_METHOD="file:///x/rdzv", FFVC_NUM_PROCESSES="4", FFVC_PROCESS_ID="3"),
     dict(init_method="file:///x/rdzv", world_size=4, rank=3)),
    (dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1", MASTER_ADDR="localhost",
          MASTER_PORT="29500"), dict(init_method="env://", world_size=2, rank=1)),
    (dict(FFVC_INIT_METHOD="file:///x/rdzv", FFVC_NUM_PROCESSES="2", FFVC_PROCESS_ID="0",
          FFVC_DIST_BACKEND="mpi"), dict(backend="mpi")),
], ids=["coordinator", "init_method", "torchrun", "backend"])
def test_initialize_triggers(clean_env, monkeypatch, env, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert utils.maybe_initialize_distributed("cpu") is True
    (call,) = clean_env
    assert {k: call[k] for k in want} == want
    assert call.get("backend") == want.get("backend", "gloo")


def test_initialize_without_a_world_is_a_no_op(clean_env, monkeypatch, caplog):
    """No variable, a world of one, or torchrun's variables without RANK and
    WORLD_SIZE (a WARNING): single process, nothing initialised. FFVC_*
    variables that do not declare a whole world raise."""
    assert utils.maybe_initialize_distributed("cpu") is False
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert utils.maybe_initialize_distributed("cpu") is False
    assert "stays single" in caplog.text
    monkeypatch.delenv("LOCAL_RANK")
    for k, v in dict(FFVC_INIT_METHOD="file:///x", FFVC_NUM_PROCESSES="1",
                     FFVC_PROCESS_ID="0").items():
        monkeypatch.setenv(k, v)
    assert utils.maybe_initialize_distributed("cpu") is False
    monkeypatch.delenv("FFVC_PROCESS_ID")
    with pytest.raises(ValueError, match="FFVC_PROCESS_ID"):
        utils.maybe_initialize_distributed("cpu")
    assert clean_env == []


def test_initialize_rejects_torchrun_with_an_init_method(clean_env, monkeypatch):
    """torchrun's RANK and WORLD_SIZE do not complete FFVC_INIT_METHOD: a file://
    rendezvous goes through FFVC_NUM_PROCESSES and FFVC_PROCESS_ID."""
    for k, v in dict(RANK="0", WORLD_SIZE="2", FFVC_INIT_METHOD="file:///x/rdzv").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="FFVC_NUM_PROCESSES"):
        utils.maybe_initialize_distributed("cpu")
    assert clean_env == []


def test_initialize_is_idempotent(clean_env, monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setenv("FFVC_COORDINATOR_ADDRESS", "localhost:1")
    assert utils.maybe_initialize_distributed("cpu") is True and clean_env == []


def test_initialize_raises_when_the_world_does_not_come(monkeypatch, tmp_path):
    """Rank 0 of a declared world of 2 whose rank 1 never starts: the
    rendezvous raises at FFVC_DIST_TIMEOUT, and the process is not left
    initialised as one."""
    for k, v in dict(FFVC_INIT_METHOD=f"file://{tmp_path}/rdzv", FFVC_NUM_PROCESSES="2",
                     FFVC_PROCESS_ID="0", FFVC_DIST_TIMEOUT="2").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(Exception):
        utils.maybe_initialize_distributed("cpu")
    assert not torch.distributed.is_initialized()


def test_rendezvous_of_four_processes_and_mesh_layout(tmp_path):
    """run_processes' FFVC_* file:// rendezvous: a Gloo group of 4, one rank
    each; {data: 2, model: 2} places rank r where JAX's mesh places device r."""
    run(tmp_path, 4, "rendezvous")
    jm = jmesh.make_mesh({"data": 2, "model": 2}, jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(4):
        with open(tmp_path / f"rendezvous_{r}.json") as fd:
            got = json.load(fd)
        assert got["backend"] == "gloo" and got["world"] == 4 and got["rank"] == r
        i, j = np.argwhere(ids == jax.devices()[r].id)[0]
        assert (got["data_index"], got["model_index"]) == (i, j)


def test_a_failing_rank_fails_the_run(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        run(tmp_path, 2, "fail_on_rank_1")



def test_dryrun_multichip_entry(monkeypatch):
    """entry.dryrun_multichip runs multiproc.run_dryrun on n processes, on the
    card unless the caller asks for the CPU, the card's ranks over Gloo (NCCL
    refuses two ranks on one device)."""
    from feed_forward_vqgan_clip_tpu_torch import entry

    calls = []
    monkeypatch.setattr(multiproc, "run_dryrun", lambda n, **kw: calls.append((n, kw)) or "t")
    assert entry.dryrun_multichip(4, device="cpu") == "t" and entry.dryrun_multichip(2) == "t"
    assert [(n, kw["device"], kw["env"]) for n, kw in calls] == [
        (4, "cpu", None), (2, "cuda", {"FFVC_DIST_BACKEND": "gloo"})]
    assert multiproc.dryrun_config("/x", 4)["mesh_shape"] == {"data": 2, "model": 2}
    assert multiproc.dryrun_config("/x", 2)["mesh_shape"] == {"data": 2, "model": 1}

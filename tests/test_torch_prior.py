"""The port's prior trainer (train/prior.py, `cli train-prior`) against the JAX
package's `train_prior`, on the CPU.

A tiny flow (C = 8 image dims, D = 6 text dims, embedding 4, hidden 16, depth 1,
2 flows) on 40 seeded pairs, batch 16 (3 batches an epoch, the last padded by
wrap-around). The JAX trainer starts from its own init; the port's from the
same variables, written as a step-0 `checkpoint.th` for it to resume from.
Tolerances: the step-0 NLL within 1e-5 relative; each parameter after one and
after three Adam steps (lr 1e-3, clipping at 1.0) within 2e-4 of
max(1, max |JAX|); samples for a pinned z within 2e-4 of max(1, max |JAX|); a
resumed run bitwise equal to the uninterrupted one.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.config import make_config as j_make_config
from feed_forward_vqgan_clip_tpu.io.checkpoint import load_pytree
from feed_forward_vqgan_clip_tpu.models import flow as jflow
from feed_forward_vqgan_clip_tpu.train import prior as jprior
from feed_forward_vqgan_clip_tpu_torch import cli
from feed_forward_vqgan_clip_tpu_torch.config import make_config
from feed_forward_vqgan_clip_tpu_torch.io import checkpoint as ckpt_io
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import flow_state_dict
from feed_forward_vqgan_clip_tpu_torch.models import flow
from feed_forward_vqgan_clip_tpu_torch.train import prior

C, D, N, BS = 8, 6, 40, 16
MODEL = dict(embedding_dim=4, hidden_dim=16, hidden_depth=1, n_flows=2)


def _pairs(path, seed=0, n=N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D)).astype(np.float32)
    y = (x @ rng.normal(size=(D, C)) + 0.1 * rng.normal(size=(n, C))).astype(np.float32)
    np.savez(path, x=x, y=y)
    return x, y


def _cfg(folder, data, make=make_config, log_interval=1000, **kw):
    return make(folder=str(folder), data={"path": str(data), "batch_size": BS}, model=MODEL,
                optim={"lr": 1e-3, "epochs": 100, "clip_grad_norm": 1.0},
                logging={"log_interval": log_interval}, **kw)


def _losses(text):
    """The `epoch step loss` lines a trainer printed -> {step: loss}."""
    out = {}
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[0].isdigit() and parts[1].isdigit():
            out[int(parts[1])] = float(parts[2])
    return out


def _tol(ref):
    return 2e-4 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("steps", [1, 3])
def test_train_prior_matches_jax_from_the_same_variables(tmp_path, capsys, steps):
    data = tmp_path / "pairs.npz"
    _pairs(data)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jprior.train_prior(_cfg(jdir, data, j_make_config, max_steps=steps))
    j_init = jflow.build_prior_model({"model": MODEL}, D, C).init(
        jax.random.PRNGKey(0), jnp.zeros((1, C)), jnp.zeros((1, D)))
    port = flow.build_prior_model({"model": MODEL}, D, C, device="cpu")
    port.load_state_dict(flow_state_dict(jax.tree.map(np.asarray, j_init)))
    os.makedirs(tdir)
    flow.save_prior(prior.checkpoint_path(str(tdir)), port, {"model": MODEL}, step=0)
    capsys.readouterr()
    # the JAX trainer's first line (step 0): rerun it with the log interval hit
    jprior.train_prior(_cfg(tmp_path / "jax0", data, j_make_config, max_steps=1,
                            log_interval=1))
    jl = _losses(capsys.readouterr().out)
    state = prior.train_prior(_cfg(tdir, data, max_steps=steps, log_interval=1), device="cpu")
    tl = _losses(capsys.readouterr().out)
    assert state.step == steps and state.opt_state.count == steps
    assert abs(tl[0] - jl[0]) <= 1e-5 * abs(jl[0])
    got = torch.load(prior.checkpoint_path(str(tdir)), weights_only=False)
    assert got["step"] == steps and (got["input_size"], got["output_size"]) == (D, C)
    want = flow_state_dict(load_pytree(str(jdir / "checkpoint" / "params.msgpack")))
    for k, v in want.items():
        ref = v.numpy()
        assert float(np.abs(got["model"][k].numpy() - ref).max()) <= _tol(ref), k


def test_port_prior_file_loads_in_jax_load_prior_model(tmp_path):
    """The `.th` the port's trainer writes: JAX load_prior_model reads it, and its
    reverse of a pinned z equals the port's."""
    data = tmp_path / "pairs.npz"
    _pairs(data)
    prior.train_prior(_cfg(tmp_path, data, max_steps=2), device="cpu")
    path = prior.checkpoint_path(str(tmp_path))
    jp = jflow.load_prior_model(path)
    tp = flow.load_prior_model(path, device="cpu")
    rng = np.random.default_rng(1)
    z, cond = rng.normal(size=(5, C)).astype(np.float32), rng.normal(size=(5, D)).astype(
        np.float32)
    want = np.asarray(jp.flow.apply(jp.variables, jnp.asarray(z), jnp.asarray(cond),
                                    method=jp.flow.reverse))
    got = tp.reverse(torch.from_numpy(z), torch.from_numpy(cond)).numpy()
    assert float(np.abs(got - want).max()) <= _tol(want)


def test_resume_repeats_the_uninterrupted_run(tmp_path):
    """2 steps then a rerun to 5 (across the epoch boundary at 3) against 5 steps
    at once: parameters and Adam moments bitwise equal."""
    data = tmp_path / "pairs.npz"
    _pairs(data)
    whole, split = tmp_path / "whole", tmp_path / "split"
    prior.train_prior(_cfg(whole, data, max_steps=5), device="cpu")
    prior.train_prior(_cfg(split, data, max_steps=2), device="cpu")
    state = prior.train_prior(_cfg(split, data, max_steps=5), device="cpu")
    assert state.step == 5
    a, b = (torch.load(prior.checkpoint_path(str(f)), weights_only=False) for f in (whole, split))
    assert a["step"] == b["step"] == 5 and a["epoch"] == b["epoch"] == 1
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    oa, ob = ckpt_io.load_optimizer(str(whole)), ckpt_io.load_optimizer(str(split))
    assert oa["count"] == ob["count"] == 5
    for n in oa["mu"]:
        assert torch.equal(oa["mu"][n], ob["mu"][n]) and torch.equal(oa["nu"][n], ob["nu"][n])
        assert oa["mu"][n].dtype == torch.float32


def test_load_pairs_matches_jax(tmp_path):
    """A .npz, a torch-saved pair, and a directory of shards (the seeded order)."""
    x, y = _pairs(tmp_path / "a.npz", seed=2, n=7)
    torch.save((torch.from_numpy(x), torch.from_numpy(y)), tmp_path / "b.pt")
    shards = tmp_path / "shards"
    shards.mkdir()
    for i in range(4):
        _pairs(shards / f"s{i}.npz", seed=10 + i, n=3 + i)
    for path in (tmp_path / "a.npz", tmp_path / "b.pt", shards):
        for seed in (0, 5):
            gx, gy = prior._load_pairs(str(path), seed)
            wx, wy = jprior._load_pairs(str(path), seed)
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_mesh_shape_raises(tmp_path):
    data = tmp_path / "pairs.npz"
    _pairs(data)
    with pytest.raises(NotImplementedError, match="A12"):
        prior.train_prior(_cfg(tmp_path, data, mesh_shape={"data": 2}), device="cpu")


def test_cli_train_prior_runs_on_the_cpu(tmp_path, capsys):
    data = tmp_path / "pairs.npz"
    _pairs(data)
    cfg = {"data": {"path": str(data), "batch_size": BS}, "model": MODEL,
           "optim": {"lr": 1e-3, "epochs": 2}, "logging": {"log_interval": 2}}
    path = tmp_path / "prior.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    cli.main(["train_prior", str(path), "--device", "cpu"])
    assert sorted(_losses(capsys.readouterr().out)) == [0, 2, 4]
    obj = torch.load(prior.checkpoint_path(str(tmp_path)), weights_only=False)
    assert obj["step"] == 6 and obj["epoch"] == 1  # 2 epochs of 3 batches
    assert obj["config"] == {"model": MODEL}

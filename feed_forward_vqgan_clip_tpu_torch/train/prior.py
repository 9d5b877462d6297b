"""The flow-prior trainer: p(image embedding | text embedding), on one device or
data-parallel over a mesh.

Port of feed_forward_vqgan_clip_tpu/train/prior.py (the reference's
`train_prior`). Data: a (text_feats, image_feats) pair file (`.npz` with x and
y, or a torch-saved pair) or a directory of such shards, read in a seeded
shuffled order. The loss is the flow NLL (models/flow.py `nll_loss`), the
optimizer Adam with float32 moments and optional global-norm clipping
(train/state.py), the batches DistributedSampler-parity per epoch
(data/datasets.py `epoch_shard_batches`). TensorBoard scalars every 100 steps
where TensorBoard is installed; every `log_interval` steps a line on stdout and
a checkpoint. Config schema, as the reference's yaml: {data: {path,
batch_size}, model: {embedding_dim, hidden_dim, hidden_depth, n_flows}, optim:
{lr, epochs, clip_grad_norm}, logging: {log_interval}, max_steps, seed, folder}.

The run folder holds the reference's prior format, which both packages'
`load_prior_model` read:

    <folder>/checkpoint.th   {model, step, epoch, input_size, output_size, config}
    <folder>/opt.th          Adam: {step, count, mu, nu} (io/checkpoint.py)

`step` is the number of updates in the saved parameters. A rerun resumes from
them and skips the batches its epoch already consumed, so an interrupted and
resumed run repeats the uninterrupted one.

With `mesh_shape` (or several processes) the flow is replicated on a
parallel/mesh.py mesh and `batch_size` is the global batch: rank 0's weights
are broadcast, each data rank takes its rows of every global batch (from a
pair file, epoch_shard_batches' strided split over the data ranks), the
gradients and metrics are averaged over the data group before clipping, and
rank 0 alone prints, writes TensorBoard and the files, with a barrier after the
last save. A directory of shards is split as the JAX package splits it (the
seeded shuffle, then file i to data rank i % d); each rank then batches its own
rows, all ranks the count of the smallest share, so every rank takes the same
number of steps (the JAX package splits those rows over the processes once
more, ROADMAP C).
"""

import logging
import os
import random
from glob import glob
from typing import Callable

import numpy as np
import torch

from feed_forward_vqgan_clip_tpu_torch.data.datasets import epoch_shard_batches
from feed_forward_vqgan_clip_tpu_torch.io import checkpoint as ckpt_io
from feed_forward_vqgan_clip_tpu_torch.models.flow import (
    ConditionalFlatCouplingFlow,
    build_prior_model,
    complete_state_dict,
    nll_loss,
    save_prior,
)
from feed_forward_vqgan_clip_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads_mean,
    broadcast_params,
    is_primary,
    make_mesh,
    world_size,
)
from feed_forward_vqgan_clip_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
    make_train_state,
)

log = logging.getLogger(__name__)

TB_INTERVAL = 100  # steps between TensorBoard scalars


def shard_files(paths, seed: int, index: int = 0, count: int = 1):
    """The JAX package's split of a directory's files: sorted, shuffled by
    `seed` (random.Random), then every file i with i % count == index."""
    paths = sorted(paths)
    random.Random(seed).shuffle(paths)
    return [p for i, p in enumerate(paths) if i % count == index]


def _load_pairs(path: str, seed: int = 0, index: int = 0, count: int = 1):
    """(x, y) float arrays of a pair file, or of this data rank's files of a
    directory of shards (`shard_files`), concatenated in that order."""
    def load_one(p):
        if p.endswith(".npz"):
            z = np.load(p)
            return np.asarray(z["x"]), np.asarray(z["y"])
        x, y = torch.load(p, map_location="cpu", weights_only=False)
        return np.asarray(x), np.asarray(y)

    if os.path.isdir(path):
        paths = shard_files(glob(os.path.join(path, "*")), seed, index, count)
        xs, ys = zip(*(load_one(p) for p in paths))
        return np.concatenate(xs), np.concatenate(ys)
    return load_one(path)


def make_prior_step(flow: ConditionalFlatCouplingFlow, state: TrainState,
                    mesh: Mesh = None) -> Callable:
    """-> step(xb, yb) -> metrics: the NLL of y given x, its backward (the
    gradients averaged over `mesh`'s data group, where it has one) and one Adam
    update of `state` in place; metrics {loss, nll_loss, nlogdet_loss} as 0-d
    tensors on the device (the data group's means)."""
    def step(xb, yb):
        for p in state.params:
            p.grad = None
        z, logdet = flow(yb, xb)
        loss, aux = nll_loss(z, logdet)
        loss.backward()
        metrics = {k: v.detach() for k, v in dict(aux, loss=loss).items()}
        if mesh is not None:
            metrics = all_reduce_grads_mean(state.params, mesh, metrics)
        state.apply_gradients()
        return metrics

    return step


def checkpoint_path(folder: str) -> str:
    return os.path.join(folder, "checkpoint.th")


def train_prior(cfg, *, device="cuda") -> TrainState:
    """Train a prior from `cfg` (load_config / make_config) in `cfg.folder`,
    resuming from the checkpoint there; -> the final TrainState. Runs on the card
    unless `device` says otherwise."""
    mesh = (make_mesh(cfg.get("mesh_shape")) if cfg.get("mesh_shape") or world_size() > 1
            else Mesh())
    primary, d = is_primary(), mesh.data
    folder = cfg.get("folder") or "."
    os.makedirs(folder, exist_ok=True)
    data_cfg = cfg.get("data") or {}
    optim_cfg = cfg.get("optim") or {}
    model_cfg = dict(cfg.get("model") or {})
    seed = int(cfg.get("seed") or 0)
    bs = int(data_cfg.get("batch_size", 128))
    epochs = int(optim_cfg.get("epochs", 100))
    log_interval = int((cfg.get("logging") or {}).get("log_interval", 1000))
    max_steps = cfg.get("max_steps")

    if bs % d:
        raise ValueError(f"batch_size={bs} (global) must be divisible by the data mesh axis "
                         f"({d})")
    bs_local = bs // d
    sharded_files = os.path.isdir(data_cfg["path"]) and d > 1
    x, y = _load_pairs(data_cfg["path"], seed, *((mesh.data_index, d) if sharded_files
                                                 else (0, 1)))
    if sharded_files:  # every rank batches as many rows: the smallest share's
        n = torch.tensor([len(x)], device=device)
        torch.distributed.all_reduce(n, torch.distributed.ReduceOp.MIN, group=mesh.data_group)
        x, y = x[: int(n)], y[: int(n)]
    xs = torch.as_tensor(x.astype(np.float32), device=device)
    ys = torch.as_tensor(y.astype(np.float32), device=device)
    flow = build_prior_model({"model": model_cfg}, x.shape[1], y.shape[1], device=device)
    step, epoch0 = 0, 0
    ckpt = checkpoint_path(folder)
    if os.path.exists(ckpt):
        obj = torch.load(ckpt, map_location="cpu", weights_only=False)
        flow.load_state_dict(complete_state_dict(obj["model"]))
        step, epoch0 = int(obj["step"]), int(obj.get("epoch", 0))
        log.info("Resuming prior from step %d (epoch %d)", step, epoch0)
    else:
        flow.init_random_(torch.Generator(device=device).manual_seed(seed))
    if world_size() > 1:
        broadcast_params(list(flow.parameters()) + list(flow.buffers()))
    names = [n for n, _ in flow.named_parameters()]
    tx = make_optimizer(float(optim_cfg.get("lr", 1e-4)),
                        clip_grad_norm=optim_cfg.get("clip_grad_norm"), opt_dtype="float32")
    state = make_train_state(flow.parameters(), tx, step=step)
    opt = ckpt_io.load_optimizer(folder) if step else None
    if opt is not None and opt["step"] == step:
        state.opt_state.count = int(opt["count"])
        for n, m, v in zip(names, state.opt_state.mu, state.opt_state.nu):
            m.copy_(opt["mu"][n])
            v.copy_(opt["nu"][n])
    elif opt is not None:
        log.warning("opt.th holds step %d, checkpoint.th step %d: Adam starts afresh",
                    opt["step"], step)
    train_step = make_prior_step(flow, state, mesh)

    writer = None
    if primary:
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(folder)
        except Exception as e:  # pragma: no cover
            log.warning("TensorBoard writer unavailable: %s", e)

    def save(epoch):
        if not primary:
            return
        # opt.th first: checkpoint.th is the commit point of a resume
        ckpt_io.save_optimizer(folder, names, state.opt_state, state.step)
        save_prior(ckpt, flow, {"model": model_cfg}, state.step, epoch)

    def finish(epoch):
        save(epoch)
        if writer:
            writer.close()
        if mesh.data_group is not None:  # the files are complete on every rank
            torch.distributed.barrier()
        return state

    def epoch_batches(epoch):
        if sharded_files:
            return epoch_shard_batches(len(x), bs_local, seed=seed, epoch=epoch)
        return epoch_shard_batches(len(x), bs_local, seed=seed, epoch=epoch,
                                   process_index=mesh.data_index, process_count=d)

    for epoch in range(epoch0, epochs):
        batches = epoch_batches(epoch)
        # every epoch has the same batch count: skip what this epoch consumed
        for ids in batches[max(step - epoch * len(batches), 0):]:
            idx = torch.as_tensor(ids, device=device)
            metrics = train_step(xs[idx], ys[idx])
            if writer and step % TB_INTERVAL == 0:
                for k, v in metrics.items():
                    writer.add_scalar(k, float(v), step)
            if step % log_interval == 0:
                if primary:
                    print(epoch, step, float(metrics["loss"]), flush=True)
                save(epoch)
            step += 1
            if max_steps is not None and step >= int(max_steps):
                return finish(epoch)
    return finish(max(epochs - 1, epoch0))

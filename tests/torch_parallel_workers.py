"""The functions tests/test_torch_parallel.py runs in real processes of one
process group (parallel/multiproc.run_processes calls each as fn(tmp, device)
after the rendezvous). Each reads its job from `tmp/job.pt` and writes what
the test compares to `tmp/<name>_<rank>.pt`. Nothing of JAX is imported here;
TensorFlow is kept out so that TensorBoard takes its light stub.
"""

import json
import os
import sys

sys.modules.setdefault("tensorflow", None)

import torch  # noqa: E402

from feed_forward_vqgan_clip_tpu_torch.config import make_config  # noqa: E402
from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip  # noqa: E402
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper  # noqa: E402
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import Perceptor  # noqa: E402
from feed_forward_vqgan_clip_tpu_torch.models.vgg import VGG16Features  # noqa: E402
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import make_vqgan  # noqa: E402
from feed_forward_vqgan_clip_tpu_torch.ops.cutouts import MakeCutouts  # noqa: E402
from feed_forward_vqgan_clip_tpu_torch.parallel import multiproc  # noqa: E402
from feed_forward_vqgan_clip_tpu_torch.parallel.mesh import (  # noqa: E402
    gather_params,
    make_mesh,
    mapper_tp_plan,
    world_size,
)
from feed_forward_vqgan_clip_tpu_torch.parallel.tensor_parallel import (  # noqa: E402
    shard_mapper_,
    tp_grad_norm,
)
from feed_forward_vqgan_clip_tpu_torch.train.loop import (  # noqa: E402
    FrozenModels,
    make_train_step,
    train,
)
from feed_forward_vqgan_clip_tpu_torch.train.prior import train_prior  # noqa: E402
from feed_forward_vqgan_clip_tpu_torch.train.state import (  # noqa: E402
    make_optimizer,
    make_train_state,
)


def _job(tmp):
    return torch.load(os.path.join(tmp, "job.pt"), weights_only=False)


def _rank():
    dist = torch.distributed
    return dist.get_rank() if dist.is_initialized() else 0


def _save(tmp, name, obj):
    torch.save(obj, os.path.join(tmp, f"{name}_{_rank()}.pt"))


def step_rig(job, device="cpu"):
    """The port side of test_torch_train_step's rig from the job's weights: the
    tiny CLIP, the tiny VQGAN (and VGG16 where given), the job's mapper, the
    cutouts neutralised. -> (cfg, mapper, frozen, cutouts)."""
    knobs = job["knobs"]
    clip = make_clip("tiny", device=device, image=True)
    clip.load_state_dict(job["clip_sd"])
    vq = make_vqgan(job["vq_arch"], device=device)
    vq.load_state_dict(job["vq_sd"])
    vgg = None
    if job.get("vgg_sd") is not None:
        vgg = VGG16Features().to(device)
        vgg.load_state_dict(job["vgg_sd"])
        vgg.eval().requires_grad_(False)
    frozen = FrozenModels(Perceptor(clip.eval().requires_grad_(False), "tiny", 32, 32),
                          vq.eval().requires_grad_(False), vgg=vgg)
    mapper = build_mapper(dict(knobs), vq_channels=job["vq_arch"]["z_channels"], device=device)
    mapper.load_state_dict(job["mapper_sd"])
    cutouts = MakeCutouts(cut_size=knobs["cut_size"], cutn=knobs["cutn"],
                          pool_size=knobs["pool_size"], noise_fac=0.0)
    cutouts.augs = []  # (an empty `augs` argument means the default set)
    return make_config(**knobs), mapper, frozen, cutouts


def step(tmp, device):
    """One train step of the job's rig on its mesh: this data rank's rows of the
    global batch, the step generator seeded 0; -> the loss, the metrics, the
    averaged gradients and the updated parameters, gathered over the model
    group."""
    job = _job(tmp)
    cfg, mapper, frozen, cutouts = step_rig(job, device)
    mesh = make_mesh(job["mesh_shape"])
    plan = mapper_tp_plan(mapper) if mesh.model > 1 else {}
    shard_mapper_(mapper, mesh)
    step_fn, _ = make_train_step(cfg, mapper, frozen, cutouts, inp_is_tokens=True,
                                 out_is_tokens=True, mesh=mesh)
    tx = make_optimizer(1e-3, clip_grad_norm=job.get("clip_grad_norm"))
    if plan:
        tx.global_norm = tp_grad_norm(mapper, mesh)
    state = make_train_state(mapper.parameters(), tx)
    b = len(job["tokens"]) // mesh.data
    rows = torch.as_tensor(job["tokens"][mesh.data_index * b: (mesh.data_index + 1) * b],
                           dtype=torch.long, device=device)
    batch = {"inp": rows, "out": rows}
    if job.get("noise") is not None:
        batch["noise"] = torch.as_tensor(job["noise"], device=device)
    state, metrics = step_fn(state, batch, torch.Generator(device).manual_seed(0))
    names = [n for n, _ in mapper.named_parameters()]
    grads = gather_params({n: p.grad for n, p in zip(names, state.params)}, plan, mesh)
    params = gather_params({n: p.detach() for n, p in zip(names, state.params)}, plan, mesh)
    norm = tx.global_norm([p.grad for p in state.params]) if plan else None
    _save(tmp, "step", {"metrics": {k: float(v) for k, v in metrics.items()},
                        "grads": {k: v.cpu() for k, v in grads.items()},
                        "params": {k: v.cpu() for k, v in params.items()},
                        "global_norm": None if norm is None else float(norm)})


def tp_forward(tmp, device):
    """Each job mapper's tensor-parallel forward against its unsharded module on
    the same input and dropout generator, and the input gradients of both."""
    job = _job(tmp)
    mesh = make_mesh({"model": torch.distributed.get_world_size()})
    out = {}
    for label, (cfg, sd, x) in job["mappers"].items():
        results = []
        for tp in (False, True):
            mapper = build_mapper(dict(cfg), vq_channels=8, device=device)
            mapper.load_state_dict(sd)
            if tp:
                shard_mapper_(mapper, mesh)
            xi = torch.as_tensor(x, device=device).requires_grad_(True)
            z = mapper(xi, torch.Generator(device).manual_seed(3))
            z.square().sum().backward()
            results.append((z.detach().cpu(), xi.grad.cpu()))
        out[label] = results
    _save(tmp, "tp_forward", out)


def trainer_runs(tmp, device):
    """The job's runs of the whole trainer (multiproc.dryrun_config with the
    run's overrides), in order; after each, the parameters gathered over the
    model group."""
    job = _job(tmp)
    n = world_size()
    for name, kw in job["runs"]:
        cfg = multiproc.dryrun_config(tmp, n, folder=os.path.join(tmp, name), **kw)
        state = train(cfg, device=device)
        _save(tmp, f"{name}_{state.step}", multiproc.full_params(
            state, cfg, make_mesh(cfg.get("mesh_shape"))))


def prior_runs(tmp, device):
    """The job's train_prior runs, in order; after each, the flow's parameters."""
    job = _job(tmp)
    for name, cfg in job["runs"]:
        state = train_prior(make_config(**cfg), device=device)
        _save(tmp, f"{name}_{state.step}", [p.detach().cpu() for p in state.params])


def cli(tmp, device):
    """cli.main on the job's argv (the CLI joins the group the launcher made)."""
    from feed_forward_vqgan_clip_tpu_torch.cli import main

    main(_job(tmp)["argv"])


def dryrun(tmp, device):
    multiproc.dryrun_worker(tmp, device)


def rendezvous(tmp, device):
    """What the process group is: its backend, world size and rank, and the
    rank's place in a {data: 2, model: 2} mesh."""
    dist = torch.distributed
    m = make_mesh({"data": 2, "model": 2})
    with open(os.path.join(tmp, f"rendezvous_{_rank()}.json"), "w") as fd:
        json.dump({"backend": str(dist.get_backend()), "world": dist.get_world_size(),
                   "rank": dist.get_rank(), "data_index": m.data_index,
                   "model_index": m.model_index}, fd)


def fail_on_rank_1(tmp, device):
    if _rank() == 1:
        raise SystemExit("rank 1 stops here")
    torch.distributed.barrier()

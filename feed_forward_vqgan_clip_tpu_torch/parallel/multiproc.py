"""Real OS processes over torch.distributed, and the trainer's dry run on them.

The counterpart of feed_forward_vqgan_clip_tpu/parallel/multiproc.py.
`run_processes(n, worker, tmp=...)` starts n processes of this module with the
FFVC_* environment (utils.maybe_initialize_distributed) and a `file://`
rendezvous in `tmp`, so no port is opened; each joins the group on `device`
(NCCL on CUDA unless FFVC_DIST_BACKEND says `gloo`, Gloo on the CPU) and calls
`worker` ("module:function") as function(tmp, device). Every process runs
under one deadline; a rank that fails, or the deadline, stops the others and
raises with the failed rank's last output.

`run_dryrun(n)` runs the whole trainer (train/loop.train) on n processes, a
{data: n/2, model: 2} mesh where n is even and at least 4, else {data: n}:
a tiny Mixer with EMA, a noise bank, in-train eval and a log step each step. It
checks that every rank ends with bitwise equal parameters (gathered over the
model group), that only rank 0 wrote the checkpoints and previews, and that the
eval ran. `run_two_process_dryrun` is JAX's name for it: its 2 processes x 2
devices are 4 processes here, one device each.

    python -m feed_forward_vqgan_clip_tpu_torch.parallel.multiproc   # a worker
"""

import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _tail(path: str, n: int = 6000) -> str:
    with open(path, errors="replace") as fd:
        return fd.read()[-n:]


def run_processes(n: int, worker: str, *, tmp: str, timeout: float = 600, device="cuda",
                  env: Optional[Dict[str, str]] = None, pythonpath=()) -> List[str]:
    """Run `worker` ("module:function", called as function(tmp, device)) in n
    processes of one process group; -> each rank's output (stdout and stderr).
    `env` adds variables; `pythonpath` adds directories the worker's module
    needs. Raises when a rank fails or the deadline passes."""
    os.makedirs(tmp, exist_ok=True)
    rdzv = os.path.join(tmp, f"rdzv_{uuid.uuid4().hex}")
    path = os.pathsep.join([REPO_ROOT, *pythonpath, os.environ.get("PYTHONPATH", "")])
    logs = [os.path.join(tmp, f"rank{i}_{os.path.basename(rdzv)}.log") for i in range(n)]
    procs = []
    try:
        for i in range(n):
            penv = dict(os.environ, FFVC_NUM_PROCESSES=str(n), FFVC_PROCESS_ID=str(i),
                        FFVC_INIT_METHOD=f"file://{rdzv}", FFVC_MP_WORKER=worker,
                        FFVC_MP_TMP=tmp, FFVC_MP_DEVICE=str(device), PYTHONPATH=path,
                        FFVC_DIST_TIMEOUT=str(int(timeout)))
            if torch.device(device).type == "cpu":
                penv.setdefault("OMP_NUM_THREADS", "2")
            penv.update(env or {})
            with open(logs[i], "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "feed_forward_vqgan_clip_tpu_torch.parallel.multiproc"],
                    env=penv, stdout=out, stderr=subprocess.STDOUT, cwd=REPO_ROOT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                time.sleep(1.0)  # the ranks a failure brings down go too; report them all
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{worker} on {n} processes passed its {timeout} s; rank 0:"
                                   f"\n{_tail(logs[0])}")
            time.sleep(0.05)
        failed = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed:
            raise RuntimeError("\n".join(
                f"rank {i} of {n} failed (rc={procs[i].returncode}):\n{_tail(logs[i])}"
                for i in failed))
        return [_tail(log, 1 << 20) for log in logs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if os.path.exists(rdzv):
            os.remove(rdzv)


def dryrun_config(tmp: str, n: int, **kw):
    """The dry run's trainer config: JAX's worker's (tiny CLIP and VQGAN, a Mixer
    dim 16 depth 2, noise bank, EMA, in-train eval, a log step each step) on
    the mesh of `n` processes."""
    from feed_forward_vqgan_clip_tpu_torch.config import make_config

    model = 2 if n % 2 == 0 and n >= 4 else 1
    cfg = dict(
        clip_model="tiny",
        vqgan_arch=dict(n_embed=32, embed_dim=8, z_channels=8, ch=8, ch_mult=(1, 2),
                        num_res_blocks=1, attn_resolutions=(4,), resolution=8),
        model_type="mlp_mixer", dim=16, depth=2, dropout=0, vq_image_size=4,
        batch_size=2 * (n // model), repeat=2, cutn=2, cut_size=32, pool_size=32,
        noise_dim=8, nb_noise=4, use_ema=True, lr=1e-3, epochs=100, max_steps=2,
        log_interval=1, folder=os.path.join(tmp, "run"), compute_dtype="float32", seed=0,
        path=os.path.join(tmp, "feats.npz"), eval_path=os.path.join(tmp, "eval_feats.npz"),
        eval_clip_model="tiny", mesh_shape={"data": n // model, "model": model})
    cfg.update(kw)
    return make_config(**cfg)


def write_dryrun_data(tmp: str, rows: int = 8):
    rng = np.random.default_rng(0)
    for name, n in (("feats.npz", rows), ("eval_feats.npz", 5)):
        np.savez(os.path.join(tmp, name), x=rng.normal(size=(n, 32)).astype(np.float32),
                 y=rng.normal(size=(n, 32)).astype(np.float32))


def full_params(state, cfg, mesh) -> Dict[str, torch.Tensor]:
    """The trainer's mapper parameters (`state.params`, this model rank's parts)
    gathered over the model group, by name, on the CPU (collective over the
    model group)."""
    from feed_forward_vqgan_clip_tpu_torch.config import vqgan_arch_config
    from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
    from feed_forward_vqgan_clip_tpu_torch.parallel.mesh import gather_params, mapper_tp_plan

    shape = build_mapper(dict(cfg), vq_channels=int(vqgan_arch_config(cfg)["z_channels"]),
                         device="meta")  # the names and the plan, no weights
    names = [name for name, _ in shape.named_parameters()]
    plan = mapper_tp_plan(shape) if mesh.model > 1 else {}
    sd = dict(zip(names, (p.detach() for p in state.params)))
    return {k: v.cpu() for k, v in gather_params(sd, plan, mesh).items()}


def record_writes():
    """Counts of the checkpoint and preview files this process writes: a dict
    that the writers of io/checkpoint.py and train/loop.py, replaced for the
    rest of the (worker) process, fill."""
    from feed_forward_vqgan_clip_tpu_torch.io import checkpoint as ckpt_io
    from feed_forward_vqgan_clip_tpu_torch.train import loop

    writes = {"checkpoint": 0, "preview": 0}
    real_ckpt, real_grid = ckpt_io.save_checkpoint, loop.save_grid

    def save_checkpoint(*a, **k):
        writes["checkpoint"] += 1
        return real_ckpt(*a, **k)

    def save_grid(*a, **k):
        writes["preview"] += 1
        return real_grid(*a, **k)

    ckpt_io.save_checkpoint, loop.save_grid = save_checkpoint, save_grid
    return writes


def dryrun_worker(tmp: str, device) -> None:
    from feed_forward_vqgan_clip_tpu_torch.parallel.mesh import make_mesh
    from feed_forward_vqgan_clip_tpu_torch.train import loop

    rank, n = torch.distributed.get_rank(), torch.distributed.get_world_size()
    writes = record_writes()
    cfg = dryrun_config(tmp, n)
    state = loop.train(cfg, device=device)
    if state.step != 2:
        raise AssertionError(f"the dry run stopped at step {state.step}, not 2")
    params = full_params(state, cfg, make_mesh(cfg.get("mesh_shape")))
    torch.save(params, os.path.join(tmp, f"params_{rank}.pt"))
    with open(os.path.join(tmp, f"writes_{rank}.json"), "w") as fd:
        json.dump(writes, fd)
    print(f"worker {rank} OK", flush=True)


DRYRUN_WORKER = "feed_forward_vqgan_clip_tpu_torch.parallel.multiproc:dryrun_worker"


def run_dryrun(n: int = 4, *, tmp: Optional[str] = None, timeout: float = 900, device="cuda",
               env: Optional[Dict[str, str]] = None, worker: str = DRYRUN_WORKER,
               pythonpath=()) -> str:
    """The whole trainer on n processes (module docstring); -> the folder with
    the run (`run/`), each rank's `params_<rank>.pt` and `writes_<rank>.json`.
    `worker`: `dryrun_worker` or a function that calls it."""
    tmp = tmp or tempfile.mkdtemp(prefix="ffvc_mp_")
    os.makedirs(tmp, exist_ok=True)
    write_dryrun_data(tmp)
    outputs = run_processes(n, worker, tmp=tmp, timeout=timeout, device=device, env=env,
                            pythonpath=pythonpath)
    if "Eval dists" not in outputs[0] or any("Eval dists" in out for out in outputs[1:]):
        raise AssertionError("the in-train eval did not print on rank 0 alone")
    params = [torch.load(os.path.join(tmp, f"params_{r}.pt")) for r in range(n)]
    for r, p in enumerate(params[1:], 1):
        if sorted(p) != sorted(params[0]) or any(not torch.equal(v, params[0][k])
                                                 for k, v in p.items()):
            raise AssertionError(f"rank {r} ends with other parameters than rank 0")
    for r in range(n):
        with open(os.path.join(tmp, f"writes_{r}.json")) as fd:
            writes = json.load(fd)
        if not (all(writes.values()) if r == 0 else not any(writes.values())):
            raise AssertionError(f"rank {r} wrote {writes}: only rank 0 writes files")
    for name in ("checkpoint.th", "checkpoint_ema.th", "opt.th", "progress.png",
                 "fixed_batch_progress.png"):
        if not os.path.exists(os.path.join(tmp, "run", name)):
            raise AssertionError(f"rank 0 did not write {name}")
    return tmp


def run_two_process_dryrun(tmp: Optional[str] = None, timeout: float = 900, device="cuda") -> str:
    """JAX's name: its 2 processes x 2 devices on {data: 2, model: 2} are 4
    processes here."""
    return run_dryrun(4, tmp=tmp, timeout=timeout, device=device)


def _main() -> None:
    from feed_forward_vqgan_clip_tpu_torch.utils import maybe_initialize_distributed

    tmp, device = os.environ["FFVC_MP_TMP"], os.environ["FFVC_MP_DEVICE"]
    maybe_initialize_distributed(device)
    module, fn = os.environ["FFVC_MP_WORKER"].split(":")
    try:
        getattr(importlib.import_module(module), fn)(tmp, device)
        if torch.distributed.is_initialized():
            # every rank is past its last collective before any rank tears the group down
            torch.distributed.barrier()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _main()

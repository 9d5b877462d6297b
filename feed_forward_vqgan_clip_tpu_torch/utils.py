"""The multi-process rendezvous: `maybe_initialize_distributed`.

The counterpart of feed_forward_vqgan_clip_tpu/utils.py's function of that
name, on torch.distributed. A run of several processes (one device each) is
declared by the environment, in this order:

  * FFVC_NUM_PROCESSES and FFVC_PROCESS_ID, with FFVC_COORDINATOR_ADDRESS
    (host:port of rank 0's store) or FFVC_INIT_METHOD (any torch init method,
    e.g. `file:///tmp/ffvc_rdzv`, which needs no port): the JAX package's
    explicit variables, for a hand-rolled launcher and parallel/multiproc.py;
  * torchrun's RANK and WORLD_SIZE with MASTER_ADDR and MASTER_PORT.

The backend is NCCL where the process computes on CUDA and Gloo where it
computes on the CPU; FFVC_DIST_BACKEND names another (`gloo` lets several
ranks share one card, which NCCL refuses). On CUDA the process selects
`cuda:{LOCAL_RANK}` (LOCAL_RANK, else the rank modulo the card count).
FFVC_DIST_TIMEOUT (seconds, default 600) bounds the rendezvous and every
collective. JAX's `enable_compilation_cache` has no counterpart: there is no
XLA cache.
"""

import datetime
import logging
import os

import torch

log = logging.getLogger(__name__)

EXPLICIT = ("FFVC_NUM_PROCESSES", "FFVC_PROCESS_ID", "FFVC_COORDINATOR_ADDRESS",
            "FFVC_INIT_METHOD")
TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _declared_world(env):
    """-> (world, rank, init_method) the environment declares, or None where it
    declares none. Raises where FFVC_* variables are set but incomplete."""
    init_method = env.get("FFVC_INIT_METHOD")
    if any(env.get(k) for k in EXPLICIT):
        nproc, pid = env.get("FFVC_NUM_PROCESSES"), env.get("FFVC_PROCESS_ID")
        coord = env.get("FFVC_COORDINATOR_ADDRESS")
        if nproc is None or pid is None or not (coord or init_method):
            raise ValueError(
                "a multi-process run needs FFVC_NUM_PROCESSES, FFVC_PROCESS_ID and "
                "FFVC_COORDINATOR_ADDRESS or FFVC_INIT_METHOD; the environment has "
                f"{ {k: env.get(k) for k in EXPLICIT if env.get(k)} }")
        return int(nproc), int(pid), init_method or f"tcp://{coord}"
    if env.get("RANK") is not None and env.get("WORLD_SIZE") is not None:
        if not (env.get("MASTER_ADDR") and env.get("MASTER_PORT")):
            raise ValueError("RANK and WORLD_SIZE are set without MASTER_ADDR and MASTER_PORT")
        return int(env["WORLD_SIZE"]), int(env["RANK"]), "env://"
    partial = [k for k in TORCHRUN if env.get(k) is not None]
    if partial:
        log.warning("torch.distributed not initialised: %s set without RANK and WORLD_SIZE; "
                    "the process stays single", partial)
    return None


def maybe_initialize_distributed(device=None) -> bool:
    """Join the process group the environment declares (module docstring),
    before the process touches its device. `device`: where the process computes
    ("cuda" or "cpu"; default cuda where available), which picks the backend.
    A single process (none declared, or a world of one) is a no-op. Idempotent.
    -> True when the run has more than one process. A declared world that does
    not rendezvous raises; it never carries on as one process."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    declared = _declared_world(os.environ)
    if declared is None:
        return False
    world, rank, init_method = declared
    if world == 1:
        return False
    if not dist.is_available():
        raise RuntimeError("a multi-process run is declared but torch.distributed is missing")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    on_cuda = torch.device(device).type == "cuda"
    backend = os.environ.get("FFVC_DIST_BACKEND") or ("nccl" if on_cuda else "gloo")
    if on_cuda:
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    timeout = datetime.timedelta(seconds=float(os.environ.get("FFVC_DIST_TIMEOUT", 600)))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timeout)
    log.info("torch.distributed initialised: rank %d of %d, backend %s", rank, world, backend)
    return True

"""The ('data', 'model') mesh on torch.distributed, and the helpers around it.

The counterpart of feed_forward_vqgan_clip_tpu/parallel/mesh.py. One process
computes on one device, so the mesh is a layout of ranks: d x m ranks in
row-major order, as JAX's `devices.reshape(d, m)`, rank r at data index r // m
and model index r % m. Ranks {i*m ... i*m+m-1} form data index i's model group
(they hold the shards of one replica); ranks {j, j+m, ...} form model index
j's data group (they hold the same shard of every replica, and average its
gradients). Without a process group the mesh is the single device 1 x 1.

  * `make_mesh`: JAX's shape rules (defaults, a missing axis, the error text);
  * `is_primary`: rank 0, which alone writes files, TensorBoard, wandb and
    stdout;
  * `broadcast_params`: rank 0's tensors to every rank (start-up and resume);
  * `all_reduce_grads_mean`: the gradients (and the step's metrics) averaged
    over the data group through one flat float32 buffer (nothing at d == 1);
  * `mapper_tp_plan`, `shard_params`, `gather_params`: the tensor-parallel
    rule of JAX's `mapper_param_sharding` in the port's (the reference's)
    parameter names, and the moves between a full state dict and one model
    rank's shards. A checkpoint on disk is always the full, unsharded one.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import MixerBlock
from feed_forward_vqgan_clip_tpu_torch.models.mappers.vitgan import VitGANMLP
from feed_forward_vqgan_clip_tpu_torch.models.mappers.xtransformer import XFeedForward

dist = torch.distributed


@dataclass
class Mesh:
    """This rank's place in a d x m mesh and its two process groups (None on a
    single device, where no collective runs)."""

    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def resolve_shape(shape: Optional[dict], n: int):
    """JAX make_mesh's rules: -> (d, m) over n devices."""
    if shape is None:
        shape = {"data": n, "model": 1}
    if "model" not in shape:
        shape = dict(shape, model=1)
    if "data" not in shape:
        shape = dict(shape, data=n // shape["model"])
    d, m = int(shape["data"]), int(shape["model"])
    if d * m != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    return d, m


# the groups of each (world group, d, m): new_group is collective, so a process
# makes those of a shape once, and anew after the world group is replaced
_GROUPS: Dict[tuple, tuple] = {}


def make_mesh(shape: Optional[dict] = None) -> Mesh:
    """`shape` e.g. {'data': 8} or {'data': 4, 'model': 2} over the process
    group's ranks (default: all on 'data'). Collective: every rank calls it,
    and the groups of a shape are made once a process."""
    n = world_size()
    d, m = resolve_shape(None if shape is None else dict(shape), n)
    if n == 1 and not (dist.is_available() and dist.is_initialized()):
        return Mesh()
    key = (dist.group.WORLD, d, m)
    if key not in _GROUPS:
        # every rank makes every group, in one order
        model_groups = [dist.new_group(list(range(i * m, i * m + m))) for i in range(d)]
        data_groups = [dist.new_group(list(range(j, n, m))) for j in range(m)]
        _GROUPS[key] = (data_groups, model_groups)
    data_groups, model_groups = _GROUPS[key]
    rank = dist.get_rank()
    i, j = divmod(rank, m)
    return Mesh(d, m, i, j, data_groups[j], model_groups[i])


def is_primary() -> bool:
    return world_size() == 1 or dist.get_rank() == 0


@torch.no_grad()
def broadcast_params(tensors, src: int = 0) -> None:
    """Every rank's `tensors` set to rank `src`'s, in place (collective)."""
    if world_size() == 1:
        return
    for t in tensors:
        dist.broadcast(t.data, src)


@torch.no_grad()
def all_reduce_grads_mean(params, mesh: Mesh, metrics: Optional[dict] = None):
    """Each parameter's .grad, and the 0-d `metrics`, set to their mean over the
    data group: one flat float32 buffer in parameter order (metrics last), one
    all_reduce(SUM), one divide by d. Collectives sum in a fixed order, so every
    step reduces the same way. The mean over one rank is the identity: at d == 1
    (a world of one, or a TP-only mesh) nothing is copied or sent. -> the
    averaged metrics."""
    if mesh.data == 1:
        return metrics
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    keys = sorted(metrics) if metrics else []
    flat = torch.cat([p.grad.reshape(-1).float() for p in params]
                     + [metrics[k].reshape(1).float() for k in keys])
    dist.all_reduce(flat, group=mesh.data_group)
    flat.div_(mesh.data)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset: offset + n].view_as(p.grad))
        offset += n
    if metrics is None:
        return None
    return dict(metrics, **{k: flat[offset + i] for i, k in enumerate(keys)})


def mapper_tp_plan(mapper) -> Dict[str, int]:
    """{parameter name: the axis its tensor is split on over 'model'} for every
    mapper family, JAX's `mapper_param_sharding` in the port's names: each FFN
    pair column-parallel (output rows and bias split) then row-parallel (input
    columns split, bias replicated), one all-reduce per FFN. The Mixer's token
    FFN (`.0.fn.0` / `.0.fn.3`, size-1 Conv1d weights (out, in, 1)) and channel
    FFN (`.1.fn.0` / `.1.fn.3`), VitGAN's `mlp.linear1` / `linear2`, the
    x-transformer's `net.0.0` / `net.2`. Every other tensor is replicated."""
    pairs = []
    for name, module in mapper.named_modules():
        pre = name + "." if name else ""
        if isinstance(module, MixerBlock):
            pairs += [pre + "0.fn.0", pre + "0.fn.3"], [pre + "1.fn.0", pre + "1.fn.3"]
        elif isinstance(module, VitGANMLP):
            pairs.append([pre + "linear1", pre + "linear2"])
        elif isinstance(module, XFeedForward):
            pairs.append([pre + "net.0.0", pre + "net.2"])
    plan = {}
    for col, row in pairs:
        plan.update({col + ".weight": 0, col + ".bias": 0, row + ".weight": 1})
    return plan


def shard_of(t: torch.Tensor, axis: int, index: int, parts: int) -> torch.Tensor:
    """Part `index` of `parts` equal parts of `t` along `axis` (a view)."""
    size = t.shape[axis]
    if size % parts:
        raise ValueError(f"a tensor of shape {tuple(t.shape)} does not split in {parts} "
                         f"along axis {axis}")
    return t.narrow(axis, index * (size // parts), size // parts)


def shard_params(full: Dict[str, torch.Tensor], plan: Dict[str, int],
                 mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A full state dict -> this model rank's: the planned tensors' parts
    (contiguous copies), the rest as they are."""
    if mesh.model == 1:
        return dict(full)
    return {k: (shard_of(v, plan[k], mesh.model_index, mesh.model).contiguous()
                if k in plan else v) for k, v in full.items()}


@torch.no_grad()
def gather_params(shards: Dict[str, torch.Tensor], plan: Dict[str, int],
                  mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This model rank's state dict -> the full one, the planned tensors
    all-gathered over the model group and joined along their axis (collective
    over the model group: each of its ranks calls it with the same keys)."""
    if mesh.model == 1:
        return dict(shards)
    out = {}
    for k, v in shards.items():
        if k not in plan:
            out[k] = v
            continue
        parts: List[torch.Tensor] = [torch.empty_like(v) for _ in range(mesh.model)]
        dist.all_gather(parts, v.contiguous(), group=mesh.model_group)
        out[k] = torch.cat(parts, dim=plan[k])
    return out

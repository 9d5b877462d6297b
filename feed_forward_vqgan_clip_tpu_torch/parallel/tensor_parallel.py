"""Tensor parallelism over the mesh's 'model' axis: the mappers' FFNs split
Megatron-style, column-parallel then row-parallel.

`shard_mapper_(mapper, mesh)` cuts, in place, every tensor of
mesh.mapper_tp_plan(mapper) to this model rank's part and turns each FFN's
module into its tensor-parallel version (the same parameter names, so a state
dict keeps the reference's keys, with split shapes): `TPMixerBlock` (both of a
Mixer block's FFNs), `TPVitGANMLP`, `TPXFeedForward`. Each FFN runs

    h = gelu(copy_to_model(x) @ W1_part^T + b1_part)   (column-parallel)
    y = reduce_from_model(h @ W2_part^T) + b2          (row-parallel)

where `copy_to_model` is the identity forward with an all-reduce of the input
gradient backward, and `reduce_from_model` an all-reduce forward with the
identity backward: one all-reduce per FFN each way, the count of JAX's comment
(parallel/mesh.py:98-104). The sums run in float32. The hidden layer's dropout
draws the unsharded mask and keeps its part (mixer.Dropout's `shard`).

Under TP the mapper runs its module path: the Mixer kernels (K2-K8) hold whole
weight tensors (models/mappers/fused.fused_supported reads `mapper.tp`). The VQ
(K1), the warps (K9/K10) and the CLIP tower's K11 see no sharded tensor and
stay on their kernels: torch has no GSPMD partitioner for a kernel to hide from,
which is why JAX turns its kernels off under TP and the port does not.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import MixerBlock
from feed_forward_vqgan_clip_tpu_torch.models.mappers.vitgan import VitGANMLP
from feed_forward_vqgan_clip_tpu_torch.models.mappers.xtransformer import XFeedForward
from feed_forward_vqgan_clip_tpu_torch.parallel.mesh import Mesh, mapper_tp_plan, shard_of

dist = torch.distributed


class TPInfo(NamedTuple):
    group: object
    index: int
    parts: int

    def shard(self, axis: int):
        """The Dropout `shard` of a hidden layer split along `axis`."""
        return (axis, self.index, self.parts)


def _all_reduce_f32(x, group):
    y = x.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x, group):
    """Identity forward, all-reduce of the gradient over `group` backward."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """All-reduce (sum) over `group` forward, identity backward."""
    return _ReduceFromModel.apply(x, group)


class TPMixerBlock(MixerBlock):
    """MixerBlock with t1 / c1 split by output rows (their biases too) and t2 /
    c2 by input columns; the output biases are added once, after the sum."""

    def forward(self, x, generator=None):
        dt, tp = self.dtype, self.tp
        tok, ch = self[0], self[1]
        t1, t2 = tok.fn[0], tok.fn[3]
        h = copy_to_model(tok.norm(x), tp.group)
        h = torch.matmul(t1.weight[:, :, 0].to(dt), h) + t1.bias.to(dt)[:, None]
        h = tok.fn[2](F.gelu(h), generator, tp.shard(1))
        h = reduce_from_model(torch.matmul(t2.weight[:, :, 0].to(dt), h), tp.group)
        x = x + tok.fn[4](h + t2.bias.to(dt)[:, None], generator)

        c1, c2 = ch.fn[0], ch.fn[3]
        h = copy_to_model(ch.norm(x), tp.group)
        h = F.linear(h, c1.weight.to(dt), c1.bias.to(dt))
        h = ch.fn[2](F.gelu(h), generator, tp.shard(h.dim() - 1))
        h = reduce_from_model(F.linear(h, c2.weight.to(dt)), tp.group)
        return x + ch.fn[4](h + c2.bias.to(dt), generator)


def _row_parallel(linear, h, group):
    dt = linear.dtype
    return reduce_from_model(F.linear(h.to(dt), linear.weight.to(dt)), group) + linear.bias.to(dt)


class TPVitGANMLP(VitGANMLP):
    def forward(self, x, generator=None):
        tp = self.tp
        h = F.gelu(self.linear1(copy_to_model(x, tp.group)))
        h = self.dropout(h, generator, tp.shard(h.dim() - 1))
        return self.dropout(_row_parallel(self.linear2, h, tp.group), generator)


class TPXFeedForward(XFeedForward):
    def forward(self, x, generator=None):
        tp = self.tp
        h = self.net[0](copy_to_model(x, tp.group))
        h = self.net[1](h, generator, tp.shard(h.dim() - 1))
        return _row_parallel(self.net[2], h, tp.group)


_TP_CLASSES = {MixerBlock: TPMixerBlock, VitGANMLP: TPVitGANMLP, XFeedForward: TPXFeedForward}


@torch.no_grad()
def shard_mapper_(mapper: nn.Module, mesh: Mesh) -> nn.Module:
    """`mapper` (full weights, the same on every model rank) cut in place to this
    model rank's part of mesh.mapper_tp_plan, its FFN modules turned
    tensor-parallel; `mapper.tp` marks it. No-op at model == 1."""
    if mesh.model == 1:
        return mapper
    for name, axis in mapper_tp_plan(mapper).items():
        owner, attr = name.rsplit(".", 1)
        module = mapper.get_submodule(owner)
        p = getattr(module, attr)
        part = shard_of(p.detach(), axis, mesh.model_index, mesh.model).clone()
        setattr(module, attr, nn.Parameter(part, requires_grad=p.requires_grad))
    tp = TPInfo(mesh.model_group, mesh.model_index, mesh.model)
    for module in mapper.modules():
        if type(module) in _TP_CLASSES:
            module.__class__ = _TP_CLASSES[type(module)]
            module.tp = tp
    mapper.tp = tp
    return mapper


def tp_grad_norm(mapper: nn.Module, mesh: Mesh):
    """-> grads -> the global norm of the whole gradient (optax's over JAX's
    global arrays) for `mapper`'s parameters in order: the squares of the split
    tensors' parts summed over the model group, each replicated tensor's once."""
    plan = mapper_tp_plan(mapper)
    split = [name in plan for name, _ in mapper.named_parameters()]

    def global_norm(grads):
        sq = torch.stack(torch._foreach_norm(grads)).square()
        mask = torch.tensor(split, device=sq.device)
        parts = torch.where(mask, sq, torch.zeros_like(sq)).sum()
        dist.all_reduce(parts, group=mesh.model_group)
        return torch.sqrt(parts + torch.where(mask, torch.zeros_like(sq), sq).sum())

    return global_norm

"""Conditional affine coupling flow: the text -> image-embedding prior.

Port of feed_forward_vqgan_clip_tpu/models/flow.py (net2net's
ConditionalFlatCouplingFlow as the reference drives it): `forward(x, cond) ->
(z, logdet)` for NLL training, `reverse(z, cond)` and `Prior.sample(cond,
generator)` for generation. Each flow block: ActNorm -> conditional double
affine coupling (two passes, each scaling and shifting one half conditioned on
[the other half, the embedded cond]; tanh-bounded log scale; halves swapped
between passes) -> a fixed channel shuffle. A small leaky-relu MLP embeds the
conditioning once, shared by every block. Flat (B, C) vectors throughout; the
reference's (B, C, 1, 1) shape lives only in the ActNorm parameters. float32.

Attribute names are net2net's state-dict keys, so a reference prior `.th`
({model, step, input_size, output_size, config}) loads with load_state_dict (a
JAX prior directory, meta.json and params.msgpack, through io/from_jax.py):
`embedder.main.N`, `sub_layers.{i}.norm_layer.{loc, scale}` of shape
(1, C, 1, 1) with the buffer `initialized`, `sub_layers.{i}.coupling.{s, t}.{j}.
main.N` and `sub_layers.{i}.shuffle.{forward, backward}_shuffle_idx`.

As in the JAX package, a fresh ActNorm starts at loc 0, scale 1 (net2net
initialises it from the first batch; loaded priors carry their trained values),
and a fresh block's permutation is `np.random.RandomState(block_index)`'s. The
matrix products are plain torch.nn.functional.linear: the JAX package computes
them outside any Pallas kernel.
"""

import json
import os

import numpy as np
import torch
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.io import msgpack
from feed_forward_vqgan_clip_tpu_torch.io.checkpoint import load_th, plain_config
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import flow_state_dict, numpy_leaves


class BasicFC(nn.Module):
    """net2net BasicFullyConnectedNet: Linear -> LeakyReLU(0.01), depth + 1
    times, -> Linear [-> tanh], as the Sequential `main`."""

    def __init__(self, in_dim, hidden_dim, out_dim, depth=2, use_tanh=False, device=None):
        super().__init__()
        layers = [nn.Linear(in_dim, hidden_dim, device=device), nn.LeakyReLU(0.01)]
        for _ in range(depth):
            layers += [nn.Linear(hidden_dim, hidden_dim, device=device), nn.LeakyReLU(0.01)]
        layers.append(nn.Linear(hidden_dim, out_dim, device=device))
        if use_tanh:
            layers.append(nn.Tanh())
        self.main = nn.Sequential(*layers)

    def forward(self, x):
        return self.main(x)


class ActNorm(nn.Module):
    """h = scale * (x + loc) per channel; logdet = sum log |scale|. `initialized`
    is net2net's flag of its data-dependent init, kept so its files load (1:
    this port never re-initialises from data)."""

    def __init__(self, channels, device=None):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(1, channels, 1, 1, device=device))
        self.scale = nn.Parameter(torch.ones(1, channels, 1, 1, device=device))
        self.register_buffer("initialized", torch.tensor(1, dtype=torch.uint8, device=device))

    def forward(self, x, reverse=False):
        loc, scale = self.loc.reshape(1, -1), self.scale.reshape(1, -1)
        if reverse:
            return x / scale - loc
        logdet = torch.log(torch.abs(scale)).sum().expand(x.shape[0])
        return scale * (x + loc), logdet


class ConditionalDoubleCoupling(nn.Module):
    """Two affine-coupling passes; pass i transforms the second half conditioned on
    [first half, cond]; the halves are swapped before the second pass."""

    def __init__(self, channels, cond_dim, hidden_dim, hidden_depth, device=None):
        super().__init__()
        half = channels // 2
        self.half = half
        self.s = nn.ModuleList(BasicFC(half + cond_dim, hidden_dim, half, hidden_depth,
                                       use_tanh=True, device=device) for _ in range(2))
        self.t = nn.ModuleList(BasicFC(half + cond_dim, hidden_dim, half, hidden_depth,
                                       device=device) for _ in range(2))

    def forward(self, x, cond, reverse=False):
        half = self.half
        if not reverse:
            logdet = x.new_zeros(x.shape[0])
            for i in range(2):
                if i % 2 != 0:
                    x = torch.cat([x[:, half:], x[:, :half]], dim=1)
                xa, xb = x[:, :half], x[:, half:]
                ci = torch.cat([xa, cond], dim=1)
                scale = self.s[i](ci)
                x = torch.cat([xa, xb * torch.exp(scale) + self.t[i](ci)], dim=1)
                logdet = logdet + scale.sum(dim=1)
            return x, logdet
        for i in reversed(range(2)):
            xa, xb = x[:, :half], x[:, half:]
            ci = torch.cat([xa, cond], dim=1)
            x = torch.cat([xa, (xb - self.t[i](ci)) * torch.exp(-self.s[i](ci))], dim=1)
            if i % 2 != 0:
                x = torch.cat([x[:, half:], x[:, :half]], dim=1)
        return x


class Shuffle(nn.Module):
    """A fixed channel permutation and its inverse, as net2net's buffers."""

    def __init__(self, channels, block_index=0, device=None):
        super().__init__()
        perm = torch.from_numpy(np.random.RandomState(block_index).permutation(channels))
        self.register_buffer("forward_shuffle_idx", perm.to(device))
        self.register_buffer("backward_shuffle_idx", torch.argsort(perm).to(device))

    def forward(self, x, reverse=False):
        return x[:, self.backward_shuffle_idx if reverse else self.forward_shuffle_idx]


class FlowBlock(nn.Module):
    def __init__(self, channels, cond_dim, hidden_dim, hidden_depth, block_index=0,
                 device=None):
        super().__init__()
        self.norm_layer = ActNorm(channels, device=device)
        self.coupling = ConditionalDoubleCoupling(channels, cond_dim, hidden_dim, hidden_depth,
                                                  device=device)
        self.shuffle = Shuffle(channels, block_index, device=device)

    def forward(self, x, cond, reverse=False):
        if not reverse:
            h, ld0 = self.norm_layer(x)
            h, ld1 = self.coupling(h, cond)
            return self.shuffle(h), ld0 + ld1
        h = self.coupling(self.shuffle(x, reverse=True), cond, reverse=True)
        return self.norm_layer(h, reverse=True)


class ConditionalFlatCouplingFlow(nn.Module):
    def __init__(self, in_channels, conditioning_dim, embedding_dim, hidden_dim, hidden_depth,
                 n_flows, conditioning_depth=2, conditioning_hidden_dim=256, device=None):
        super().__init__()
        self.in_channels = in_channels
        self.conditioning_dim = conditioning_dim
        self.n_flows = n_flows
        self.embedder = BasicFC(conditioning_dim, conditioning_hidden_dim, embedding_dim,
                                conditioning_depth, device=device)
        self.sub_layers = nn.ModuleList(
            FlowBlock(in_channels, embedding_dim, hidden_dim, hidden_depth, block_index=i,
                      device=device) for i in range(n_flows))

    def forward(self, x, cond):
        """x (B, C) flow input (image embedding), cond (B, D) text embedding ->
        (z (B, C), logdet (B,)), float32."""
        emb = self.embedder(cond.float())
        h, logdet = x.float(), x.new_zeros(x.shape[0], dtype=torch.float32)
        for blk in self.sub_layers:
            h, ld = blk(h, emb)
            logdet = logdet + ld
        return h, logdet

    def reverse(self, z, cond):
        emb = self.embedder(cond.float())
        h = z.float()
        for blk in reversed(self.sub_layers):
            h = blk(h, emb, reverse=True)
        return h

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """The JAX module's init: lecun-normal dense kernels (N(0, 1/fan_in)), zero
        biases; ActNorm at loc 0, scale 1; the permutations as built."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                w = torch.randn(m.weight.shape, generator=generator, device=generator.device)
                m.weight.copy_(w * m.in_features ** -0.5)
                m.bias.zero_()
            elif isinstance(m, ActNorm):
                m.loc.zero_()
                m.scale.fill_(1.0)
        return self


def nll_loss(z, logdet):
    """net2net's NLL: mean(0.5 * sum(z^2)) - mean(logdet); -> (loss, {nll_loss,
    nlogdet_loss})."""
    nll = (0.5 * z.square()).sum(dim=1).mean()
    return nll - logdet.mean(), {"nll_loss": nll, "nlogdet_loss": -logdet.mean()}


class Prior:
    """A loaded flow with the reference's 4-D call conventions flattened away:
    sample(cond, generator) takes and returns flat (B, D) tensors."""

    def __init__(self, flow: ConditionalFlatCouplingFlow):
        self.flow = flow

    def noise(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """The flow's (n, C) Gaussian input, drawn from `generator` on its device."""
        return torch.randn(n, self.flow.in_channels, generator=generator,
                           device=generator.device)

    @torch.no_grad()
    def reverse(self, z, cond):
        return self.flow.reverse(z, cond)

    def sample(self, cond, generator: torch.Generator):
        """cond (B, D) -> (B, C) float32 on cond's device: reverse of a Gaussian z
        drawn from `generator`."""
        return self.reverse(self.noise(len(cond), generator).to(cond.device), cond)


def build_prior_model(config: dict, input_size: int, output_size: int,
                      device=None) -> ConditionalFlatCouplingFlow:
    """The reference's build_prior_model: the flow of `config` (its "model" entry,
    or the dict itself), C = output_size, D = input_size; torch's default init."""
    m = config["model"] if "model" in config else config
    return ConditionalFlatCouplingFlow(
        in_channels=int(output_size), conditioning_dim=int(input_size),
        embedding_dim=int(m["embedding_dim"]), hidden_dim=int(m["hidden_dim"]),
        hidden_depth=int(m["hidden_depth"]), n_flows=int(m["n_flows"]), device=device)


def complete_state_dict(sd: dict) -> dict:
    """`sd` with the buffers net2net files may lack filled in: ActNorm's
    `initialized` (1) and each shuffle's `backward_shuffle_idx` (the inverse of
    its forward index); floating-point entries as float32."""
    sd = {k: (v.float() if v.is_floating_point() else v) for k, v in sd.items()}
    for k in list(sd):
        if k.endswith(".norm_layer.loc"):
            sd.setdefault(k[: -len("loc")] + "initialized", torch.tensor(1, dtype=torch.uint8))
        elif k.endswith(".forward_shuffle_idx"):
            sd.setdefault(k.replace("forward_", "backward_"), torch.argsort(sd[k]))
    return sd


def load_prior_model(prior_path: str, *, device="cuda") -> Prior:
    """A prior from a reference torch `.th` ({model, step, input_size,
    output_size, config}) or a JAX prior directory (`meta.json` with config,
    input_size and output_size; `params.msgpack` the flow's {params, buffers})
    on `device`, eval mode, no grad."""
    if os.path.isdir(prior_path):
        with open(os.path.join(prior_path, "meta.json")) as fd:
            ckpt = json.load(fd)
        variables = msgpack.load(os.path.join(prior_path, "params.msgpack"))
        ckpt["model"] = flow_state_dict(numpy_leaves(variables))
    else:
        ckpt = load_th(prior_path)
    flow = build_prior_model(plain_config(ckpt["config"]), int(ckpt["input_size"]),
                             int(ckpt["output_size"]), device=device)
    flow.load_state_dict(complete_state_dict(ckpt["model"]))
    flow.eval().requires_grad_(False)
    return Prior(flow)


def save_prior(path: str, flow: ConditionalFlatCouplingFlow, config: dict, step: int = 0,
               epoch: int = 0) -> str:
    """`flow` as a reference prior `.th`: {model (float32 on the CPU), step, epoch,
    input_size, output_size, config}, written atomically."""
    obj = {"model": {k: v.detach().cpu() for k, v in flow.state_dict().items()},
           "step": int(step), "epoch": int(epoch), "input_size": int(flow.conditioning_dim),
           "output_size": int(flow.in_channels), "config": plain_config(config)}
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path

"""Train state: the mapper's parameters, Adam with cast-state moments, the
cosine schedule, gradient clipping, the EMA of the parameters, the step count
and the loss EMA.

Port of feed_forward_vqgan_clip_tpu/train/state.py (`TrainState`,
`_scale_by_adam_cast_state`, `make_optimizer`, `make_train_state`). One update,
in optax's chain order:

    g  = g * max_norm / ||g||  where ||g|| >= max_norm   (clip_by_global_norm)
    mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g^2;  count += 1
    p += -lr(count - 1) * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
    ema = d ema + (1 - d) p,  d = min(ema_decay, (1 + n) / (10 + n)), n = step + 1

Adam's math is float32 and both moments are stored in `opt_dtype` (bfloat16 by
default, as in the JAX package; float32 is the reference's torch.Adam). lr(c)
is the constant lr or optax's `cosine_decay_schedule(lr, max_steps, alpha=0)`
at the count before the update. The EMA warm-up ramp is torch_ema's, with n the
persisted step count, so a resumed run keeps the uninterrupted run's decays.

Unlike the JAX state, which a jitted step replaces, this one is updated in place:
the parameters are the mapper's own nn.Parameters (the EMA, where kept, another
module's), and the moments are updated with torch's multi-tensor (`_foreach`)
ops.
"""

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Union

import torch

F32 = torch.float32


@dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def cosine_decay_schedule(lr: float, decay_steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(lr, decay_steps, alpha=0): count -> lr * 0.5 *
    (1 + cos(pi * min(count, decay_steps) / decay_steps)), rounded to float32."""

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        return float(torch.tensor(lr * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps)),
                                  dtype=F32))

    return schedule


class CastStateAdam:
    """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8), both moments
    stored in `state_dtype`, the learning rate a float or a schedule of the
    update count, and optional global-norm clipping of the grads before it."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: Union[float, Callable[[int], float]], state_dtype=torch.bfloat16,
                 clip_grad_norm: Optional[float] = None):
        self.lr = lr
        self.state_dtype = state_dtype
        self.clip_grad_norm = clip_grad_norm
        # grads -> their global norm, where some are parts of tensors split over
        # devices (parallel/tensor_parallel.tp_grad_norm); None: the grads are whole
        self.global_norm: Optional[Callable] = None

    def init(self, params) -> AdamState:
        zeros = [torch.zeros_like(p, dtype=self.state_dtype) for p in params]
        return AdamState(0, zeros, [torch.zeros_like(z) for z in zeros])

    @torch.no_grad()
    def update(self, params, grads, state: AdamState):
        """One step on `params` (in place) from float32 `grads`; returns the state."""
        grads = [g.float() for g in grads]
        if self.clip_grad_norm:
            # optax.clip_by_global_norm: g * max_norm / ||g|| where ||g|| >= max_norm,
            # decided on the device (no host sync)
            if self.global_norm is not None:
                norm = self.global_norm(grads)
            else:
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            factor = torch.where(norm < self.clip_grad_norm, torch.ones_like(norm),
                                 self.clip_grad_norm / norm)
            grads = torch._foreach_mul(grads, factor)
        mu = torch._foreach_mul([m.to(F32) for m in state.mu], self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
        nu = torch._foreach_mul([v.to(F32) for v in state.nu], self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                   1.0 - self.b2))
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        count = state.count + 1
        # the bias corrections in float32, as optax computes them
        n = torch.tensor(float(count), dtype=F32)
        bc1 = float(1.0 - torch.tensor(self.b1, dtype=F32) ** n)
        bc2 = float(1.0 - torch.tensor(self.b2, dtype=F32) ** n)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_add_(params, torch._foreach_mul(upd, -lr))
        for dst, src in ((state.mu, mu), (state.nu, nu)):
            torch._foreach_copy_(dst, src)  # rounds to the state dtype
        state.count = count
        return state


def make_optimizer(lr: float, *, scheduler: Optional[str] = None,
                   max_steps: Optional[int] = None, clip_grad_norm: Optional[float] = None,
                   opt_dtype: Optional[str] = None) -> CastStateAdam:
    """Adam(lr) with optional cosine annealing to 0 over max_steps and global-norm
    clipping, moments stored in `opt_dtype` ('bfloat16' or 'float32'). Only
    'cosine' is supported, like the reference."""
    if scheduler is None:
        sched = lr
    elif scheduler == "cosine":
        if not max_steps:
            raise ValueError("scheduler='cosine' requires max_steps")
        sched = cosine_decay_schedule(lr, int(max_steps))
    else:
        raise ValueError(f"unknown scheduler {scheduler!r} (the reference supports 'cosine')")
    dtype = {None: F32, "float32": F32, "bfloat16": torch.bfloat16}[opt_dtype]
    return CastStateAdam(sched, state_dtype=dtype,
                         clip_grad_norm=float(clip_grad_norm) if clip_grad_norm else None)


@dataclass
class TrainState:
    params: List[torch.nn.Parameter]
    opt_state: AdamState
    tx: CastStateAdam
    step: int = 0
    # EMA of the loss on the device (no host sync per step)
    avg_loss: Optional[torch.Tensor] = None
    ema_params: Optional[List[torch.Tensor]] = None  # None when the EMA is off
    ema_decay: float = 0.995
    ema_warmup: bool = True

    @torch.no_grad()
    def apply_gradients(self):
        """Adam on every parameter from its .grad, then the EMA; the step count
        rises by one."""
        self.tx.update(self.params, [p.grad for p in self.params], self.opt_state)
        if self.ema_params is not None:
            d = torch.tensor(self.ema_decay, dtype=F32)
            if self.ema_warmup:
                n = torch.tensor(float(self.step + 1), dtype=F32)
                d = torch.minimum(d, (1.0 + n) / (10.0 + n))
            torch._foreach_mul_(self.ema_params, float(d))
            torch._foreach_add_(self.ema_params, torch._foreach_mul(self.params, float(1.0 - d)))
        self.step += 1
        return self


def make_train_state(params, tx: CastStateAdam, *, use_ema: bool = False,
                     ema_decay: float = 0.995, ema_warmup: bool = True, step: int = 0,
                     ema_params=None) -> TrainState:
    """The state over the parameters that require grad. With `use_ema`, the EMA
    is `ema_params` (updated in place; e.g. another module's parameters) or,
    without them, a copy of the parameters."""
    params = [p for p in params if p.requires_grad]
    dev = params[0].device
    if use_ema and ema_params is None:
        ema_params = [p.detach().clone() for p in params]
    return TrainState(params=params, opt_state=tx.init(params), tx=tx, step=int(step),
                      avg_loss=torch.ones((), dtype=F32, device=dev),
                      ema_params=list(ema_params) if use_ema else None,
                      ema_decay=float(ema_decay), ema_warmup=bool(ema_warmup))

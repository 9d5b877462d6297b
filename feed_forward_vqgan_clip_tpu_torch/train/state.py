"""Train state: the mapper's parameters, Adam with cast-state moments, the step
count and the loss EMA.

Port of feed_forward_vqgan_clip_tpu/train/state.py (`TrainState`,
`_scale_by_adam_cast_state`, `make_optimizer`, `make_train_state`). Adam's update
math is float32 and both moments are stored in `opt_dtype` (bfloat16 by default,
as in the JAX package; float32 is the reference's torch.Adam), with optax's bias
correction and count:

    mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g^2;  count += 1
    p += -lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

Unlike the JAX state, which a jitted step replaces, this one is updated in place:
the parameters are the mapper's own nn.Parameters, and the moments are updated
with torch's multi-tensor (`_foreach`) ops. The EMA of the parameters, the
cosine schedule and gradient clipping come with the trainer (ROADMAP A10).
"""

from dataclasses import dataclass
from typing import List, Optional

import torch


@dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class CastStateAdam:
    """Adam(lr) with optax's defaults (b1 0.9, b2 0.999, eps 1e-8) and both
    moments stored in `state_dtype`."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float, state_dtype=torch.bfloat16):
        self.lr = lr
        self.state_dtype = state_dtype

    def init(self, params) -> AdamState:
        zeros = [torch.zeros_like(p, dtype=self.state_dtype) for p in params]
        return AdamState(0, zeros, [torch.zeros_like(z) for z in zeros])

    @torch.no_grad()
    def update(self, params, grads, state: AdamState):
        """One step on `params` (in place) from float32 `grads`; returns the state."""
        f32 = torch.float32
        grads = [g.float() for g in grads]
        mu = torch._foreach_mul([m.to(f32) for m in state.mu], self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
        nu = torch._foreach_mul([v.to(f32) for v in state.nu], self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                   1.0 - self.b2))
        count = state.count + 1
        # the bias corrections in float32, as optax computes them
        n = torch.tensor(float(count), dtype=f32)
        bc1 = float(1.0 - torch.tensor(self.b1, dtype=f32) ** n)
        bc2 = float(1.0 - torch.tensor(self.b2, dtype=f32) ** n)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_add_(params, torch._foreach_mul(upd, -self.lr))
        for dst, src in ((state.mu, mu), (state.nu, nu)):
            torch._foreach_copy_(dst, src)  # rounds to the state dtype
        state.count = count
        return state


def make_optimizer(lr: float, *, opt_dtype: Optional[str] = None) -> CastStateAdam:
    """Adam(lr) with moments stored in `opt_dtype` ('bfloat16' or 'float32')."""
    dtype = {None: torch.float32, "float32": torch.float32,
             "bfloat16": torch.bfloat16}[opt_dtype]
    return CastStateAdam(lr, state_dtype=dtype)


@dataclass
class TrainState:
    params: List[torch.nn.Parameter]
    opt_state: AdamState
    tx: CastStateAdam
    step: int = 0
    # EMA of the loss on the device (no host sync per step)
    avg_loss: Optional[torch.Tensor] = None

    def apply_gradients(self):
        """Adam on every parameter from its .grad; the step count rises by one."""
        self.tx.update(self.params, [p.grad for p in self.params], self.opt_state)
        self.step += 1
        return self


def make_train_state(params, tx: CastStateAdam) -> TrainState:
    params = [p for p in params if p.requires_grad]
    dev = params[0].device
    return TrainState(params=params, opt_state=tx.init(params), tx=tx,
                      avg_loss=torch.ones((), dtype=torch.float32, device=dev))

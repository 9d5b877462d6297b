"""The pre-LN MLP sublayer of the CLIP ViT blocks on the card (K11): the LayerNorm
rows and four GEMMs with fused epilogues, in bf16 on the Hopper GEMM of
csrc/wgmma_gemm.cuh (TMA, wgmma; ops/kernels/wgmma.py, shared with the Mixer block),
with the LayerNorm backward rows and the fixed-order sums the Mixer kernels share.

Replaces feed_forward_vqgan_clip_tpu/ops/pallas/mlp_ln.py: `mlp_ln` its
`_fwd_kernel` (`_fwd_res`), `mlp_ln_bwd` its `_bwd_kernel` (`_bwd`), and `MlpLn`
the `fused_mlp_ln` custom_vjp that joins them. For x (rows, D) in the working
dtype, following the JAX kernels:

    xhat, inv = (x - mean) * inv, LN statistics in f32 (var = E[x^2] - E[x]^2
                clamped at 0, eps 1e-5), `_ln_stats`
    xn  = round(xhat * scale + bias)
    h   = xn W1^T + b1                              f32 accumulation   (fc1)
    g, dg = act(h), act'(h), both rounded            quick_gelu or exact gelu
    out = x + round(g W2^T + b2)                                        (fc2)

and the backward, the statistics recomputed from the saved x:

    da  = round((dy W2) * dg)                                           (dgh)
    dxn = da W1                                                         (dxn)
    dx  = dy + LN'(dxn)
    dW1 = da^T xn, dW2 = dy^T g, db1 = sum(dy W2 * dg), db2 = sum(dy),
    dscale = sum(dxn * xhat), dbias = sum(dxn)

Weights keep nn.Linear's (out, in) layout: fc1 and fc2 read them K-major, dgh
and dxn MN-major (wgmma's transpose mode), so no transposed copy is made per
step. In bf16 fc1, fc2, dgh and dxn run on the wgmma GEMM, whose tile width
`wgmma.wgmma_plan` picks per GEMM; the float32 route and the parameter-grad GEMMs (dW1,
dW2: an M-major A) run on the WMMA tile of csrc/mixer_tile.cuh. The backward
recomputes the LN statistics from the saved x (as the TPU kernel does; no `inv`
is saved). The parameter grads are computed only where asked for: the frozen
CLIP tower of the train loss needs dx alone (two GEMMs and one row kernel), and
dx is the same bits either way.

Every wrapper launches its kernels for a CUDA tensor, runs its plain PyTorch
version (the `*_plain` function beside it) only for a CPU tensor, and counts its
launches on `.launches`. `mlp_ln_supported` is the JAX package's shape gate,
kept so that both packages route the same shapes through the sublayer kernel.
The float32 kernels take any shape; the bf16 ones need D and E multiples of 8
(TMA's 16-byte row strides), which every shape of the gate has.
"""

from typing import NamedTuple, Optional

import torch

from feed_forward_vqgan_clip_tpu_torch.ops.kernels import build, wgmma
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
    _check_like,
    _Launcher,
    _ln_bwd_plain,
    _ln_stats,
    _ptr,
    split_k_plan,
)
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.wgmma import ACTIVATIONS, act_val_grad

_ROW_TILES = (512, 448, 384, 320, 256, 192, 128, 64, 32, 16)


def mlp_ln_supported(n: int, d: int, e: int) -> bool:
    """The JAX kernel's shape gate (`mlp_ln_supported`): D and E multiples of
    128, a row tile of at most 512 that divides n, the TPU's 100 MiB VMEM budget."""
    if d % 128 or e % 128:
        return False
    r = next((r for r in _ROW_TILES if n % r == 0), 0)
    if not r:
        return False
    vmem = 2 * d * e * 2 + 3 * r * d * 4 + 3 * r * e * 4 + d * e * 4 * 2
    return vmem <= 100 * 1024 * 1024


class MlpLnWeights(NamedTuple):
    """One sublayer's parameters as the kernels take them: matrices in the working
    dtype in nn.Linear's (out, in) layout, the rest float32."""

    ln_w: torch.Tensor  # (D,)   ln_2.weight
    ln_b: torch.Tensor  # (D,)   ln_2.bias
    w1: torch.Tensor    # (E, D) mlp.c_fc.weight
    b1: torch.Tensor    # (E,)
    w2: torch.Tensor    # (D, E) mlp.c_proj.weight
    b2: torch.Tensor    # (D,)


MATRICES = ("w1", "w2")


class MlpLnGrads(NamedTuple):
    """`_bwd_kernel`'s outputs, float32: dx, and the parameter grads in
    MlpLnWeights' layouts (None where they were not asked for)."""

    dx: torch.Tensor
    ln_w: Optional[torch.Tensor] = None
    ln_b: Optional[torch.Tensor] = None
    w1: Optional[torch.Tensor] = None
    b1: Optional[torch.Tensor] = None
    w2: Optional[torch.Tensor] = None
    b2: Optional[torch.Tensor] = None


# ---------------------------------------------------------------- plain versions


def mlp_ln_plain(x, w: MlpLnWeights, act="quick_gelu"):
    """`_fwd_kernel` in plain PyTorch: x (rows, D) -> (out, g, dg) in x's dtype.
    Products in float32 (exact for bf16 operands), rounded where the kernel rounds."""
    dt = x.dtype
    xhat, _ = _ln_stats(x)
    xn = (xhat * w.ln_w + w.ln_b).to(dt)
    h = xn.float() @ w.w1.float().T + w.b1
    g, dg = (v.to(dt) for v in act_val_grad(h, act))
    return x + (g.float() @ w.w2.float().T + w.b2).to(dt), g, dg


def mlp_ln_bwd_plain(dy, x, g, dg, w: MlpLnWeights, params=True):
    """`_bwd_kernel` in plain PyTorch: dy (rows, D) float32, the saved x, g and dg
    -> MlpLnGrads (dx alone unless `params`)."""
    dt = g.dtype
    dyd = dy.to(dt).float()
    xhat, inv = _ln_stats(x)
    daf = (dyd @ w.w2.float()) * dg.float()
    da = daf.to(dt).float()
    dxn = da @ w.w1.float()
    dx = dy + _ln_bwd_plain(dxn, xhat, inv, w.ln_w)
    if not params:
        return MlpLnGrads(dx)
    xn = (xhat * w.ln_w + w.ln_b).to(dt).float()
    return MlpLnGrads(dx=dx, ln_w=(dxn * xhat).sum(0), ln_b=dxn.sum(0), w1=da.T @ xn,
                      b1=daf.sum(0), w2=dyd.T @ g.float(), b2=dy.sum(0))


# ---------------------------------------------------------------- kernels


def _check(x, w: MlpLnWeights):
    if x.device.type != "cuda":
        raise ValueError(f"mlp_ln kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mlp_ln kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, D), got {tuple(x.shape)}")
    d, e = x.shape[1], w.w1.shape[0]
    shapes = {"ln_w": (d,), "ln_b": (d,), "w1": (e, d), "b1": (e,), "w2": (d, e), "b2": (d,)}
    for name, shape in shapes.items():
        want = x.dtype if name in MATRICES else torch.float32
        _check_like(f"weight {name}", getattr(w, name), shape, want, x.device)
    if x.dtype == torch.bfloat16 and (d % 8 or e % 8):
        raise ValueError(f"the bf16 kernels need D and E multiples of 8 (TMA's 16-byte row "
                         f"strides), got D={d}, E={e}")


def mlp_ln(x, w: MlpLnWeights, act="quick_gelu"):
    """The sublayer forward, x (rows, D) -> (out, g, dg) in x's dtype: out the
    sublayer's output, g and dg the activation's value and derivative (E wide)
    the backward reads.

    A CUDA tensor launches the kernels; a CPU tensor runs the plain version."""
    if x.device.type == "cpu":
        return mlp_ln_plain(x, w, act)
    if act not in ACTIVATIONS:
        raise ValueError(f"activation {act!r}: the kernel has {sorted(ACTIVATIONS)}")
    _check(x, w)
    x = x.contiguous()
    n, d = x.shape
    e = w.w1.shape[0]
    k = _Launcher(x.device, x.dtype)
    with torch.cuda.device(x.device):
        xn = torch.empty_like(x)
        k.ln(x, w.ln_w, w.ln_b, xn, n, d, centered=1)
        g, dg = k.empty(n, e), k.empty(n, e)
        out = torch.empty_like(x)
        if x.dtype == torch.bfloat16:
            wgmma.gemm(k, xn, w.w1, g, n, e, d, "act", bias=w.b1, aux=dg, act=ACTIVATIONS[act])
            wgmma.gemm(k, g, w.w2, out, n, d, e, "res", bias=w.b2, res=x)
        else:
            splits, k_per_split = split_k_plan(n, e, d, 1, x.dtype, k.sms)
            work = k.empty(splits * n * e, dtype=torch.float32) if splits > 1 else None
            build.check(k.lib.ffvc_mlp_gemm(
                xn.data_ptr(), d, w.w1.data_ptr(), d, g.data_ptr(), e, w.b1.data_ptr(),
                ACTIVATIONS[act], dg.data_ptr(), n, e, d, splits, k_per_split, _ptr(work),
                k.code, k.stream), "ffvc_mlp_gemm")
            k.gemm(g, e, 0, w.w2, e, 0, out, d, 0, n, d, e, 1, b_kmajor=1, res=x, ldr=d,
                   bias=w.b2, bias_mode=2)
    mlp_ln.launches += 1
    return out, g, dg


def mlp_ln_bwd(dy, x, g, dg, w: MlpLnWeights, params=True):
    """The sublayer backward: dy (rows, D) float32, the forward's input x and its
    saved g, dg -> MlpLnGrads; the six parameter grads only with `params`.

    A CUDA tensor launches the kernels; a CPU tensor runs the plain version."""
    if dy.device.type == "cpu":
        return mlp_ln_bwd_plain(dy, x, g, dg, w, params)
    n, d = x.shape
    e = w.w1.shape[0]
    dt, dev = x.dtype, x.device
    _check(x, w)
    _check_like("dy", dy, (n, d), torch.float32, dev)
    _check_like("g", g, (n, e), dt, dev)
    _check_like("dg", dg, (n, e), dt, dev)
    x = x.contiguous()
    k = _Launcher(dev, dt)
    with torch.cuda.device(dev):
        dyd = dy.to(dt)
        # da = (dy W2) * act', rounded; its f32 value feeds db1
        da = k.empty(n, e)
        daf = k.empty(n, e, dtype=torch.float32) if params else None
        dxn = k.empty(n, d, dtype=torch.float32)
        if dt == torch.bfloat16:  # W2 (D, E) as (K=D, N=E) and W1 (E, D) as (K=E, N=D)
            wgmma.gemm(k, dyd, w.w2, da, n, e, d, "mul", b_mn_major=True, mul=dg, aux=daf)
            wgmma.gemm(k, da, w.w1, dxn, n, d, e, "f32", b_mn_major=True)
        else:
            k.gemm(dyd, d, 0, w.w2, e, 0, da, e, 0, n, e, d, 1, mul=dg, out_f32=daf)
            k.gemm(da, e, 0, w.w1, d, 0, dxn, d, 0, n, d, e, 1, c_f32=1)
        # dx = dy + LN'(dxn), the statistics recomputed from x; prod = dxn * xhat
        dx, prod = torch.empty_like(dxn), torch.empty_like(dxn)
        k.ln_bwd(dxn, x, None, w.ln_w, dy, dx, prod, n, d)
        if params:
            # dW1 = da^T xn (xn recomputed as the forward made it) and dW2 = dy^T g:
            # the rows are the GEMMs' K
            xn = torch.empty_like(x)
            k.ln(x, w.ln_w, w.ln_b, xn, n, d, centered=1)
            dw1 = k.empty(e, d, dtype=torch.float32)
            k.gemm(da, e, 0, xn, d, 0, dw1, d, 0, e, d, n, 1, a_mmajor=1, c_f32=1)
            dw2 = k.empty(d, e, dtype=torch.float32)
            k.gemm(dyd, d, 0, g, e, 0, dw2, e, 0, d, e, n, 1, a_mmajor=1, c_f32=1)
            grads = MlpLnGrads(dx=dx, ln_w=k.col_sum(prod, n, d), ln_b=k.col_sum(dxn, n, d),
                               w1=dw1, b1=k.col_sum(daf, n, e), w2=dw2,
                               b2=k.col_sum(dy, n, d))
        else:
            grads = MlpLnGrads(dx)
    mlp_ln_bwd.launches += 1
    return grads


mlp_ln.launches = 0
mlp_ln_bwd.launches = 0


class MlpLn(torch.autograd.Function):
    """Differentiable sublayer (the `fused_mlp_ln` custom_vjp): forward `mlp_ln`,
    backward `mlp_ln_bwd`. Takes the sublayer's six float32 parameters in
    MlpLnWeights order and casts the matrices to `dtype` inside the forward, so
    grads reach the parameters in float32; they are computed only where autograd
    asks for them:

        out = MlpLn.apply(x, act, dtype, ln_w, ln_b, w1, b1, w2, b2)
    """

    @staticmethod
    def forward(ctx, x, act, dtype, *params):
        w = MlpLnWeights(*(
            p.detach().to(dtype).contiguous() if name in MATRICES
            else p.detach().float().contiguous()
            for name, p in zip(MlpLnWeights._fields, params)
        ))
        xc = x.detach().to(dtype).contiguous()
        out, g, dg = mlp_ln(xc, w, act)
        ctx.x_dtype = x.dtype
        ctx.save_for_backward(xc, g, dg, *w)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, g, dg, *wl = ctx.saved_tensors
        params = any(ctx.needs_input_grad[3:])
        grads = mlp_ln_bwd(dout.float().contiguous(), x, g, dg, MlpLnWeights(*wl), params)
        return (grads.dx.to(ctx.x_dtype), None, None, *grads[1:])

"""One MLP-Mixer block on the card, inference and train: the CUDA kernels in
csrc/mixer_block.cu and csrc/mixer_train.cu.

Replaces, in feed_forward_vqgan_clip_tpu/ops/pallas/mixer_block.py:

  * `mixer_block`: `_block_kernel` (`fused_mixer_block` ->
    `_fused_mixer_block_impl`) and `_pipe_kernel` (the same function on a skewed
    TPU schedule at B >= 16);
  * `mixer_block_fwd_res`: `_block_res_kernel` and `_block_res_pipe_kernel`
    (`_fwd_res` / `_fwd_res_pipe`), the forward that also saves the residuals;
  * `mixer_channel_bwd`: `_channel_bwd_kernel` and `_channel_bwd_pipe_kernel`;
  * `mixer_token_bwd`: `_token_bwd_kernel`;
  * `mixer_block_stacked`: `_block_kernel_stacked` (`fused_mixer_block_stacked`),
    one block read through views into the stacked layout of `stack_mixer_params`
    (the whole-depth kernel over that layout is ops/kernels/mixer_stream.py);

and `MixerBlockTrain` is the counterpart of the `fused_mixer_block_train`
custom_vjp that joins the train kernels. Per batch element x (T, D), following
`_block_math`:

    xn = LN(x)                                  f32 statistics, eps 1e-5
    g1 = gelu(t1 xn + t1b)                      (Et, D), per-hidden-token bias
    r  = x + (t2 g1 + t2b)                      (T, D), per-token bias
    y  = r + (gelu(LN(r) W1^T + b1) W2^T + b2)  channel FF over D -> Ec -> D

In the stacked layout LN2's affine is folded into the first channel matmul
(W1f = W1 diag(s2), b1f = b1 + W1 b2ln, as the JAX package folds it), so the
channel LayerNorm there is LN-hat, (r - mean) * inv without an affine.

The block launches LayerNorm-rows kernels and GEMMs with fused bias /
exact-GELU (and gelu') / multiply / residual epilogues: the token GEMMs batched
over B with the weights shared (batch stride 0), the channel GEMMs with the batch
folded into M = B*T rows. `mixer_gemm_route` picks each GEMM's tile: in bf16 the
Hopper GEMM of csrc/wgmma_gemm.cuh (ops/kernels/wgmma.py: TMA, wgmma, persistent
tiles) wherever TMA can read the operands, else the WMMA tile of
csrc/mixer_tile.cuh, where `split_k_plan` cuts K across blocks while its output
tiles would leave SMs idle; in float32 the FMA tile. The forward's four GEMMs
(K2, K5, K6), the channel backward's four (K7) and the token backward's four
(K8) take the route. Parameter gradients are sums over the batch taken in a
fixed order, never with atomics: the channel weight grads fold B*T into K (one
wgmma chain in K order), the token weight grads add the batch's products in
batch order (`batch_sum`: f32 partials and an ordered sum on the wgmma route, a
sum of partial tiles on the WMMA and FMA tiles), the bias and norm grads go
through a two-pass column sum. The TPU-only parts of the Pallas kernels
(polynomial erf and gelu', pair and diagnostic knobs, VMEM gates) have no
counterpart: gelu and gelu' use `erff` / `expf`.

Every wrapper launches its kernels for a CUDA tensor, runs its plain PyTorch
version (the `*_plain` function beside it) only for a CPU tensor, and counts its
launches on `.launches`; those of the forward and the backward also count the
wgmma GEMMs their calls launched on `.wgmma_launches`, and the inference forward's
(K2, K5) those of them that took the ping-pong walk (`wgmma.wgmma_plan`) on
`.pingpong_launches`.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from feed_forward_vqgan_clip_tpu_torch.ops.kernels import build, wgmma
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.wgmma import ACTIVATIONS, gelu_grad

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh DType
# (BM, BN, BK) of gemm_f32_kernel / gemm_bf16_kernel in csrc/mixer_block.cu
_TILES = {torch.float32: (64, 64, 16), torch.bfloat16: (128, 128, 32)}
_MAX_SPLITS = 16
_COL_SUM_ROWS_PER_CHUNK = 32


def split_k_plan(m, n, k, batch, dtype, sms):
    """(splits, k_per_split): cut K into ranges while the output tiles alone fill
    fewer blocks than the card has SMs, keeping at least 4 K-tiles per range."""
    bm, bn, bk = _TILES[dtype]
    blocks = -(-m // bm) * -(-n // bn) * batch
    splits = 1
    while splits < _MAX_SPLITS and blocks * splits < sms and k >= 8 * bk * splits:
        splits *= 2
    k_per_split = -(-k // (splits * bk)) * bk
    return -(-k // k_per_split), k_per_split


# The bf16 GEMMs of the block's chains and the row lengths (elements) TMA reads and
# writes at (t, d, et, ec): A's, B's and C's. The forward (K2, K5, K6): g1 = act(t1 .
# xn + t1b[row]) and r = x + (t2 . g1 + t2b[row]) batched over B with the weight
# shared, xn and g1 read MN-major; g3 = act(rn W1^T + b1) and out = r + (g3 W2^T + b2)
# with the batch folded into rows, W1 and W2 read K-major. The channel backward (K7):
# da3 = (dout W2) * gelu'(a3) and drn = da3 W1 with the weights read MN-major, dW2 =
# dout^T g3 and dW1 = da3^T rn with an M-major A. The token backward (K8), batched
# with the weight shared: da1 = (t2^T dr) * gelu'(a1) and dxn = t1^T da1 with the
# weight read M-major and the activation MN-major; the weight grads dt2 = sum_b dr
# g1^T and dt1 = sum_b da1 xn^T with both operands K-major, summed over the batch.
MIXER_GEMMS = {
    "g1": lambda t, d, et, ec: (t, d, d),
    "r": lambda t, d, et, ec: (et, d, d),
    "g3": lambda t, d, et, ec: (d, d, ec),
    "out": lambda t, d, et, ec: (ec, ec, d),
    "da3": lambda t, d, et, ec: (d, ec, ec),
    "drn": lambda t, d, et, ec: (ec, d, d),
    "dw2": lambda t, d, et, ec: (d, ec, ec),
    "dw1": lambda t, d, et, ec: (ec, d, d),
    "da1": lambda t, d, et, ec: (et, d, d),
    "dxn": lambda t, d, et, ec: (t, d, d),
    "dt2": lambda t, d, et, ec: (d, d, et),
    "dt1": lambda t, d, et, ec: (d, d, t),
}


def mixer_gemm_route(name, t, d, et, ec, dtype, tensors=()):
    """The tile GEMM `name` of MIXER_GEMMS takes: "fma" in float32 (the
    FMA tile of csrc/mixer_tile.cuh), "wgmma" in bf16 where TMA can read and write
    its operands (`wgmma.tma_ok` on the row lengths and the `tensors`' bases: the
    Hopper GEMM of csrc/wgmma_gemm.cuh), else "wmma" (the WMMA tile, with split-K
    where its tiles are few). A function of dtype, shape and alignment only.

    The batch size takes no part: on an H100 (chip_smoke.py `[time] Mixer GEMM`,
    PERF.md) the wgmma GEMM without split-K beat the WMMA tile with it at every
    flagship GEMM and batch measured, B = 1, 4, 8 and 16, the batched token GEMMs
    and the 16-tile ones at B=1 (out: 0.026 against 0.073 ms) included."""
    if dtype == torch.float32:
        return "fma"
    if not wgmma.tma_ok(MIXER_GEMMS[name](t, d, et, ec), tensors):
        return "wmma"
    return "wgmma"


def mixer_gemm_routes(t, d, et, ec, dtype):
    """{GEMM name: its route} for aligned operands at one shape."""
    return {name: mixer_gemm_route(name, t, d, et, ec, dtype) for name in MIXER_GEMMS}


class MixerBlockWeights(NamedTuple):
    """One block's parameters as the kernels take them: matrices in the working
    dtype, in torch's layouts (Conv1d (out, in), Linear (out, in)); norms and
    biases float32. Built by models.mappers.mixer.MixerBlock.kernel_weights."""

    ln1_w: torch.Tensor  # (D,)
    ln1_b: torch.Tensor  # (D,)
    t1: torch.Tensor     # (Et, T)
    t1b: torch.Tensor    # (Et,)
    t2: torch.Tensor     # (T, Et)
    t2b: torch.Tensor    # (T,)
    ln2_w: torch.Tensor  # (D,)
    ln2_b: torch.Tensor  # (D,)
    w1: torch.Tensor     # (Ec, D)
    b1: torch.Tensor     # (Ec,)
    w2: torch.Tensor     # (D, Ec)
    b2: torch.Tensor     # (D,)


MATRICES = ("t1", "t2", "w1", "w2")


class StackedMixerWeights(NamedTuple):
    """All L blocks' parameters stacked along a leading depth axis, with LN2's
    affine folded into the first channel matmul: the port of
    `stack_mixer_params`' output, in MixerBlockWeights' layouts. Matrices in the
    working dtype; norms and biases float32."""

    ln1_w: torch.Tensor  # (L, D)
    ln1_b: torch.Tensor  # (L, D)
    t1: torch.Tensor     # (L, Et, T)
    t1b: torch.Tensor    # (L, Et)
    t2: torch.Tensor     # (L, T, Et)
    t2b: torch.Tensor    # (L, T)
    w1f: torch.Tensor    # (L, Ec, D)  W1 * s2 (per input feature), rounded once
    b1f: torch.Tensor    # (L, Ec)     b1 + W1 b2ln, float32
    w2: torch.Tensor     # (L, D, Ec)
    b2: torch.Tensor     # (L, D)


STACKED_MATRICES = ("t1", "t2", "w1f", "w2")


@torch.no_grad()
def stack_mixer_params(blocks, dtype):
    """One MixerBlockWeights per block (read in float32) -> StackedMixerWeights,
    the port of `stack_mixer_params`: the channel LayerNorm's affine folded as
    the JAX package folds it, w1f = (W1_f32 * s2).to(dtype) and b1f = b1 + W1 b2ln
    in float32. Built once per loaded model."""
    cols = {name: [] for name in StackedMixerWeights._fields}
    for w in blocks:
        w1 = w.w1.float()
        cols["ln1_w"].append(w.ln1_w.float())
        cols["ln1_b"].append(w.ln1_b.float())
        cols["t1"].append(w.t1.to(dtype))
        cols["t1b"].append(w.t1b.float())
        cols["t2"].append(w.t2.to(dtype))
        cols["t2b"].append(w.t2b.float())
        cols["w1f"].append((w1 * w.ln2_w.float()).to(dtype))
        cols["b1f"].append(w.b1.float() + w1 @ w.ln2_b.float())
        cols["w2"].append(w.w2.to(dtype))
        cols["b2"].append(w.b2.float())
    return StackedMixerWeights(*(torch.stack(cols[n]) for n in StackedMixerWeights._fields))


def stacked_block_weights(sp: StackedMixerWeights, block_idx: int) -> MixerBlockWeights:
    """Block `block_idx` of the stacked layout as views (no copy), in
    MixerBlockWeights' fields: w1/b1 hold the folded w1f/b1f and ln2_w/ln2_b are
    None (LN-hat)."""
    v = {name: getattr(sp, name)[block_idx] for name in StackedMixerWeights._fields}
    return MixerBlockWeights(
        ln1_w=v["ln1_w"], ln1_b=v["ln1_b"], t1=v["t1"], t1b=v["t1b"], t2=v["t2"],
        t2b=v["t2b"], ln2_w=None, ln2_b=None, w1=v["w1f"], b1=v["b1f"], w2=v["w2"], b2=v["b2"],
    )


class MixerResiduals(NamedTuple):
    """What the train forward saves for the backward (`_block_res_kernel`'s
    outputs besides the block output), per batch element."""

    g1: torch.Tensor    # (B, Et, D) gelu(a1), working dtype
    dg1: torch.Tensor   # (B, Et, D) gelu'(a1)
    rhat: torch.Tensor  # (B, T, D)  LN2-normalised r, working dtype
    inv2: torch.Tensor  # (B, T, 1)  LN2 inverse std, float32
    g3: torch.Tensor    # (B, T, Ec) gelu(a3)
    dg3: torch.Tensor   # (B, T, Ec) gelu'(a3)


class ChannelGrads(NamedTuple):
    """`_channel_bwd_kernel`'s outputs: dr and the channel half's parameter
    grads summed over the batch, float32, in MixerBlockWeights' layouts."""

    dr: torch.Tensor     # (B, T, D)
    ln2_w: torch.Tensor  # (D,)
    ln2_b: torch.Tensor  # (D,)
    w1: torch.Tensor     # (Ec, D)
    b1: torch.Tensor     # (Ec,)
    w2: torch.Tensor     # (D, Ec)
    b2: torch.Tensor     # (D,)


class TokenGrads(NamedTuple):
    """`_token_bwd_kernel`'s outputs: dx and the token half's parameter grads
    summed over the batch, float32."""

    dx: torch.Tensor     # (B, T, D)
    ln1_w: torch.Tensor  # (D,)
    ln1_b: torch.Tensor  # (D,)
    t1: torch.Tensor     # (Et, T)
    t1b: torch.Tensor    # (Et,)
    t2: torch.Tensor     # (T, Et)
    t2b: torch.Tensor    # (T,)


# ---------------------------------------------------------------- plain versions


def _ln_rhat(x):
    """(rhat, inv) in f32, the forward's rounding order rf*inv - mean*inv."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    inv = torch.rsqrt(var.clamp_min(0.0) + 1e-5)
    return xf * inv - mean * inv, inv


def _ln_stats(x):
    """(xhat, inv) in f32, the backward's rounding order (x - mean)*inv (`_ln_stats`)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    inv = torch.rsqrt(var.clamp_min(0.0) + 1e-5)
    return (xf - mean) * inv, inv


def _layer_norm_plain(x, weight, bias):
    return (_ln_rhat(x)[0] * weight + bias).to(x.dtype)


def _ln_bwd_plain(dy, xhat, inv, scale):
    """LayerNorm input gradient (`_ln_bwd`), all f32."""
    g = dy * scale
    m1 = g.mean(-1, keepdim=True)
    m2 = (g * xhat).mean(-1, keepdim=True)
    return inv * ((g - m1) - xhat * m2)


def mixer_block_plain(x, w: MixerBlockWeights):
    """The block in plain PyTorch ops, for x (B, T, D) float32 or bfloat16."""
    dt = x.dtype
    xn = _layer_norm_plain(x, w.ln1_w, w.ln1_b)
    g1 = F.gelu(torch.matmul(w.t1, xn).float() + w.t1b[:, None]).to(dt)
    r = x + (torch.matmul(w.t2, g1).float() + w.t2b[:, None]).to(dt)
    rn = _layer_norm_plain(r, w.ln2_w, w.ln2_b)
    g3 = F.gelu(F.linear(rn, w.w1).float() + w.b1).to(dt)
    return r + (F.linear(g3, w.w2).float() + w.b2).to(dt)


def mixer_block_fwd_res_plain(x, w: MixerBlockWeights):
    """`_block_res_kernel` in plain PyTorch: (out, MixerResiduals). Products in
    float32 (exact for bf16 operands), rounded where the kernel rounds."""
    dt = x.dtype
    f = lambda t: t.float()  # noqa: E731
    xn = _layer_norm_plain(x, w.ln1_w, w.ln1_b)
    a1 = torch.matmul(f(w.t1), f(xn)) + w.t1b[:, None]
    g1, dg1 = F.gelu(a1).to(dt), gelu_grad(a1).to(dt)
    r = x + (torch.matmul(f(w.t2), f(g1)) + w.t2b[:, None]).to(dt)
    rhat, inv2 = _ln_rhat(r)
    rn = (rhat * w.ln2_w + w.ln2_b).to(dt)
    a3 = torch.matmul(f(rn), f(w.w1).T) + w.b1
    g3, dg3 = F.gelu(a3).to(dt), gelu_grad(a3).to(dt)
    out = r + (torch.matmul(f(g3), f(w.w2).T) + w.b2).to(dt)
    return out, MixerResiduals(g1, dg1, rhat.to(dt), inv2, g3, dg3)


def mixer_channel_bwd_plain(dout, res: MixerResiduals, w: MixerBlockWeights):
    """`_channel_bwd_kernel` in plain PyTorch: dout (B, T, D) float32 -> ChannelGrads."""
    dt = res.g3.dtype
    d, ec = dout.shape[-1], res.g3.shape[-1]
    doutd = dout.to(dt).float()
    da3f = torch.matmul(doutd, w.w2.float()) * res.dg3.float()   # dg3 * gelu'
    da3 = da3f.to(dt).float()
    rhat = res.rhat.float()
    rn = (rhat * w.ln2_w + w.ln2_b).to(dt).float()
    drn = torch.matmul(da3, w.w1.float())
    dr = dout + _ln_bwd_plain(drn, rhat, res.inv2, w.ln2_w)
    return ChannelGrads(
        dr=dr,
        ln2_w=(drn * rhat).sum((0, 1)), ln2_b=drn.sum((0, 1)),
        w1=da3.reshape(-1, ec).T @ rn.reshape(-1, d), b1=da3f.sum((0, 1)),
        w2=doutd.reshape(-1, d).T @ res.g3.float().reshape(-1, ec), b2=dout.sum((0, 1)),
    )


def mixer_token_bwd_plain(dr, x, g1, dg1, w: MixerBlockWeights):
    """`_token_bwd_kernel` in plain PyTorch: dr (B, T, D) float32, x and the saved
    g1, gelu'(a1) -> TokenGrads. LN1's statistics are recomputed from x."""
    dt = g1.dtype
    drd = dr.to(dt).float()
    xhat, inv1 = _ln_stats(x)
    xn = (xhat * w.ln1_w + w.ln1_b).to(dt).float()
    da1f = torch.matmul(w.t2.float().T, drd) * dg1.float()     # dg1 * gelu'
    da1 = da1f.to(dt).float()
    dxn = torch.matmul(w.t1.float().T, da1)
    dx = dr + _ln_bwd_plain(dxn, xhat, inv1, w.ln1_w)
    return TokenGrads(
        dx=dx,
        ln1_w=(dxn * xhat).sum((0, 1)), ln1_b=dxn.sum((0, 1)),
        t1=torch.einsum("bed,btd->et", da1, xn), t1b=da1f.sum((0, 2)),
        t2=torch.einsum("btd,bed->te", drd, g1.float()), t2b=dr.sum((0, 2)),
    )


def mixer_block_stacked_plain(x, sp: StackedMixerWeights, block_idx: int):
    """`_block_math` for block `block_idx` of the stacked layout in plain PyTorch:
    LN1 with its affine, the token FF, LN-hat in the backward's order (x - mean)
    * inv (`_kernel_ln_hat`), the folded channel FF. Products in float32 (exact
    for bf16 operands), each kept through bias and GELU and rounded once, where
    the kernel rounds."""
    w = stacked_block_weights(sp, block_idx)
    dt = x.dtype
    f = lambda t: t.float()  # noqa: E731
    xn = _layer_norm_plain(x, w.ln1_w, w.ln1_b)
    g1 = F.gelu(torch.matmul(f(w.t1), f(xn)) + w.t1b[:, None]).to(dt)
    r = x + (torch.matmul(f(w.t2), f(g1)) + w.t2b[:, None]).to(dt)
    rhat = _ln_stats(r)[0].to(dt)
    g3 = F.gelu(torch.matmul(f(rhat), f(w.w1).T) + w.b1).to(dt)
    return r + (torch.matmul(f(g3), f(w.w2).T) + w.b2).to(dt)


# ---------------------------------------------------------------- kernels


def _check(x, w):
    if x.device.type != "cuda":
        raise ValueError(f"mixer block kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"mixer block kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, D), got {tuple(x.shape)}")
    _, t, d = x.shape
    et, ec = w.t1.shape[0], w.w1.shape[0]
    shapes = {
        "ln1_w": (d,), "ln1_b": (d,), "t1": (et, t), "t1b": (et,), "t2": (t, et),
        "t2b": (t,), "ln2_w": (d,), "ln2_b": (d,), "w1": (ec, d), "b1": (ec,),
        "w2": (d, ec), "b2": (d,),
    }
    for name, shape in shapes.items():
        v = getattr(w, name)
        if v is None and name in ("ln2_w", "ln2_b"):  # LN-hat: the stacked layout
            continue
        want = x.dtype if name in MATRICES else torch.float32
        if tuple(v.shape) != shape or v.dtype != want or v.device != x.device:
            raise ValueError(
                f"weight {name}: {tuple(v.shape)} {v.dtype} on {v.device}, "
                f"need {shape} {want} on {x.device}"
            )
        if not v.is_contiguous():
            raise ValueError(f"weight {name} must be contiguous")


def _check_like(name, v, shape, dtype, device):
    if tuple(v.shape) != tuple(shape) or v.dtype != dtype or v.device != device:
        raise ValueError(f"{name}: {tuple(v.shape)} {v.dtype} on {v.device}, "
                         f"need {tuple(shape)} {dtype} on {device}")
    if not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return t.data_ptr() if t is not None else None


class _Launcher:
    """The C entry points of csrc/mixer_*.cu on one device, stream and working dtype;
    `pingpong` pins the wgmma GEMMs' schedule (`wgmma.gemm`), None leaves it to the plan."""

    def __init__(self, device, dtype, pingpong=None):
        self.lib = build.load_library()
        self.pingpong = pingpong
        self.device, self.dtype = device, dtype
        self.code = _DTYPE_CODE[dtype]
        self.stream = build.stream_handle(device)
        self.sms = torch.cuda.get_device_properties(device).multi_processor_count
        self.wgmma_launches = 0
        self.pingpong_launches = 0

    def empty(self, *shape, dtype=None):
        return torch.empty(*shape, dtype=dtype or self.dtype, device=self.device)

    def ln(self, src, scale, bias, out, rows, d, *, rhat=None, inv=None, centered=0):
        """LayerNorm rows; rhat, inv, centered or no affine (scale None: LN-hat)
        take the train kernel."""
        if rhat is None and inv is None and not centered and scale is not None:
            err = self.lib.ffvc_ln_rows(src.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                        out.data_ptr(), rows, d, self.code, self.stream)
        else:
            err = self.lib.ffvc_ln_rows_train(
                src.data_ptr(), _ptr(scale), _ptr(bias), out.data_ptr(), _ptr(rhat),
                _ptr(inv), rows, d, centered, self.code, self.stream)
        build.check(err, "ffvc_ln_rows")

    def gemm(self, a, lda, sa, b, ldb, sb, c, ldc, sc, m, n, k, batch, *, a_mmajor=0,
             b_kmajor=0, c_f32=0, res=None, ldr=0, sr=0, bias=None, bias_mode=0, gelu=0,
             gelu_grad=None, mul=None, out_f32=None, batch_sum=0):
        """One GEMM with its epilogue; any train option (an M-major A, gelu', mul,
        an f32 copy or output, a batch sum) takes the train kernel."""
        splits, k_per_split = split_k_plan(m, n, k, batch, self.dtype, self.sms)
        work = None
        if splits > 1 or batch_sum:
            work = self.empty(batch * splits * m * n, dtype=torch.float32)
        if not (a_mmajor or c_f32 or batch_sum or gelu_grad is not None or mul is not None
                or out_f32 is not None):
            err = self.lib.ffvc_gemm(
                a.data_ptr(), lda, sa, b.data_ptr(), ldb, sb, b_kmajor, c.data_ptr(), ldc, sc,
                _ptr(res), ldr, sr, _ptr(bias), bias_mode, gelu, m, n, k, batch, splits,
                k_per_split, _ptr(work), self.code, self.stream,
            )
        else:
            err = self.lib.ffvc_gemm_train(
                a.data_ptr(), lda, sa, a_mmajor, b.data_ptr(), ldb, sb, b_kmajor, c.data_ptr(),
                ldc, sc, c_f32, _ptr(res), ldr, sr, _ptr(bias), bias_mode, gelu,
                _ptr(gelu_grad), _ptr(mul), _ptr(out_f32), m, n, k, batch, batch_sum, splits,
                k_per_split, _ptr(work), self.code, self.stream,
            )
        build.check(err, "ffvc_gemm")

    def mm(self, route, a, b, c, m, n, kdim, epi, *, a_m_major=False, b_mn_major=False,
           batch=1, sa=0, sb=0, sc=0, bias=None, bias_rows=False, res=None, mul=None,
           aux=None, batch_sum=False):
        """One GEMM of the block in `wgmma.gemm`'s terms (exact GELU; `batch_sum`:
        one f32 C, the batch's products added in batch order), on the tile `route`
        names: the wgmma GEMM, or the WMMA / FMA tile through `gemm`."""
        if route == "wgmma":
            self.pingpong_launches += wgmma.gemm(
                self, a, b, c, m, n, kdim, epi, a_m_major=a_m_major, b_mn_major=b_mn_major,
                batch=batch, sa=sa, sb=sb, sc=sc, bias=bias, bias_rows=bias_rows, res=res,
                mul=mul, aux=aux, act=ACTIVATIONS["gelu"], batch_sum=batch_sum,
                pingpong=self.pingpong)
            self.wgmma_launches += 1
            return
        self.gemm(a, m if a_m_major else kdim, sa, b, n if b_mn_major else kdim, sb, c, n,
                  0 if batch_sum else sc, m, n, kdim, batch, a_mmajor=int(a_m_major),
                  b_kmajor=int(not b_mn_major), c_f32=int(epi == "f32"), res=res, ldr=n, sr=sc,
                  bias=bias, bias_mode=0 if bias is None else 1 if bias_rows else 2,
                  gelu=int(epi in ("act", "act_only")),
                  gelu_grad=aux if epi == "act" else None, mul=mul,
                  out_f32=aux if epi == "mul" else None, batch_sum=int(batch_sum))

    def affine(self, x, scale, bias, out, d):
        err = self.lib.ffvc_affine_rows(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                        out.data_ptr(), x.numel(), d, self.code, self.stream)
        build.check(err, "ffvc_affine_rows")

    def ln_bwd(self, dy, xsrc, inv_saved, scale, res, out, prod, rows, d):
        err = self.lib.ffvc_ln_bwd_rows(dy.data_ptr(), xsrc.data_ptr(), _ptr(inv_saved),
                                        scale.data_ptr(), res.data_ptr(), out.data_ptr(),
                                        prod.data_ptr(), rows, d, self.code, self.stream)
        build.check(err, "ffvc_ln_bwd_rows")

    def col_sum(self, a, rows, cols):
        """(cols,) f32: the column sums of a (rows, cols) f32 matrix, fixed order."""
        out = self.empty(cols, dtype=torch.float32)
        chunk = _COL_SUM_ROWS_PER_CHUNK
        partial = self.empty(-(-rows // chunk) * cols, dtype=torch.float32)
        err = self.lib.ffvc_col_sum(a.data_ptr(), out.data_ptr(), partial.data_ptr(), rows,
                                    cols, chunk, self.stream)
        build.check(err, "ffvc_col_sum")
        return out

    def row_sum(self, a, rows, d):
        out = self.empty(rows, dtype=torch.float32)
        err = self.lib.ffvc_row_sum(a.data_ptr(), out.data_ptr(), rows, d, self.stream)
        build.check(err, "ffvc_row_sum")
        return out


def _block_forward(x, w, save, pingpong=None):
    """The block's launches; with `save`, the train forward's residuals too;
    `pingpong` as `_Launcher`'s (the tests and chip_smoke.py time and compare the two
    schedules, which give the same bits). -> (out, residuals or None, the launcher,
    which counts the wgmma GEMMs launched)."""
    _check(x, w)
    x = x.contiguous()
    b, t, d = x.shape
    et, ec = w.t1.shape[0], w.w1.shape[0]
    k = _Launcher(x.device, x.dtype, pingpong)

    def route(name, *tensors):
        return mixer_gemm_route(name, t, d, et, ec, x.dtype, tensors)

    act = "act" if save else "act_only"
    with torch.cuda.device(x.device):
        xn = torch.empty_like(x)
        k.ln(x, w.ln1_w, w.ln1_b, xn, b * t, d)
        # token mixing, batched over B; weights shared (batch stride 0)
        g1 = k.empty(b, et, d)
        dg1 = k.empty(b, et, d) if save else None
        k.mm(route("g1", w.t1, xn, g1, dg1), w.t1, xn, g1, et, d, t, act, b_mn_major=True,
             batch=b, sb=t * d, sc=et * d, bias=w.t1b, bias_rows=True, aux=dg1)
        r = torch.empty_like(x)
        k.mm(route("r", w.t2, g1, r, x), w.t2, g1, r, t, d, et, "res", b_mn_major=True,
             batch=b, sb=et * d, sc=t * d, bias=w.t2b, bias_rows=True, res=x)
        # channel mixing, batch folded into M = B*T rows; xn's buffer is reused.
        # The stacked layout's LN-hat (no affine) takes the centered order.
        rhat = torch.empty_like(x) if save else None
        inv2 = k.empty(b, t, 1, dtype=torch.float32) if save else None
        k.ln(r, w.ln2_w, w.ln2_b, xn, b * t, d, rhat=rhat, inv=inv2,
             centered=int(w.ln2_w is None))
        g3 = k.empty(b, t, ec)
        dg3 = k.empty(b, t, ec) if save else None
        k.mm(route("g3", xn, w.w1, g3, dg3), xn, w.w1, g3, b * t, ec, d, act, bias=w.b1,
             aux=dg3)
        out = torch.empty_like(x)
        k.mm(route("out", g3, w.w2, out, r), g3, w.w2, out, b * t, d, ec, "res", bias=w.b2,
             res=r)
    res = MixerResiduals(g1, dg1, rhat, inv2, g3, dg3) if save else None
    return out, res, k


def _count(wrapper, k):
    """One launch of the inference block and the wgmma GEMMs (of them ping-pong) it ran."""
    wrapper.launches += 1
    wrapper.wgmma_launches += k.wgmma_launches
    wrapper.pingpong_launches += k.pingpong_launches


def mixer_block(x, w: MixerBlockWeights):
    """One Mixer block, x (B, T, D) -> (B, T, D) in x's dtype.

    A CUDA tensor launches the kernels; a CPU tensor runs the plain version."""
    if x.device.type == "cpu":
        return mixer_block_plain(x, w)
    out, _, k = _block_forward(x, w, save=False)
    _count(mixer_block, k)
    return out


def mixer_block_stacked(x, sp: StackedMixerWeights, block_idx: int):
    """Block `block_idx` of the stacked layout (K5), x (B, T, D) -> (B, T, D) in
    x's dtype: K2's launches on views into the stacked tensors (no copy, no
    per-call fold), LN2 as LN-hat.

    A CUDA tensor launches the kernels; a CPU tensor runs the plain version."""
    if x.device.type == "cpu":
        return mixer_block_stacked_plain(x, sp, block_idx)
    if not 0 <= block_idx < sp.t1.shape[0]:
        raise IndexError(f"block_idx {block_idx} outside the stack's {sp.t1.shape[0]} blocks")
    out, _, k = _block_forward(x, stacked_block_weights(sp, block_idx), save=False)
    _count(mixer_block_stacked, k)
    return out


def mixer_block_fwd_res(x, w: MixerBlockWeights):
    """The train forward: (out, MixerResiduals). `out` is the same launches'
    value as `mixer_block`'s, bit for bit.

    A CUDA tensor launches the kernels; a CPU tensor runs the plain version."""
    if x.device.type == "cpu":
        return mixer_block_fwd_res_plain(x, w)
    out, res, k = _block_forward(x, w, save=True)
    mixer_block_fwd_res.launches += 1
    mixer_block_fwd_res.wgmma_launches += k.wgmma_launches
    return out, res


def mixer_channel_bwd(dout, res: MixerResiduals, w: MixerBlockWeights):
    """The channel half's backward: dout (B, T, D) float32 -> ChannelGrads.

    A CUDA tensor launches the kernels; a CPU tensor runs the plain version."""
    if dout.device.type == "cpu":
        return mixer_channel_bwd_plain(dout, res, w)
    b, t, d = dout.shape
    dt, dev = res.g3.dtype, dout.device
    ec = w.w1.shape[0]
    _check(res.rhat, w)
    _check_like("dout", dout, (b, t, d), torch.float32, dev)
    for name, shape in (("rhat", (b, t, d)), ("g3", (b, t, ec)), ("dg3", (b, t, ec))):
        _check_like(name, getattr(res, name), shape, dt, dev)
    _check_like("inv2", res.inv2, (b, t, 1), torch.float32, dev)
    bt = b * t
    k = _Launcher(dev, dt)

    def route(name, *tensors):
        return mixer_gemm_route(name, t, d, w.t1.shape[0], ec, dt, tensors)

    with torch.cuda.device(dev):
        doutd = dout.to(dt)
        # da3 = (dout W2) * gelu'(a3), rounded; its f32 value feeds db1
        da3, da3f = k.empty(bt, ec), k.empty(bt, ec, dtype=torch.float32)
        k.mm(route("da3", doutd, w.w2, da3, res.dg3, da3f), doutd, w.w2, da3, bt, ec, d, "mul",
             b_mn_major=True, mul=res.dg3, aux=da3f)
        # dW2 = dout^T g3 and dW1 = da3^T rn: the batch folded into K = B*T
        dw2 = k.empty(d, ec, dtype=torch.float32)
        k.mm(route("dw2", doutd, res.g3, dw2), doutd, res.g3, dw2, d, ec, bt, "f32",
             a_m_major=True, b_mn_major=True)
        rn = k.empty(bt, d)
        k.affine(res.rhat, w.ln2_w, w.ln2_b, rn, d)
        dw1 = k.empty(ec, d, dtype=torch.float32)
        k.mm(route("dw1", da3, rn, dw1), da3, rn, dw1, ec, d, bt, "f32", a_m_major=True,
             b_mn_major=True)
        # drn = da3 W1, then LN2's backward from the saved rhat and inverse std
        drn = k.empty(b, t, d, dtype=torch.float32)
        k.mm(route("drn", da3, w.w1, drn), da3, w.w1, drn, bt, d, ec, "f32", b_mn_major=True)
        dr, prod = torch.empty_like(drn), torch.empty_like(drn)
        k.ln_bwd(drn, res.rhat, res.inv2, w.ln2_w, dout, dr, prod, bt, d)
        grads = ChannelGrads(
            dr=dr, ln2_w=k.col_sum(prod, bt, d), ln2_b=k.col_sum(drn, bt, d),
            w1=dw1, b1=k.col_sum(da3f, bt, ec), w2=dw2, b2=k.col_sum(dout, bt, d),
        )
    mixer_channel_bwd.launches += 1
    mixer_channel_bwd.wgmma_launches += k.wgmma_launches
    return grads


def mixer_token_bwd(dr, x, g1, dg1, w: MixerBlockWeights):
    """The token half's backward: dr (B, T, D) float32, the block input x and the
    saved g1, gelu'(a1) -> TokenGrads.

    A CUDA tensor launches the kernels; a CPU tensor runs the plain version."""
    if dr.device.type == "cpu":
        return mixer_token_bwd_plain(dr, x, g1, dg1, w)
    _check(x, w)
    b, t, d = x.shape
    dt, dev = x.dtype, x.device
    et = w.t1.shape[0]
    _check_like("dr", dr, (b, t, d), torch.float32, dev)
    _check_like("g1", g1, (b, et, d), dt, dev)
    _check_like("dg1", dg1, (b, et, d), dt, dev)
    x = x.contiguous()
    k = _Launcher(dev, dt)

    def route(name, *tensors):
        return mixer_gemm_route(name, t, d, et, w.w1.shape[0], dt, tensors)

    with torch.cuda.device(dev):
        drd = dr.to(dt)
        # da1 = (t2^T dr) * gelu'(a1), batched; its f32 value feeds dt1b
        da1, da1f = k.empty(b, et, d), k.empty(b, et, d, dtype=torch.float32)
        k.mm(route("da1", w.t2, drd, da1, dg1, da1f), w.t2, drd, da1, et, d, t, "mul",
             a_m_major=True, b_mn_major=True, batch=b, sb=t * d, sc=et * d, mul=dg1, aux=da1f)
        # dt2 = sum_b dr g1^T, dt1 = sum_b da1 xn^T: batch products added in order
        dt2 = k.empty(t, et, dtype=torch.float32)
        k.mm(route("dt2", drd, g1, dt2), drd, g1, dt2, t, et, d, "f32", batch=b, sa=t * d,
             sb=et * d, batch_sum=True)
        xn = torch.empty_like(x)
        k.ln(x, w.ln1_w, w.ln1_b, xn, b * t, d, centered=1)
        dt1 = k.empty(et, t, dtype=torch.float32)
        k.mm(route("dt1", da1, xn, dt1), da1, xn, dt1, et, t, d, "f32", batch=b, sa=et * d,
             sb=t * d, batch_sum=True)
        # dxn = t1^T da1, then LN1's backward with its statistics recomputed from x
        dxn = k.empty(b, t, d, dtype=torch.float32)
        k.mm(route("dxn", w.t1, da1, dxn), w.t1, da1, dxn, t, d, et, "f32", a_m_major=True,
             b_mn_major=True, batch=b, sb=et * d, sc=t * d)
        dx, prod = torch.empty_like(dxn), torch.empty_like(dxn)
        k.ln_bwd(dxn, x, None, w.ln1_w, dr, dx, prod, b * t, d)
        grads = TokenGrads(
            dx=dx, ln1_w=k.col_sum(prod, b * t, d), ln1_b=k.col_sum(dxn, b * t, d),
            t1=dt1, t1b=k.col_sum(k.row_sum(da1f, b * et, d), b, et),
            t2=dt2, t2b=k.col_sum(k.row_sum(dr, b * t, d), b, t),
        )
    mixer_token_bwd.launches += 1
    mixer_token_bwd.wgmma_launches += k.wgmma_launches
    return grads


mixer_block.launches = 0
mixer_block_stacked.launches = 0
mixer_block_fwd_res.launches = 0
mixer_channel_bwd.launches = 0
mixer_token_bwd.launches = 0
# the wgmma GEMMs launched inside the calls (mixer_gemm_route)
mixer_block.wgmma_launches = 0
mixer_block_stacked.wgmma_launches = 0
mixer_block_fwd_res.wgmma_launches = 0
mixer_channel_bwd.wgmma_launches = 0
mixer_token_bwd.wgmma_launches = 0
# of those, the inference forward's GEMMs that took the ping-pong walk (wgmma.wgmma_plan)
mixer_block.pingpong_launches = 0
mixer_block_stacked.pingpong_launches = 0


class MixerBlockTrain(torch.autograd.Function):
    """Differentiable Mixer block: forward `mixer_block_fwd_res`, backward
    `mixer_channel_bwd` then `mixer_token_bwd` (the `fused_mixer_block_train`
    custom_vjp). Takes the block's twelve float32 master parameters in
    MixerBlockWeights order and layouts and casts the matrices to `dtype` inside
    the forward, so the float32 grads reach the masters unrounded, as the JAX
    vjp's `_like` casts do:

        out = MixerBlockTrain.apply(x, dtype, *weights)
    """

    @staticmethod
    def forward(ctx, x, dtype, *params):
        w = MixerBlockWeights(*(
            p.detach().to(dtype).contiguous() if name in MATRICES
            else p.detach().float().contiguous()
            for name, p in zip(MixerBlockWeights._fields, params)
        ))
        xc = x.detach().to(dtype).contiguous()
        out, res = mixer_block_fwd_res(xc, w)
        ctx.x_dtype = x.dtype
        ctx.save_for_backward(xc, *res, *w)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, g1, dg1, rhat, inv2, g3, dg3, *wl = ctx.saved_tensors
        w = MixerBlockWeights(*wl)
        ch = mixer_channel_bwd(dout.float().contiguous(),
                               MixerResiduals(g1, dg1, rhat, inv2, g3, dg3), w)
        tok = mixer_token_bwd(ch.dr, x, g1, dg1, w)
        grads = MixerBlockWeights(
            ln1_w=tok.ln1_w, ln1_b=tok.ln1_b, t1=tok.t1, t1b=tok.t1b, t2=tok.t2, t2b=tok.t2b,
            ln2_w=ch.ln2_w, ln2_b=ch.ln2_b, w1=ch.w1, b1=ch.b1, w2=ch.w2, b2=ch.b2,
        )
        return (tok.dx.to(ctx.x_dtype), None, *grads)

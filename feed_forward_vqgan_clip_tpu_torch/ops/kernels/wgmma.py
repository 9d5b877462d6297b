"""The Hopper GEMM of csrc/wgmma_gemm.cuh (TMA, wgmma, persistent tiles) from
Python: its tile planner, the TMA-eligibility predicate, the launch through the
entry point `ffvc_wgmma_gemm` (csrc/wgmma_gemm.cu), and `gemm_reference`, the
plain version of its contract. K11 (ops/kernels/mlp_ln.py) and the Mixer block
kernels (ops/kernels/mixer_block.py: K2, K5, K6, K7, K8) launch their bf16 GEMMs
through `gemm`; the Mixer stack (K4, ops/kernels/mixer_stream.py) runs the same
tile walk inside its own persistent kernel.

The contract, for z < batch (a batch stride of 0: the operand is shared, as the
Mixer's token weights are):

    C[z] (M x N) = A[z] (M x K) . B[z]     f32 accumulation, one K chain in order
    A K-major (M, K) or M-major (K, M);  B K-major (N, K) or MN-major (K, N)

then the epilogue on v, with an f32 bias per column (N,) where B is K-major or
per row (M,) where B is MN-major (the token GEMMs), as the kernel is compiled:

    act       v += bias; aux = round(act'(v)); C = round(act(v))
    act_only  v += bias; C = round(act(v))
    res       v += bias; C = round(round(v) + res)
    mul       v *= mul; aux (f32, where given) = v; C = round(v)
    f32       C = v, float32

act: exact GELU or quick_gelu (ACTIVATIONS). Rounding is to the working type,
bf16; the tile takes bf16 operands only (the float32 routes keep their FMA tile).

The batch-sum form (`batch_sum`, f32 only; K8's token weight grads) gives one C,
the sum over z of the batch's products: each product lands as an f32 partial
(batch, M, N) and csrc/mixer_train.cu `ffvc_batch_sum` adds them in batch order,
z = 0, 1, ..., one thread per output, so every run gives the same bits.
"""

import torch
import torch.nn.functional as F

from feed_forward_vqgan_clip_tpu_torch.ops.kernels import build

# csrc/wgmma_gemm.cuh: output rows of a tile, the tile widths compiled, the epilogues
WGMMA_ROWS = 128
WGMMA_WIDTHS = (128, 192)
EPILOGUES = {"act": 0, "res": 1, "mul": 2, "f32": 3, "act_only": 4}  # WgmmaEpilogue
ACTIVATIONS = {"gelu": 0, "quick_gelu": 1}  # csrc/common.cuh Activation
_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def wgmma_plan(m: int, n: int, sms: int, batch: int = 1):
    """(tile width, persistent CTAs) of the wgmma GEMM for `batch` (m, n) outputs
    on `sms` SMs: the width of WGMMA_WIDTHS whose tiles take the least time in
    whole waves, waves x width (a tile's time grows with its width), the narrower
    on a tie. At the train loss's 3200 rows: N = 3072 takes 128 (600 tiles, 5
    waves on 132 SMs: 5 x 128 against 4 x 192), N = 768 takes 192 (100 tiles, one
    wave: 1 x 192 against 2 x 128)."""
    best = None
    for bn in WGMMA_WIDTHS:
        tiles = wgmma_tiles(m, n, bn, batch)
        cost = -(-tiles // sms) * bn
        if best is None or cost < best[0]:
            best = (cost, bn, min(tiles, sms))
    return best[1], best[2]


def wgmma_tiles(m: int, n: int, bn: int, batch: int = 1) -> int:
    """Output tiles of the persistent walk: row blocks x column blocks x batch."""
    return -(-m // WGMMA_ROWS) * -(-n // bn) * batch


def tma_ok(row_lengths, tensors=()) -> bool:
    """Whether TMA can read and write the GEMM's operands: every operand's row
    length in elements (K or M for A, K or N for B, N for C; a batch stride is a
    whole number of rows) a multiple of 8, i.e. 16-byte row strides, and every
    base 16-byte aligned (a view into a stacked weight too)."""
    return (all(n % 8 == 0 for n in row_lengths)
            and all(t.data_ptr() % 16 == 0 for t in tensors if t is not None))


def _ptr(t):
    return t.data_ptr() if t is not None else None


def gemm(k, a, b, c, m, n, kdim, epi, *, a_m_major=False, b_mn_major=False, batch=1, sa=0,
         sb=0, sc=0, bias=None, bias_rows=False, res=None, mul=None, aux=None, act=0, bn=None,
         batch_sum=False):
    """One bf16 GEMM of csrc/wgmma_gemm.cuh on launcher `k` (its `lib`, `sms` and
    `stream`): c = a . b with epilogue `epi` of EPILOGUES, as the module docstring
    states; sa, sb, sc batch strides in elements. With `batch_sum` (epi "f32"),
    c (M, N) is the sum over the batch of the products, added in batch order
    from an f32 partial per element (sc is then unused). The tile width is
    `wgmma_plan`'s, or `bn` of WGMMA_WIDTHS where given. Raises where an operand
    is not 16-byte aligned or the launch fails: there is no other route from
    here."""
    for t in (a, b, c, res, mul, aux):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the wgmma GEMM's operands need 16-byte-aligned bases (TMA)")
    if batch_sum and epi != "f32":
        raise ValueError(f"the batch-sum form takes the f32 epilogue, not {epi!r}")
    out = c
    if batch_sum:
        c, sc = torch.empty(batch, m, n, dtype=torch.float32, device=out.device), m * n
    planned, grid = wgmma_plan(m, n, k.sms, batch)
    if bn is not None and bn != planned:
        grid = min(wgmma_tiles(m, n, bn, batch), k.sms)
    build.check(k.lib.ffvc_wgmma_gemm(
        a.data_ptr(), sa, int(a_m_major), b.data_ptr(), sb, int(b_mn_major), c.data_ptr(), sc,
        m, n, kdim, batch, EPILOGUES[epi], _ptr(bias), int(bias_rows), _ptr(res), _ptr(mul),
        _ptr(aux), act, bn or planned, grid, k.stream), "ffvc_wgmma_gemm")
    if batch_sum:
        build.check(k.lib.ffvc_batch_sum(c.data_ptr(), out.data_ptr(), batch, m * n, k.stream),
                    "ffvc_batch_sum")


# ---------------------------------------------------------------- plain versions


def gelu_grad(v):
    """d/dv gelu(v) = Phi(v) + v phi(v), exact erf and exp."""
    return 0.5 * (1.0 + torch.erf(v * _SQRT_HALF)) + v * torch.exp(-0.5 * v * v) * _INV_SQRT_2PI


def act_val_grad(h, act):
    """(act(h), act'(h)) in f32: quick_gelu's s = sigmoid(1.702 h), h s and
    s + 1.702 h s (1 - s) (`_quick_gelu_val_grad`), or exact gelu and its derivative."""
    if act == "quick_gelu":
        s = torch.sigmoid(1.702 * h)
        val = h * s
        return val, s + 1.702 * val * (1.0 - s)
    return F.gelu(h), gelu_grad(h)


def gemm_reference(a, b, epi, *, a_m_major=False, b_mn_major=False, bias=None, bias_rows=False,
                   res=None, mul=None, act="gelu", batch_sum=False):
    """The GEMM contract in plain PyTorch: a (M, K), or (K, M) where a_m_major, and
    b (N, K), or (K, N) where b_mn_major, each with an optional leading batch
    dimension (an operand without one is shared by the batch) -> (C, aux): aux
    act' for "act", the f32 v for "mul", else None. Products in float32 (exact for
    bf16 operands), rounded to a's dtype where the kernel rounds. `batch_sum`
    ("f32"): C (M, N) = the batch's products added in batch order."""
    if epi not in EPILOGUES:
        raise ValueError(f"epilogue {epi!r}: the kernel has {sorted(EPILOGUES)}")
    if batch_sum and epi != "f32":
        raise ValueError(f"the batch-sum form takes the f32 epilogue, not {epi!r}")
    dt = a.dtype
    af = a.float().transpose(-1, -2) if a_m_major else a.float()
    bf = b.float() if b_mn_major else b.float().transpose(-1, -2)
    v = torch.matmul(af, bf)
    if batch_sum:
        if v.dim() != 3:
            raise ValueError("the batch-sum form needs a batched operand")
        total = v[0].clone()
        for z in range(1, v.shape[0]):
            total += v[z]
        return total, None
    if bias is not None and epi in ("act", "act_only", "res"):
        v = v + (bias[:, None] if bias_rows else bias)
    if epi in ("act", "act_only"):
        val, grad = act_val_grad(v, act)
        return val.to(dt), (grad.to(dt) if epi == "act" else None)
    if epi == "res":
        return (v.to(dt).float() + res.float()).to(dt), None
    if epi == "mul":
        v = v * mul.float()
        return v.to(dt), v
    return v, None  # f32

"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. The file imports no
JAX, so it also runs where JAX is not installed; tests/conftest.py does import
JAX, so there run it without the conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider

Tolerances: VQ indices equal except at near-ties (plain top-2 score gap below
the fp32 bound 4*C*eps*(|x| max|c| + max|c|^2)), at least 99.9% agreement;
K4 and K2 at the 512-px OpenCLIP Mixer's widths (T = 1024, D = 1024, one
block) f32 within 1e-3 of max |plain|, bf16 within C4's one-block gate (1.5e-2
of max |plain| by max abs, 1e-2 by ||err|| / ||plain||); the flagship's K4 on
its pinned plan bit for bit;
the Mixer block, the Mixer train kernels (every output and parameter grad),
the whole-stack kernel (K4) and the stacked-layout block (K5) f32 (TF32 off)
within 1e-3 and bf16 within 3e-2 of max |plain|; the warp
kernels f32 within 1e-4 and bf16 within 3e-2 of max |plain| (the same taps and
weights, sums in another order, one bf16 rounding), at equal and at different
input and output frames; the tiny slice, f32, within 1e-3 of the CPU module
path. The wgmma GEMM alone (ops/kernels/wgmma.py) against `gemm_reference`:
float32 outputs within 1e-5 of max |reference| (the same bf16 products summed
in another order), bf16 outputs within 8e-3 (a rounding or two of the largest
value); the GELU epilogue without its derivative equal to the one with it, bit
for bit; the ping-pong walk equal to the cooperative one bit for bit, and K2 at
B=256 on it within the Mixer's bf16 ceiling. The pools' backward, the tiny
trainer's steps and the plain-PyTorch backwards of Et, Ts and R (no kernel of
their own: a sorted fixed-order segment sum and weight-matrix products) must
repeat bit for bit. The dot-product test of
K9 and K10 in float32: |<K9 x, g> - <x, K10 g>| within 1e-5 of sum |terms|.
The VitGAN and x-transformer mappers (module path) and the CLIP RN50 perceptor
(cuDNN convolutions) on the card, float32, within 1e-4 and 1e-3 of max |CPU|.
The flow prior's reverse (float32 matrix products, TF32 off) within
1e-4 of max(1, max |CPU|); the VGG16 features float32 within 1e-3 and bf16
within 2e-2 of max |CPU| per slice; a tiny Predictor's prior=True request
(K4 and K1 on the card) within 2/255 of the CPU's PNG, and unlike prior=False.
The crowsonkb CLOOB ViT and a sniffed OpenCLIP ViT (an fp16 file with a
`module.` prefix), float32, within 1e-4 of max(1, max |CPU|); a JAX checkpoint
directory served byte for byte like its `.th`; the webdataset encoder's
features within 1e-4 of the CPU's; the native BPE core built. Upsample (the
transposed conv) against the reference graph NN-2x + 3x3 conv on its weights
(output, input and weight gradients), float32 within 1e-4 and bf16 within 5e-2
of max |reference|; `cli bench` at a tiny model prints the JAX bench's lines and launches K1, K2,
K4 and K6-K10 in its legs. The GroupNorm + SiLU kernel pair (csrc/group_norm.cu)
against its plain form at the decoder's shapes: float32 within 1e-5 of max
|plain|; bf16 no further from the float32 plain result than the bf16 plain form
is, plus one bf16 ulp of max |plain| (the kernel rounds once where the plain
form rounds three times); two launches bitwise equal, and each image of a batch
bitwise equal to itself alone; the same with a per-channel pre-bias, against
the plain form of x + pre_bias. The residual add (csrc/residual.cu) equal to
its plain form bit for bit, both layouts and dtypes, ragged and misaligned
contiguous operands element by element; operands it does not read, or a graph
for autograd to record, raise. The f16-16384 decoder on the card (its norms on the
kernel, its conv biases handed on to the norms and the residual adds) against
the CPU's on the same weights: float32 within 1e-3, bf16 within 5e-2
(tests/test_torch_vqgan.py's bf16 tolerance) of max |CPU|; and against the
card's own decode with every bias left to the library, float32 within 1e-4,
bf16 within 5e-2.
"""

import copy
import gzip

import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu_torch.entry import example_tokens
from feed_forward_vqgan_clip_tpu_torch.infer import Generator, build_generator
from feed_forward_vqgan_clip_tpu_torch.io.checkpoint import save_model
from feed_forward_vqgan_clip_tpu_torch.io.images import decode_png
from feed_forward_vqgan_clip_tpu_torch.models import flow
from feed_forward_vqgan_clip_tpu_torch.models.vgg import VGG16Features
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import (
    Decoder,
    GroupNorm32,
    Upsample,
    latent_bounds,
    make_vqgan,
)
from feed_forward_vqgan_clip_tpu_torch.models.clip_fused import encode_image_fused
from feed_forward_vqgan_clip_tpu_torch.models.clip_resnet import CLIPResNet
from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip_from_config
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
from feed_forward_vqgan_clip_tpu_torch.models.mappers.fused import (
    make_mapper_apply,
    make_mapper_train_apply,
)
from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import Mixer
from feed_forward_vqgan_clip_tpu_torch.config import make_config
from feed_forward_vqgan_clip_tpu_torch.ops import augment, pooling
from feed_forward_vqgan_clip_tpu_torch.ops.kernels import mixer_stream as mixer_stream_module
from feed_forward_vqgan_clip_tpu_torch.ops.kernels import wgmma
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.group_norm import (
    gn_plan,
    group_norm_silu,
    group_norm_silu_plain,
)
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
    ChannelGrads,
    MixerBlockWeights,
    MixerResiduals,
    TokenGrads,
    _block_forward,
    _Launcher,
    mixer_block,
    mixer_block_fwd_res,
    mixer_block_fwd_res_plain,
    mixer_block_plain,
    mixer_block_stacked,
    mixer_block_stacked_plain,
    mixer_channel_bwd,
    mixer_channel_bwd_plain,
    mixer_token_bwd,
    mixer_token_bwd_plain,
    mixer_gemm_routes,
    stack_mixer_params,
)
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_stream import (
    StreamPlan,
    mixer_stream,
    mixer_stream_plain,
    stream_plan,
    stream_route,
)
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.residual import (
    residual_add,
    residual_add_plain,
)
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mlp_ln import (
    MlpLnGrads,
    MlpLnWeights,
    mlp_ln,
    mlp_ln_bwd,
    mlp_ln_bwd_plain,
    mlp_ln_plain,
)
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.vq_lookup import (
    nearest_codebook_indices_kernel,
    nearest_codebook_indices_plain,
    split_pieces,
    vq_plan,
)
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_adjoint import (
    warp_adjoint,
    warp_adjoint_plain,
)
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_forward import (
    warp_forward,
    warp_forward_plain,
)
from feed_forward_vqgan_clip_tpu_torch.registry import CLIP_RESNET_CONFIGS, CLIP_VIT_CONFIGS
from feed_forward_vqgan_clip_tpu_torch.serve.predictor import Predictor
from feed_forward_vqgan_clip_tpu_torch.tokenizer import bpe
from feed_forward_vqgan_clip_tpu_torch.train import loop

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,k,c", [(1000, 16384, 256), (77, 1000, 256), (4096, 16384, 256),
                                   (256, 16384, 256), (2048, 16384, 256), (300, 2048, 70)])
def test_vq_kernel_matches_plain(cuda, n, k, c):
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    x = torch.randn(n, c, generator=gen, device=cuda)
    cb = torch.randn(k, c, generator=gen, device=cuda)
    before = nearest_codebook_indices_kernel.launches
    got = nearest_codebook_indices_kernel(x, cb)
    assert nearest_codebook_indices_kernel.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n,)
    ref = nearest_codebook_indices_plain(x, cb)
    scores = cb.square().sum(-1)[None] - 2 * x @ cb.T
    top2 = scores.topk(2, dim=1, largest=False).values
    bound = 4 * c * torch.finfo(torch.float32).eps * (
        x.norm(dim=1) * cb.norm(dim=1).max() + cb.square().sum(-1).max())
    diff = got != ref
    assert diff.float().mean().item() <= 1e-3
    assert not (diff & (top2[:, 1] - top2[:, 0] >= bound)).any().item()


@pytest.mark.parametrize("n,c", [(256, 256), (1000, 70)])
def test_vq_kernel_repeats_bitwise(cuda, n, c):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, c, generator=gen, device=cuda)
    cb = torch.randn(16384, c, generator=gen, device=cuda)
    assert torch.equal(nearest_codebook_indices_kernel(x, cb),
                       nearest_codebook_indices_kernel(x, cb))


def test_vq_split_kernel_matches_plain_split(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(77, 70, generator=gen, device=cuda) * 1e3
    cb = torch.randn(1000, 70, generator=gen, device=cuda) * 1e-3
    x[0, :4] = torch.tensor([0.0, 1.5, -3.0e38, 3.4e38])  # bf16-exact, and a carry to inf
    channels = vq_plan(77, 1000, 70, 132).channels
    for got, ref in zip(split_pieces(x, cb, channels), split_pieces(x.cpu(), cb.cpu(), channels)):
        assert torch.equal(got.cpu(), ref)


def test_vq_kernel_ties_keep_lowest_index(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    half = torch.randn(700, 256, generator=gen, device=cuda)
    cb = torch.cat([half, half, half])  # 3 copies: the first must win
    x = torch.randn(300, 256, generator=gen, device=cuda)
    got = nearest_codebook_indices_kernel(x, cb)
    assert int(got.max()) < 700
    assert torch.equal(got, nearest_codebook_indices_plain(x, cb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,d", [(3, 7, 40), (2, 16, 128)])
def test_mixer_block_kernel_matches_plain(cuda, dtype, b, s, d):
    rng = np.random.default_rng(0)
    mapper = Mixer(8, s, 8, d, 1, dtype=dtype)
    for p in mapper.parameters():
        p.data = torch.from_numpy(
            rng.normal(size=p.shape).astype(np.float32) / np.sqrt(p[0].numel() if p.dim() > 1 else 10))
    w = mapper.to(cuda).blocks[0].kernel_weights(dtype)
    x = torch.from_numpy(rng.normal(size=(b, s * s, d)).astype(np.float32)).to(cuda, dtype)
    before = mixer_block.launches
    got = mixer_block(x, w)
    assert mixer_block.launches == before + 1
    ref = mixer_block_plain(x, w)
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    err = (got.float() - ref.float()).abs().max().item()
    assert got.dtype == dtype and err <= tol * ref.float().abs().max().item()


def _rel(got, ref):
    return (got.float() - ref.float()).abs().max().item() / max(ref.float().abs().max().item(),
                                                               1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,d", [(3, 8, 96), (2, 7, 100), (2, 16, 128)])
def test_mixer_train_kernels_match_plain(cuda, dtype, b, s, d):
    """K6 (forward with residuals), K7 (channel backward) and K8 (token backward)
    against their plain versions on the same inputs; K6's output equals K2's bit
    for bit; two backward runs give bitwise-equal grads."""
    rng = np.random.default_rng(1)
    mapper = Mixer(8, s, 8, d, 1, dtype=dtype)
    for p in mapper.parameters():
        scale = np.sqrt(p[0].numel() if p.dim() > 1 else 10)
        p.data = torch.from_numpy(rng.normal(size=p.shape).astype(np.float32) / scale)
    w = mapper.to(cuda).blocks[0].kernel_weights(dtype)
    x = torch.from_numpy(rng.normal(size=(b, s * s, d)).astype(np.float32)).to(cuda, dtype)
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    counts = (mixer_block_fwd_res.launches, mixer_channel_bwd.launches, mixer_token_bwd.launches)
    wg = (mixer_block_fwd_res.wgmma_launches, mixer_channel_bwd.wgmma_launches,
          mixer_token_bwd.wgmma_launches)
    out, res = mixer_block_fwd_res(x, w)
    assert torch.equal(out, mixer_block(x, w))
    ref_out, ref_res = mixer_block_fwd_res_plain(x, w)
    assert _rel(out, ref_out) <= tol
    for name in MixerResiduals._fields:
        assert _rel(getattr(res, name), getattr(ref_res, name)) <= tol, name
    dout = torch.from_numpy(rng.normal(size=(b, s * s, d)).astype(np.float32)).to(cuda)
    ch = mixer_channel_bwd(dout, res, w)
    ch_ref = mixer_channel_bwd_plain(dout, res, w)
    for name in ChannelGrads._fields:
        assert _rel(getattr(ch, name), getattr(ch_ref, name)) <= tol, name
    tok = mixer_token_bwd(ch.dr, x, res.g1, res.dg1, w)
    tok_ref = mixer_token_bwd_plain(ch.dr, x, res.g1, res.dg1, w)
    for name in TokenGrads._fields:
        assert _rel(getattr(tok, name), getattr(tok_ref, name)) <= tol, name
    again = mixer_token_bwd(mixer_channel_bwd(dout, res, w).dr, x, res.g1, res.dg1, w)
    for name in TokenGrads._fields:
        assert torch.equal(getattr(tok, name), getattr(again, name)), name
    assert (mixer_block_fwd_res.launches, mixer_channel_bwd.launches,
            mixer_token_bwd.launches) == (counts[0] + 1, counts[1] + 2, counts[2] + 2)
    # each GEMM on the tile its route names: the forward's four, K7's four and K8's
    # four (twice each)
    routes = mixer_gemm_routes(s * s, d, w.t1.shape[0], w.w1.shape[0], dtype)
    on_wgmma = [routes[n] == "wgmma" for n in ("g1", "r", "g3", "out", "da3", "drn", "dw2",
                                               "dw1", "da1", "dxn", "dt2", "dt1")]
    assert (mixer_block_fwd_res.wgmma_launches - wg[0],
            mixer_channel_bwd.wgmma_launches - wg[1],
            mixer_token_bwd.wgmma_launches - wg[2]) == (
        sum(on_wgmma[:4]), 2 * sum(on_wgmma[4:8]), 2 * sum(on_wgmma[8:]))


def _token_case(b, t, d, et, seed):
    """(dr, x, g1, dg1, weights) of the token backward at (B, T, D, Et), Ec = 2 D,
    bf16, random at lecun scales."""
    rng = np.random.default_rng(seed)
    ec = 2 * d

    def n(*shape, std=1.0, dt=torch.float32):
        return torch.from_numpy((rng.normal(size=shape) * std).astype(np.float32)).to("cuda", dt)

    bf = torch.bfloat16
    w = MixerBlockWeights(
        ln1_w=1 + n(d, std=0.1), ln1_b=n(d, std=0.1), t1=n(et, t, std=t ** -0.5, dt=bf),
        t1b=n(et, std=0.1), t2=n(t, et, std=et ** -0.5, dt=bf), t2b=n(t, std=0.1),
        ln2_w=1 + n(d, std=0.1), ln2_b=n(d, std=0.1), w1=n(ec, d, std=d ** -0.5, dt=bf),
        b1=n(ec, std=0.1), w2=n(d, ec, std=ec ** -0.5, dt=bf), b2=n(d, std=0.1))
    return n(b, t, d), n(b, t, d, dt=bf), n(b, et, d, dt=bf), n(b, et, d, std=0.5, dt=bf), w


@pytest.mark.parametrize("b,t,d,et", [(8, 256, 1024, 1024), (3, 64, 128, 104)],
                         ids=["flagship", "et104"])
def test_mixer_token_bwd_on_wgmma_matches_plain(cuda, b, t, d, et):
    """K8's four GEMMs on the wgmma GEMM (the flagship, and Et = 104: a shared
    M-major A ragged against the 128-row tile in a batched launch, and dt2's N),
    bf16, every output within 3e-2 of the plain version, and two runs bitwise
    equal (the batch sums in a fixed order)."""
    dr, x, g1, dg1, w = _token_case(b, t, d, et, et)
    routes = mixer_gemm_routes(t, d, et, 2 * d, torch.bfloat16)
    assert [routes[n] for n in ("da1", "dxn", "dt2", "dt1")] == ["wgmma"] * 4
    before = mixer_token_bwd.wgmma_launches
    tok = mixer_token_bwd(dr, x, g1, dg1, w)
    assert mixer_token_bwd.wgmma_launches == before + 4
    ref = mixer_token_bwd_plain(dr, x, g1, dg1, w)
    for name in TokenGrads._fields:
        assert _rel(getattr(tok, name), getattr(ref, name)) <= 3e-2, name
    again = mixer_token_bwd(dr, x, g1, dg1, w)
    for name in TokenGrads._fields:
        assert torch.equal(getattr(tok, name), getattr(again, name)), name


def _bf16(rng, *shape, std=1.0):
    return torch.from_numpy((rng.normal(size=shape) * std).astype(np.float32)).to(
        "cuda", torch.bfloat16)


@pytest.mark.parametrize("bn", wgmma.WGMMA_WIDTHS)
@pytest.mark.parametrize("m", [56, 104, 304])
def test_wgmma_transposed_a_matches_reference(cuda, m, bn):
    """The weight grads' GEMM (A M-major, B MN-major, f32 out; K7's dW2 and dW1)
    at ragged M (56: the second consumer's box wholly outside, 104, 304), N = 136
    and K = 200 (ragged against 128 / 192 and 64) against `gemm_reference`, the
    same bits on a second run."""
    rng = np.random.default_rng(m + bn)
    n, kk = 136, 200
    a, b = _bf16(rng, kk, m), _bf16(rng, kk, n)
    k = _Launcher(cuda, torch.bfloat16)
    c, again = (torch.empty(m, n, device=cuda) for _ in range(2))
    for out in (c, again):
        wgmma.gemm(k, a, b, out, m, n, kk, "f32", a_m_major=True, b_mn_major=True, bn=bn)
    ref, _ = wgmma.gemm_reference(a, b, "f32", a_m_major=True, b_mn_major=True)
    assert _rel(c, ref) <= 1e-5 and torch.equal(c, again)


@pytest.mark.parametrize("bn", wgmma.WGMMA_WIDTHS)
@pytest.mark.parametrize("epi", ["act", "act_only", "res"])
def test_wgmma_batched_row_bias_matches_reference(cuda, epi, bn):
    """The token GEMMs' form: a weight shared by the batch (stride 0), a batched
    MN-major B, a per-row bias (far from symmetric), B = 3, M = 200, N = 136, K = 72
    (all ragged against the tiles); GELU with its derivative (K6), without it (K2:
    the same output bits) and the residual epilogue, against `gemm_reference`."""
    rng = np.random.default_rng(3 + bn)
    batch, m, n, kk = 3, 200, 136, 72
    a, b = _bf16(rng, m, kk, std=kk ** -0.5), _bf16(rng, batch, kk, n)
    bias = torch.linspace(-2, 1, m, device=cuda)
    res = _bf16(rng, batch, m, n)
    k = _Launcher(cuda, torch.bfloat16)
    c, aux = (torch.empty(batch, m, n, dtype=torch.bfloat16, device=cuda) for _ in range(2))
    kw = dict(b_mn_major=True, batch=batch, sb=kk * n, sc=m * n, bias=bias, bias_rows=True)
    wgmma.gemm(k, a, b, c, m, n, kk, epi, res=res if epi == "res" else None,
               aux=aux if epi == "act" else None, bn=bn, **kw)
    ref, ref_aux = wgmma.gemm_reference(a, b, epi, res=res, **{
        key: v for key, v in kw.items() if key in ("b_mn_major", "bias", "bias_rows")})
    assert _rel(c, ref) <= 8e-3
    if epi == "act":
        assert _rel(aux, ref_aux) <= 8e-3
        only = torch.empty_like(c)
        wgmma.gemm(k, a, b, only, m, n, kk, "act_only", bn=bn, **kw)
        assert torch.equal(only, c)


@pytest.mark.parametrize("bn", wgmma.WGMMA_WIDTHS)
def test_wgmma_column_epilogues_at_ragged_edges(cuda, bn):
    """The channel GEMMs' forms at M = 100, N = 200: K-major B with GELU (and
    without its derivative) and the residual; MN-major B with the mul epilogue
    and its f32 copy (da3) and the f32 output (drn)."""
    rng = np.random.default_rng(bn)
    m, n, kk = 100, 200, 96
    a = _bf16(rng, m, kk, std=kk ** -0.5)
    wk, wn = _bf16(rng, n, kk), _bf16(rng, kk, n)
    bias = torch.linspace(-1, 1, n, device=cuda)
    res, mul = _bf16(rng, m, n), _bf16(rng, m, n)
    k = _Launcher(cuda, torch.bfloat16)
    new = lambda dt=torch.bfloat16: torch.empty(m, n, dtype=dt, device=cuda)  # noqa: E731
    c, aux, only, out = new(), new(), new(), new()
    wgmma.gemm(k, a, wk, c, m, n, kk, "act", bias=bias, aux=aux, bn=bn)
    wgmma.gemm(k, a, wk, only, m, n, kk, "act_only", bias=bias, bn=bn)
    wgmma.gemm(k, a, wk, out, m, n, kk, "res", bias=bias, res=res, bn=bn)
    ref, ref_aux = wgmma.gemm_reference(a, wk, "act", bias=bias)
    assert _rel(c, ref) <= 8e-3 and _rel(aux, ref_aux) <= 8e-3 and torch.equal(only, c)
    assert _rel(out, wgmma.gemm_reference(a, wk, "res", bias=bias, res=res)[0]) <= 8e-3
    prod, vf, f32 = new(), new(torch.float32), new(torch.float32)
    wgmma.gemm(k, a, wn, prod, m, n, kk, "mul", b_mn_major=True, mul=mul, aux=vf, bn=bn)
    wgmma.gemm(k, a, wn, f32, m, n, kk, "f32", b_mn_major=True, bn=bn)
    ref, ref_vf = wgmma.gemm_reference(a, wn, "mul", b_mn_major=True, mul=mul)
    assert _rel(prod, ref) <= 8e-3 and _rel(vf, ref_vf) <= 1e-5
    assert _rel(f32, wgmma.gemm_reference(a, wn, "f32", b_mn_major=True)[0]) <= 1e-5


@pytest.mark.parametrize("bn", wgmma.WGMMA_WIDTHS)
@pytest.mark.parametrize("m", [56, 104])
def test_wgmma_shared_m_major_a_batched_matches_reference(cuda, m, bn):
    """K8's da1 and dxn form: A M-major and shared by the batch (stride 0), B
    MN-major and batched, B = 3, ragged M (56, 104), N = 136, K = 72; the mul
    epilogue with its f32 copy, and the f32 output, against `gemm_reference`."""
    rng = np.random.default_rng(5 * m + bn)
    batch, n, kk = 3, 136, 72
    a, b = _bf16(rng, kk, m), _bf16(rng, batch, kk, n)
    mul = _bf16(rng, batch, m, n)
    k = _Launcher(cuda, torch.bfloat16)
    prod = torch.empty(batch, m, n, dtype=torch.bfloat16, device=cuda)
    vf, f32 = (torch.empty(batch, m, n, device=cuda) for _ in range(2))
    kw = dict(a_m_major=True, b_mn_major=True, batch=batch, sb=kk * n, sc=m * n, bn=bn)
    wgmma.gemm(k, a, b, prod, m, n, kk, "mul", mul=mul, aux=vf, **kw)
    wgmma.gemm(k, a, b, f32, m, n, kk, "f32", **kw)
    ref, ref_vf = wgmma.gemm_reference(a, b, "mul", a_m_major=True, b_mn_major=True, mul=mul)
    assert _rel(prod, ref) <= 8e-3 and _rel(vf, ref_vf) <= 1e-5
    assert _rel(f32, wgmma.gemm_reference(a, b, "f32", a_m_major=True, b_mn_major=True)[0]) <= 1e-5


@pytest.mark.parametrize("bn", wgmma.WGMMA_WIDTHS)
def test_wgmma_batch_sum_matches_reference(cuda, bn):
    """K8's weight grads' form: both operands K-major and batched, B = 5, M = 200,
    N = 104, K = 72, one f32 C summed over the batch in order, against
    `gemm_reference(batch_sum=True)`; the same bits on a second run."""
    rng = np.random.default_rng(11 + bn)
    batch, m, n, kk = 5, 200, 104, 72
    a, b = _bf16(rng, batch, m, kk), _bf16(rng, batch, n, kk)
    k = _Launcher(cuda, torch.bfloat16)
    c, again = (torch.empty(m, n, device=cuda) for _ in range(2))
    for out in (c, again):
        wgmma.gemm(k, a, b, out, m, n, kk, "f32", batch=batch, sa=m * kk, sb=n * kk,
                   batch_sum=True, bn=bn)
    ref, _ = wgmma.gemm_reference(a, b, "f32", batch_sum=True)
    assert _rel(c, ref) <= 1e-5 and torch.equal(c, again)


@pytest.mark.parametrize("kdim", [64, 4096], ids=["k_one_stage", "k_4096"])
@pytest.mark.parametrize("layout", ["column_bias", "row_bias"])
@pytest.mark.parametrize("epi", ["act_only", "act_only_quick_gelu"])
def test_wgmma_pingpong_equals_cooperative_bitwise(cuda, epi, layout, kdim):
    """The ping-pong walk against the cooperative one at pinned schedules
    (`wgmma.gemm`'s `pingpong`), bit for bit: the channel form (B K-major, a column
    bias) at M = N = 328 (3 x 3 tiles, both edges ragged) and the token form (a
    weight shared by the batch, B MN-major, a row bias) at B = 3, M = 200, N = 136
    (12 tiles), K of one stage and of 4096; on a grid of 4 or 5 CTAs, so that CTAs
    walk two or three tiles (the third without a partner), and on the card's whole
    grid (one tile a CTA, the second warpgroup idle). Both within 8e-3 of
    `gemm_reference`; act_only with exact GELU and with quick_gelu."""
    act = wgmma.ACTIVATIONS["quick_gelu" if epi.endswith("quick_gelu") else "gelu"]
    epi = epi.replace("_quick_gelu", "")
    rng = np.random.default_rng(kdim + len(epi) + len(layout) + act)
    rows = layout == "row_bias"
    batch, m, n, sms = (3, 200, 136, 5) if rows else (1, 328, 328, 4)
    a = _bf16(rng, m, kdim, std=kdim ** -0.5)
    b = _bf16(rng, batch, kdim, n) if rows else _bf16(rng, n, kdim)
    bias = torch.linspace(-2, 1, m if rows else n, device=cuda)
    kw = dict(b_mn_major=True, batch=batch, sb=kdim * n, sc=m * n, bias_rows=True) if rows \
        else {}
    outs = {}
    for grid in (sms, None):
        for pingpong in (False, True):
            k = _Launcher(cuda, torch.bfloat16)
            k.sms = grid or k.sms
            c = torch.zeros(batch, m, n, dtype=torch.bfloat16, device=cuda)
            took = wgmma.gemm(k, a, b, c, m, n, kdim, epi, bias=bias, act=act, bn=128,
                              pingpong=pingpong, **kw)
            assert took == pingpong
            outs[grid, pingpong] = c
    ref, _ = wgmma.gemm_reference(a, b, epi, b_mn_major=rows, bias=bias, bias_rows=rows,
                                  act="quick_gelu" if act else "gelu")
    for grid in (sms, None):
        c0, c1 = outs[grid, False], outs[grid, True]
        assert torch.equal(c1, c0)
        assert _rel(c1.view_as(ref), ref) <= 8e-3


def test_wgmma_plan_takes_pingpong_at_many_tiles_per_cta(cuda):
    """On the card's own SM count the plan sends the token g1 at B=8 (512 tiles)
    to the ping-pong walk and K6's r (128 tiles) to the cooperative one, with the
    same bits as the other schedule pinned; the entry point refuses the ping-pong
    walk for the residual add, the train forward's and the backward's epilogues,
    which it lacks."""
    rng = np.random.default_rng(24)
    k = _Launcher(cuda, torch.bfloat16)
    cases = {"g1": (8, 1024, 1024, 256, "act_only"), "r": (8, 256, 1024, 1024, "res")}
    for name, (batch, m, n, kdim, epi) in cases.items():
        a, b = _bf16(rng, m, kdim, std=kdim ** -0.5), _bf16(rng, batch, kdim, n)
        bias, res = torch.linspace(-1, 1, m, device=cuda), _bf16(rng, batch, m, n)
        kw = dict(b_mn_major=True, batch=batch, sb=kdim * n, sc=m * n, bias=bias,
                  bias_rows=True, res=res if epi == "res" else None)
        planned = wgmma.wgmma_plan(m, n, k.sms, batch, epi)
        assert planned.pingpong == (epi == "act_only" and wgmma.wgmma_tiles(m, n, 128, batch)
                                    >= wgmma.PINGPONG_MIN_TILES_PER_SM * k.sms)
        c, other = (torch.empty(batch, m, n, dtype=torch.bfloat16, device=cuda)
                    for _ in range(2))
        assert wgmma.gemm(k, a, b, c, m, n, kdim, epi, **kw) == planned.pingpong
        if epi == "act_only":
            assert wgmma.gemm(k, a, b, other, m, n, kdim, epi, pingpong=not planned.pingpong,
                              **kw) == (not planned.pingpong)
            assert torch.equal(c, other), name
    with pytest.raises(RuntimeError):
        wgmma.gemm(k, a, b, c, m, n, kdim, "res", pingpong=True, **kw)
    with pytest.raises(RuntimeError):
        wgmma.gemm(k, a, b, c, m, n, kdim, "mul", b_mn_major=True, batch=batch, sb=kdim * n,
                   sc=m * n, mul=res, pingpong=True)
    with pytest.raises(RuntimeError):
        wgmma.gemm(k, a, b, c, m, n, kdim, "act", b_mn_major=True, batch=batch, sb=kdim * n,
                   sc=m * n, bias=bias, bias_rows=True, aux=other, pingpong=True)


def test_mixer_block_b256_on_pingpong_matches_plain(cuda):
    """K2 at the batch cell's B=256 (T=256, D=1024, bf16): its GELU GEMMs g1 and
    g3 take the ping-pong walk (`pingpong_launches` 2 of 4 wgmma GEMMs), within the
    bf16 ceiling 3e-2 of max |plain|, and bit for bit the block with every GEMM
    cooperative."""
    gen = torch.Generator(device=cuda).manual_seed(256)
    b, t, d = 256, 256, 1024
    et, ec = 4 * t, 4 * d

    def n(*shape, std):
        return torch.randn(*shape, generator=gen, device=cuda) * std

    w = MixerBlockWeights(
        ln1_w=1 + n(d, std=0.1), ln1_b=n(d, std=0.1), t1=n(et, t, std=t ** -0.5).bfloat16(),
        t1b=n(et, std=0.1), t2=n(t, et, std=et ** -0.5).bfloat16(), t2b=n(t, std=0.1),
        ln2_w=1 + n(d, std=0.1), ln2_b=n(d, std=0.1), w1=n(ec, d, std=d ** -0.5).bfloat16(),
        b1=n(ec, std=0.1), w2=n(d, ec, std=ec ** -0.5).bfloat16(), b2=n(d, std=0.1))
    x = n(b, t, d, std=1.0).bfloat16()
    before = (mixer_block.wgmma_launches, mixer_block.pingpong_launches)
    got = mixer_block(x, w)
    assert (mixer_block.wgmma_launches - before[0], mixer_block.pingpong_launches - before[1]) \
        == (4, 2)
    ref = mixer_block_plain(x, w)
    assert _rel(got, ref) <= 3e-2
    out, _, k = _block_forward(x, w, False, pingpong=False)
    assert (k.wgmma_launches, k.pingpong_launches) == (4, 0)
    assert torch.equal(out, got)


def test_wgmma_gemm_raises_on_a_misaligned_base(cuda):
    k = _Launcher(cuda, torch.bfloat16)
    a = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(64, 64)
    b = torch.zeros(64, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        wgmma.gemm(k, a, b, torch.empty(64, 64, device=cuda), 64, 64, 64, "f32")


def _random_mapper(s, d, depth, dtype, seed):
    rng = np.random.default_rng(seed)
    mapper = Mixer(8, s, 8, d, depth, dtype=dtype)
    for p in mapper.parameters():
        scale = np.sqrt(p[0].numel() if p.dim() > 1 else 10)
        p.data = torch.from_numpy(rng.normal(size=p.shape).astype(np.float32) / scale)
    return mapper


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,d,depth", [(2, 8, 96, 3), (3, 7, 100, 2), (1, 16, 128, 4),
                                         (2, 8, 128, 3)])
def test_mixer_stream_kernel_matches_plain(cuda, dtype, b, s, d, depth):
    """K4: one launch for the stack, against the plain version (K5's plain
    version over the depth); two launches give the same bits. In bf16 T = 49,
    D = 100 takes the WMMA tile's kernel, the others the persistent wgmma one."""
    mapper = _random_mapper(s, d, depth, dtype, 2).to(cuda)
    sp = stack_mixer_params([blk.kernel_weights(torch.float32) for blk in mapper.blocks], dtype)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(b, s * s, d)).astype(np.float32))
    x = x.to(cuda, dtype)
    before = mixer_stream.launches
    got = mixer_stream(x, sp)
    again = mixer_stream(x, sp)
    assert mixer_stream.launches == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    assert _rel(got, mixer_stream_plain(x, sp)) <= tol
    with pytest.raises(TypeError):
        mixer_stream(x.double(), sp)


def test_mixer_stream_wgmma_plans_agree(cuda):
    """The wgmma route of K4 at T = 64, D = 128, L = 3, B = 2 under its own plan,
    without split-K (the plan of one SM) and with every GEMM's K cut (r in 2, g3
    in 2, out in 4: the ordered partial sums, in their own phase or inside the
    next row phase): each within 3e-2 of the plain version, each twice bitwise
    equal."""
    mapper = _random_mapper(8, 128, 3, torch.bfloat16, 6).to(cuda)
    sp = stack_mixer_params([blk.kernel_weights(torch.float32) for blk in mapper.blocks],
                            torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 64, 128)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)
    assert stream_route(x, sp) == "wgmma"
    ref = mixer_stream_plain(x, sp)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    own = stream_plan(2, 64, 128, 256, 512, sms)
    whole = stream_plan(2, 64, 128, 256, 512, 1)
    # K steps of 64: g1 1, r 4, g3 2, out 8
    cut = StreamPlan(own.tiles, (1, 2, 2, 4), (1, 2, 1, 2))
    with torch.cuda.device(cuda):
        for plan in (own, whole, cut):
            got = mixer_stream_module._launch_wgmma(x, sp, plan)
            assert _rel(got, ref) <= 3e-2, plan
            assert torch.equal(got, mixer_stream_module._launch_wgmma(x, sp, plan)), plan


def _block_weights_f32(gen, t, d, device):
    """One Mixer block's weights in float32 (matrices N(0, 1/fan_in), norm scales
    N(1, 0.1), biases N(0, 0.1)) at T tokens, width D, expansion 4."""
    et, ec = 4 * t, 4 * d

    def n(*shape, std):
        return torch.randn(*shape, generator=gen, device=device) * std

    return MixerBlockWeights(
        ln1_w=1 + n(d, std=0.1), ln1_b=n(d, std=0.1), t1=n(et, t, std=t ** -0.5),
        t1b=n(et, std=0.1), t2=n(t, et, std=et ** -0.5), t2b=n(t, std=0.1),
        ln2_w=1 + n(d, std=0.1), ln2_b=n(d, std=0.1), w1=n(ec, d, std=d ** -0.5),
        b1=n(ec, std=0.1), w2=n(d, ec, std=ec ** -0.5), b2=n(d, std=0.1))


def _rel_l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


# C4's gate for K4 on one block in bf16 (chip_smoke.py MIXER_BF16_SHORT_TOL,
# MIXER_BF16_SHORT_REL): max abs err / max |plain| and ||err|| / ||plain||
ONE_BLOCK_BF16 = (1.5e-2, 1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 4], ids=["1x1", "2x2"])
def test_mixer_stream_at_1024_tokens_matches_plain(cuda, dtype, b):
    """K4 at the 512-px OpenCLIP Mixer's widths (T = 1024 tokens, D = 1024, Et =
    Ec = 4096, one block) over a 1x1 and a 2x2 request's rows: float32 within 1e-3
    of max |plain|; bf16 (the wgmma route, its plan cutting r and out in two at
    one row) within C4's one-block gate; two launches bit for bit equal."""
    t = d = 1024
    gen = torch.Generator(device=cuda).manual_seed(1024 + b)
    sp = stack_mixer_params([_block_weights_f32(gen, t, d, cuda)], dtype)
    x = torch.randn(b, t, d, generator=gen, device=cuda).to(dtype)
    if dtype == torch.bfloat16:
        assert stream_route(x, sp) == "wgmma"
    before = mixer_stream.launches
    got = mixer_stream(x, sp)
    assert mixer_stream.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, mixer_stream(x, sp))
    ref = mixer_stream_plain(x, sp)
    if dtype == torch.float32:
        assert _rel(got, ref) <= 1e-3
    else:
        assert _rel(got, ref) <= ONE_BLOCK_BF16[0] and _rel_l2(got, ref) <= ONE_BLOCK_BF16[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mixer_block_at_1024_tokens_matches_plain(cuda, dtype):
    """K2 at the same widths over a 3x3 request's 9 rows (more than K4 takes):
    float32 within 1e-3 of max |plain|, bf16 within C4's one-block gate."""
    t = d = 1024
    gen = torch.Generator(device=cuda).manual_seed(1025)
    w32 = _block_weights_f32(gen, t, d, cuda)
    w = w32._replace(**{k: getattr(w32, k).to(dtype) for k in ("t1", "t2", "w1", "w2")})
    x = torch.randn(9, t, d, generator=gen, device=cuda).to(dtype)
    before = mixer_block.launches
    got = mixer_block(x, w)
    assert mixer_block.launches == before + 1
    ref = mixer_block_plain(x, w)
    if dtype == torch.float32:
        assert _rel(got, ref) <= 1e-3
    else:
        assert _rel(got, ref) <= ONE_BLOCK_BF16[0] and _rel_l2(got, ref) <= ONE_BLOCK_BF16[1]


def test_mixer_stream_flagship_keeps_its_plan_and_bits(cuda):
    """The flagship's K4 (T = 256, D = 1024, 32 blocks, one row, bf16) on a card of
    132 SMs: the plan it takes is the one it has always taken (r 2 splits, g3 2,
    out 8; tests/test_torch_openclip512.py pins it without a card), and a launch
    under that plan written out equals the default launch bit for bit."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if sms != 132:
        pytest.skip(f"the pinned plan is an H100 SXM's (132 SMs), this card has {sms}")
    gen = torch.Generator(device=cuda).manual_seed(32)
    sp = stack_mixer_params([_block_weights_f32(gen, 256, 1024, cuda) for _ in range(32)],
                            torch.bfloat16)
    x = torch.randn(1, 256, 1024, generator=gen, device=cuda).bfloat16()
    pinned = StreamPlan(tiles=(64, 16, 64, 16), splits=(1, 2, 2, 8), k_split=(4, 8, 8, 8))
    assert stream_plan(1, 256, 1024, 1024, 4096, sms) == pinned
    got = mixer_stream(x, sp)
    with torch.cuda.device(cuda):
        assert torch.equal(got, mixer_stream_module._launch_wgmma(x.contiguous(), sp, pinned))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mixer_block_stacked_kernel_matches_plain(cuda, dtype):
    """K5 at every block of a 3-block stack."""
    mapper = _random_mapper(8, 96, 3, dtype, 4).to(cuda)
    sp = stack_mixer_params([blk.kernel_weights(torch.float32) for blk in mapper.blocks], dtype)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 64, 96)).astype(np.float32))
    x = x.to(cuda, dtype)
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    for i in range(3):
        before = mixer_block_stacked.launches
        got = mixer_block_stacked(x, sp, i)
        assert mixer_block_stacked.launches == before + 1
        assert _rel(got, mixer_block_stacked_plain(x, sp, i)) <= tol, i
    with pytest.raises(IndexError):
        mixer_block_stacked(x, sp, 3)


def test_streamed_apply_on_card_matches_cpu(cuda):
    """make_mapper_apply on the card, float32: 1 and 8 rows through K4 (one
    launch), 9 rows through K2 (one launch per block), each within 1e-4 of the
    CPU's module path."""
    mapper = _random_mapper(8, 64, 3, torch.float32, 6)
    cpu_apply = make_mapper_apply(mapper)
    card_apply = make_mapper_apply(copy.deepcopy(mapper).to(cuda))
    for rows, k4, k2 in ((1, 1, 0), (8, 1, 0), (9, 0, 3)):
        x = torch.from_numpy(np.random.default_rng(rows).normal(size=(rows, 8)).astype(np.float32))
        counts = (mixer_stream.launches, mixer_block.launches)
        got = card_apply(x.to(cuda))
        assert (mixer_stream.launches, mixer_block.launches) == (counts[0] + k4, counts[1] + k2)
        assert _rel(got.cpu(), cpu_apply(x)) <= 1e-4


def test_slice_on_card_matches_cpu_module_path(cuda):
    vq = dict(n_embed=32, embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2),
              num_res_blocks=1, attn_resolutions=(4,), resolution=8)
    cpu = build_generator(clip_model="tiny", vqgan_config=vq, dim=64, depth=2,
                          vq_image_size=4, dtype=torch.float32, device="cpu", seed=0)
    card = Generator(cpu.perceptor._replace(module=copy.deepcopy(cpu.perceptor.module).to(cuda)),
                     copy.deepcopy(cpu.mapper).to(cuda), copy.deepcopy(cpu.vq).to(cuda))
    toks = example_tokens(3)
    toks[1, 1], toks[2, 1:4] = 1000, torch.tensor([2000, 3000, 49407])
    vq0 = nearest_codebook_indices_kernel.launches
    k4, k2 = mixer_stream.launches, mixer_block.launches
    got = card.render(card.encode_tokens(toks.to(cuda))).cpu()
    assert nearest_codebook_indices_kernel.launches == vq0 + 1
    assert (mixer_stream.launches, mixer_block.launches) == (k4 + 1, k2)  # 3 rows: K4
    ref = cpu.render(cpu.encode_tokens(toks))
    assert got.shape == (3, 8, 8, 3)
    assert float((got - ref).abs().max()) <= 1e-3


# a Pe-family draw at distortion 1.4 whose horizon crosses the 64-px frame
HORIZON_END_DISP = [[20.89, 41.26], [-32.96, 4.26], [-40.97, -30.36], [0.75, -2.43]]


def _warp_mats(draw, b, h, w, gen):
    if draw == "affine":
        return augment.af_matrices(*augment.af_sample(gen, b, h, w, "cpu"), h, w)
    if draw == "projective":
        return augment.pe_matrices(*augment.pe_sample(gen, b, h, w, "cpu"), h, w)
    if draw == "horizon":
        start, _ = augment.pe_sample(gen, 1, h, w, "cpu")
        return augment.solve_homography(start + torch.tensor([HORIZON_END_DISP]), start)
    # far overshoot: most samples land far outside the frame
    inv = augment._affine_inverse_about_center(torch.tensor([0.2]), torch.tensor([55.0]),
                                               torch.tensor([-60.0]), torch.ones(1), h, w)
    return augment._affine3(inv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("draw", ["affine", "projective", "horizon", "far_overshoot"])
def test_warp_kernels_match_plain(cuda, draw, mode, dtype):
    """K9 (forward) and K10 (adjoint) against their plain versions on the same
    inputs; two K10 runs give bitwise-equal gradients."""
    gen = torch.Generator().manual_seed(7)
    b, h, w = (3, 64, 48) if draw in ("affine", "projective") else (1, 64, 64)
    m = _warp_mats(draw, b, h, w, gen).to(cuda)
    img = torch.rand(b, h, w, 3, generator=gen).to(cuda, dtype)
    g = torch.randn(b, h, w, 3, generator=gen).to(cuda, dtype)
    counts = (warp_forward.launches, warp_adjoint.launches)
    out = warp_forward(img, m, mode)
    grad = warp_adjoint(g, m, mode)
    again = warp_adjoint(g, m, mode)
    assert (warp_forward.launches, warp_adjoint.launches) == (counts[0] + 1, counts[1] + 2)
    assert out.dtype == grad.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert _rel(out, warp_forward_plain(img, m, mode)) <= tol
    ref = warp_adjoint_plain(g, m, mode)
    assert _rel(grad, ref) <= tol
    assert torch.equal(grad, again)


def _af_extremes(h, w):
    """Af maps at the ends of the code's ranges (rotation +-15 degrees,
    translation +-10% on both axes, every sign combination), then a draw pushed
    onto two edges at once: the border strips are at their longest."""
    combos = [(a, x, y) for a in (15.0, -15.0) for x in (0.1, -0.1) for y in (0.1, -0.1)]
    combos.append((15.0, 0.1, 0.1))
    ang, tx, ty = (torch.tensor([v[i] for v in combos]) for i in range(3))
    return augment.af_matrices(ang, tx * w, ty * h, h, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_adjoint_at_edge_heavy_af_draws(cuda, dtype):
    """K10 in border mode at Af's extreme draws (224 px: full 16 x 16 tiles and
    long edge strips) against its plain version; two runs bitwise equal; in
    float32 <K9 x, g> = <x, K10 g>."""
    gen = torch.Generator().manual_seed(3)
    h = w = 224
    m = _af_extremes(h, w).to(cuda)
    b = m.shape[0]
    img = torch.rand(b, h, w, 3, generator=gen).to(cuda, dtype)
    g = torch.randn(b, h, w, 3, generator=gen).to(cuda, dtype)
    grad = warp_adjoint(g, m, "border")
    again = warp_adjoint(g, m, "border")
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert _rel(grad, warp_adjoint_plain(g, m, "border")) <= tol
    assert torch.equal(grad, again)
    if dtype == torch.float32:
        terms = warp_forward(img, m, "border").double() * g.double()
        dot = (terms.sum() - (img.double() * grad.double()).sum()).abs()
        assert dot.item() <= 1e-5 * terms.abs().sum().item()


@pytest.mark.parametrize("c", [1, 5])
def test_warp_kernels_take_any_channel_count(cuda, c):
    """K10 sums channels in chunks of 4: one partial chunk, and a full one plus a
    partial one."""
    gen = torch.Generator().manual_seed(c)
    m = _warp_mats("projective", 2, 40, 56, gen).to(cuda)
    img = torch.rand(2, 40, 56, c, generator=gen).to(cuda)
    g = torch.randn(2, 40, 56, c, generator=gen).to(cuda)
    for mode in ("zeros", "border"):
        assert _rel(warp_forward(img, m, mode), warp_forward_plain(img, m, mode)) <= 1e-4
        assert _rel(warp_adjoint(g, m, mode), warp_adjoint_plain(g, m, mode)) <= 1e-4


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5])
def test_warp_forward_repeats_bitwise_at_any_alignment(cuda, c):
    """K9 twice on the same inputs gives the same bits (C = 3 compiled for the images,
    any other C read at run time); an image that starts off a 16-byte boundary gives
    the same bits as an aligned copy; an output frame of 30 x 37 (rows of 37 pixels,
    ragged against every warp) matches the plain version."""
    gen = torch.Generator().manual_seed(20 + c)
    m = _warp_mats("projective", 2, 40, 56, gen).to(cuda)
    img = torch.rand(2, 40, 56, c, generator=gen).to(cuda, torch.bfloat16)
    for mode in ("zeros", "border"):
        out = warp_forward(img, m, mode)
        assert torch.equal(out, warp_forward(img, m, mode))
        buf = torch.empty(img.numel() + 1, dtype=img.dtype, device=cuda)
        shifted = buf[1:].view_as(img)
        shifted.copy_(img)
        assert torch.equal(warp_forward(shifted, m, mode), out)
        assert _rel(out, warp_forward_plain(img, m, mode)) <= 3e-2
        ragged = warp_forward(img, m, mode, (30, 37))
        assert _rel(ragged, warp_forward_plain(img, m, mode, (30, 37))) <= 3e-2


def _crop_mats(case, b, gen):
    """(m, input frame, output frame, padding) of a rectangular warp: crops of a
    64-px frame to 32 (Re draws, shrinking or magnifying, and Cc), a 20-px box
    zoomed to 64 (3.2x), and a projective map onto a 40x24 frame."""
    if case == "re_64_to_32":
        box = augment.re_sample(gen, b, 64, 64, (0.1, 1.0))
        return augment.crop_matrices(*box, 32), (64, 64), (32, 32), "border"
    if case == "cc_64_to_32":
        full = torch.full((b,), 32.0)
        return augment.crop_matrices(full / 2, full / 2, full, full, 32), (64, 64), (32, 32), \
            "border"
    if case == "zoom_32_to_64":
        x0 = torch.rand(b, generator=gen) * 12
        side = torch.full((b,), 20.0)
        return augment.crop_matrices(x0, x0.flip(0), side, side, 64), (32, 32), (64, 64), \
            "border"
    m = augment.pe_matrices(*augment.pe_sample(gen, b, 64, 48, "cpu"), 64, 48)
    return m, (64, 48), (40, 24), "zeros"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["re_64_to_32", "cc_64_to_32", "zoom_32_to_64",
                                  "pe_64x48_to_40x24"])
def test_rectangular_warp_kernels_match_plain(cuda, case, dtype):
    """K9 onto an output frame other than the input's and K10 back onto the
    input frame, against their plain versions; two K10 runs bitwise equal."""
    gen = torch.Generator().manual_seed(11)
    b = 4
    m, (h, w), (ho, wo), mode = _crop_mats(case, b, gen)
    m = m.to(cuda)
    img = torch.rand(b, h, w, 3, generator=gen).to(cuda, dtype)
    g = torch.randn(b, ho, wo, 3, generator=gen).to(cuda, dtype)
    counts = (warp_forward.launches, warp_adjoint.launches)
    out = warp_forward(img, m, mode, (ho, wo))
    grad = warp_adjoint(g, m, mode, (h, w))
    again = warp_adjoint(g, m, mode, (h, w))
    assert (warp_forward.launches, warp_adjoint.launches) == (counts[0] + 1, counts[1] + 2)
    assert out.shape == (b, ho, wo, 3) and grad.shape == (b, h, w, 3)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    assert _rel(out, warp_forward_plain(img, m, mode, (ho, wo))) <= tol
    assert _rel(grad, warp_adjoint_plain(g, m, mode, (h, w))) <= tol
    assert torch.equal(grad, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pool_backward_repeats_bitwise(cuda, dtype):
    """The cutouts' (avg + max) / 2 pool, 256 -> 224 at the train step's batch:
    two backward runs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand(8, 256, 256, 3, generator=gen, device=cuda).to(dtype).requires_grad_()
    g = torch.randn(8, 224, 224, 3, generator=gen, device=cuda).to(dtype)

    def grad():
        out = (pooling.adaptive_avg_pool(x, 224) + pooling.adaptive_max_pool(x, 224)) / 2.0
        return torch.autograd.grad(out, x, g)[0]

    assert torch.equal(grad(), grad())


@pytest.mark.parametrize("code", ["Et", "Ts", "R"])
def test_plain_code_backwards_between_runs(cuda, code):
    """Et and Ts (the gather's backward: a stable sort of the taps by pixel and a
    fixed-order sum of each pixel's run) and R (products with jax.image.resize's
    weight matrices) at fixed draws, 64 crops of 224 px in f32: two runs of the
    image gradient bitwise equal, also under torch.use_deterministic_algorithms."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.rand(64, 256 if code == "R" else 224, 256 if code == "R" else 224, 3,
                   generator=gen, device=cuda).requires_grad_()
    if code == "Et":
        noise = torch.rand(64, 224, 224, 2, generator=gen, device=cuda) * 2 - 1
        fn = lambda v: augment.elastic_warp(v, noise)  # noqa: E731
    elif code == "Ts":
        src, dst = augment.ts_sample(gen, 64, cuda)
        fn = lambda v: augment.tps_warp(v, src, dst)  # noqa: E731
    else:
        fn = lambda v: augment.resize_bilinear(v, 224)  # noqa: E731
    g = torch.randn(64, 224, 224, 3, generator=gen, device=cuda)
    first, second = (torch.autograd.grad(fn(x), x, g)[0] for _ in range(2))
    torch.use_deterministic_algorithms(True)
    try:
        third = torch.autograd.grad(fn(x), x, g)[0]
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"{code}: two backward runs bitwise equal: {torch.equal(first, second)}, max |diff| "
          f"{(first - second).abs().max().item():.3e}")
    assert torch.equal(first, second) and torch.equal(first, third)


TINY_VQ = dict(n_embed=32, embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2),
               num_res_blocks=1, attn_resolutions=(4,), resolution=8)


@pytest.mark.parametrize("cutouts", [
    dict(),
    dict(pool=False, augs=["Re", "Af", "Pe", "Ji", "Er"]),
    dict(pool_size=16, augs=["Cc", "Af", "Pe", "Sh"], fuse_geometric=True, interpolate=True,
         interp_size=32),
], ids=["default", "unpooled_re", "pool16_cc_fused_interp"])
def test_trainer_repeats_bitwise_and_runs_deterministic(cuda, tmp_path, monkeypatch, cutouts):
    """train() on the card at a tiny size: two runs of 2 steps give bitwise-equal
    parameters and Adam moments, and a third run under
    torch.use_deterministic_algorithms(True) (where an op with a nondeterministic
    CUDA implementation raises, and one with a deterministic alternative takes
    it) gives the same bits: no op of the path has another implementation there.
    CUBLAS_WORKSPACE_CONFIG is set only to pass that mode's check; cuBLAS's
    workspace was fixed by this process's first call, so a run that wants
    cuBLAS itself deterministic sets it before any CUDA call."""
    toks = np.zeros((8, 77), np.int32)
    toks[:, 0], toks[:, 1], toks[:, 2] = 49406, np.arange(8) + 5, 49407
    path = str(tmp_path / "toks.npz")
    np.savez(path, tokens=toks)
    kw = dict(clip_model="tiny", vqgan_arch=TINY_VQ, model_type="mlp_mixer", dim=64, depth=2,
              dropout=0, vq_image_size=4, batch_size=4, cutn=2, cut_size=32, pool_size=32,
              compute_dtype="float32", noise_dim=0, max_steps=2, log_interval=100, seed=0,
              path=path)
    kw.update(cutouts)

    def run(name):
        state = loop.train(make_config(folder=str(tmp_path / name), **kw), device=cuda)
        return list(state.params) + list(state.opt_state.mu) + list(state.opt_state.nu)

    a, b = run("a"), run("b")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        det = run("det")
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(torch.equal(x, y) for x, y in zip(a, det))


def test_warp_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    m = torch.eye(3, device=cuda)[None]
    with pytest.raises(TypeError):
        warp_forward(torch.zeros(1, 8, 8, 3, dtype=torch.float64, device=cuda), m, "zeros")
    with pytest.raises(ValueError):
        warp_adjoint(torch.zeros(1, 1, 8, 3, device=cuda), m, "zeros")
    with pytest.raises(ValueError):
        warp_forward(torch.zeros(1, 8, 8, 3, device=cuda), m, "reflection")
    with pytest.raises(ValueError):
        warp_forward(torch.zeros(1, 8, 8, 3, device=cuda), m, "zeros", (1, 8))
    with pytest.raises(ValueError):
        warp_adjoint(torch.zeros(1, 8, 8, 3, device=cuda), m, "zeros", (8, 1))


def _mlp_weights(d, e, dtype, rng, cuda):
    t = lambda *shape, std: torch.from_numpy(  # noqa: E731
        (rng.normal(size=shape) * std).astype(np.float32)).to(cuda)
    return MlpLnWeights(ln_w=1 + t(d, std=0.1), ln_b=t(d, std=0.1),
                        w1=t(e, d, std=d ** -0.5).to(dtype), b1=t(e, std=0.1),
                        w2=t(d, e, std=e ** -0.5).to(dtype), b2=t(d, std=0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,d,e,act", [(272, 128, 512, "quick_gelu"), (100, 96, 384, "gelu"),
                                       (3200, 768, 3072, "quick_gelu")])
def test_mlp_ln_kernels_match_plain(cuda, dtype, n, d, e, act):
    """K11's forward and its backward, dx alone and with the parameter grads,
    against the plain versions; two backward runs give the same bits."""
    rng = np.random.default_rng(n + d)
    w = _mlp_weights(d, e, dtype, rng, cuda)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda, dtype)
    dy = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    counts = (mlp_ln.launches, mlp_ln_bwd.launches)
    out, g, dg = mlp_ln(x, w, act)
    for got, ref in zip((out, g, dg), mlp_ln_plain(x, w, act)):
        assert got.dtype == dtype and _rel(got, ref) <= tol
    full = mlp_ln_bwd(dy, x, g, dg, w)
    ref = mlp_ln_bwd_plain(dy, x, g, dg, w)
    for name in MlpLnGrads._fields:
        assert _rel(getattr(full, name), getattr(ref, name)) <= tol, name
    only = mlp_ln_bwd(dy, x, g, dg, w, params=False)
    again = mlp_ln_bwd(dy, x, g, dg, w)
    assert torch.equal(only.dx, full.dx) and all(v is None for v in only[1:])
    assert all(torch.equal(a, b) for a, b in zip(full, again))
    assert (mlp_ln.launches, mlp_ln_bwd.launches) == (counts[0] + 1, counts[1] + 3)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("n", [100, 3200], ids=["rows_100", "rows_3200"])
def test_mlp_ln_wgmma_gemm_matches_plain(cuda, n, act):
    """K11's bf16 GEMMs (csrc/wgmma_gemm.cuh) at ViT-B/32's widths: rows not a
    multiple of the 128-row tile (100 = 2 crops x 50 tokens) and the train loss's
    3200, per-column biases and a residual far from symmetric; the forward's
    three outputs and dx against the plain versions, dx bitwise between two runs
    and equal with the parameter grads asked for."""
    rng = np.random.default_rng(n)
    d, e = 768, 3072
    w = _mlp_weights(d, e, torch.bfloat16, rng, cuda)
    w = w._replace(b1=w.b1 + torch.linspace(-1, 1, e, device=cuda),
                   b2=w.b2 + torch.linspace(0, 2, d, device=cuda))
    x = torch.from_numpy((rng.normal(size=(n, d)) + np.arange(n)[:, None] / n).astype(
        np.float32)).to(cuda, torch.bfloat16)
    dy = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    out, g, dg = mlp_ln(x, w, act)
    for got, ref in zip((out, g, dg), mlp_ln_plain(x, w, act)):
        assert _rel(got, ref) <= 3e-2
    only = mlp_ln_bwd(dy, x, g, dg, w, params=False)
    again = mlp_ln_bwd(dy, x, g, dg, w, params=False)
    full = mlp_ln_bwd(dy, x, g, dg, w, params=True)
    assert _rel(only.dx, mlp_ln_bwd_plain(dy, x, g, dg, w, params=False).dx) <= 3e-2
    assert torch.equal(only.dx, again.dx) and torch.equal(only.dx, full.dx)


def test_mlp_ln_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    rng = np.random.default_rng(0)
    w = _mlp_weights(128, 512, torch.float32, rng, cuda)
    with pytest.raises(TypeError):
        mlp_ln(torch.zeros(16, 128, dtype=torch.float64, device=cuda), w)
    with pytest.raises(ValueError):
        mlp_ln(torch.zeros(16, 96, device=cuda), w)
    with pytest.raises(ValueError):
        mlp_ln(torch.zeros(16, 128, device=cuda), w, "relu")
    with pytest.raises(ValueError):
        mlp_ln(torch.zeros(16, 128, device=cuda), w._replace(w1=w.w1.to(torch.bfloat16)))
    odd = _mlp_weights(100, 400, torch.bfloat16, rng, cuda)  # TMA needs widths % 8
    with pytest.raises(ValueError):
        mlp_ln(torch.zeros(16, 100, dtype=torch.bfloat16, device=cuda), odd)


def test_fused_clip_tower_on_card_matches_cpu(cuda):
    """The image tower with K11 sublayers on the card against the CPU (plain
    K11), float32, with the input gradient: one forward and one dx-only backward
    launch per block."""
    cfg = dict(image_size=32, patch_size=8, vision_width=128, vision_layers=2, vision_heads=4,
               embed_dim=32, text_width=32, text_layers=1, text_heads=2, vocab_size=64,
               context_length=8)
    cpu = make_clip_from_config(cfg, image=True, device="cpu")
    cpu.init_random_(torch.Generator().manual_seed(0))
    cpu.requires_grad_(False)
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(16, 32, 32, 3)).astype(
        np.float32))
    xc = x.to(cuda).requires_grad_()
    counts = (mlp_ln.launches, mlp_ln_bwd.launches)
    got = encode_image_fused(card, xc)
    got.square().sum().backward()
    assert (mlp_ln.launches, mlp_ln_bwd.launches) == (counts[0] + 2, counts[1] + 2)
    xr = x.clone().requires_grad_()
    ref = encode_image_fused(cpu, xr)
    ref.square().sum().backward()
    assert _rel(got.detach().cpu(), ref.detach()) <= 1e-3
    assert _rel(xc.grad.cpu(), xr.grad) <= 1e-3


@pytest.mark.parametrize("cfg", [
    dict(model_type="vitgan", dim=64, depth=2, vq_image_size=16, num_heads=5),
    dict(model_type="xtransformer", dim=64, depth=2, vq_image_size=8, num_heads=2),
], ids=["vitgan", "xtransformer"])
def test_other_mappers_take_the_module_path_on_card(cuda, cfg):
    """make_mapper_apply and make_mapper_train_apply run a non-Mixer mapper as its
    module on a CUDA tensor: no Mixer kernel launches, the CPU's output within
    1e-4 of max |CPU|, finite parameter grads."""
    cpu = build_mapper(dict(cfg, clip_model="ViT-B/32"), vq_channels=32, device="cpu")
    cpu.init_random_(torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.randn(3, 512, generator=torch.Generator().manual_seed(1))
    counts = (mixer_block.launches, mixer_block_fwd_res.launches)
    got = make_mapper_apply(card)(x.to(cuda))
    out = make_mapper_train_apply(card)(x.to(cuda))
    out.square().mean().backward()
    assert (mixer_block.launches, mixer_block_fwd_res.launches) == counts
    with torch.no_grad():
        want = cpu(x)
    assert _rel(got.cpu(), want) <= 1e-4 and _rel(out.detach().cpu(), want) <= 1e-4
    assert all(torch.isfinite(p.grad).all() for p in card.parameters())


def test_clip_resnet_on_card_matches_cpu(cuda):
    """The RN50 perceptor (random weights) on the card against the CPU, float32:
    both encodes within 1e-3 of max |CPU| (cuDNN's convolutions sum in another
    order)."""
    cpu = CLIPResNet(CLIP_RESNET_CONFIGS["RN50"], device="cpu")
    cpu.init_random_(torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(cuda)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 224, 224, 3)).astype(
        np.float32))
    toks = example_tokens(2)
    with torch.no_grad():
        assert _rel(card.encode_image(x.to(cuda)).cpu(), cpu.encode_image(x)) <= 1e-3
        assert _rel(card.encode_text(toks.to(cuda)).cpu(), cpu.encode_text(toks)) <= 1e-3


# the released prior's widths as chip_smoke.py's [prior] reads "2x1024": ViT-B/32's
# 512-d embeddings, 2 flows, hidden 1024 at depth 2, embedding 1024
PRIOR_MODEL = dict(embedding_dim=1024, hidden_dim=1024, hidden_depth=2, n_flows=2)


def test_prior_reverse_on_card_matches_cpu(cuda):
    cpu = flow.build_prior_model({"model": PRIOR_MODEL}, 512, 512, device="cpu")
    cpu.init_random_(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for a in (cpu.sub_layers[0].norm_layer.loc, cpu.sub_layers[1].norm_layer.scale):
            a.add_(0.1 * torch.randn(a.shape, generator=torch.Generator().manual_seed(1)))
    card = copy.deepcopy(cpu).to(cuda)
    gen = torch.Generator().manual_seed(2)
    z, cond = torch.randn(8, 512, generator=gen), torch.randn(8, 512, generator=gen)
    with torch.no_grad():
        want = cpu.reverse(z, cond)
        got = card.reverse(z.to(cuda), cond.to(cuda)).cpu()
    assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 2e-2)])
def test_vgg16_on_card_matches_cpu(cuda, dtype, tol):
    """Random weights from a seed; the CPU runs float32, the card `dtype`."""
    cpu = VGG16Features().init_random_(torch.Generator().manual_seed(0))
    card = VGG16Features(dtype=dtype, device=cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(
        np.float32))
    with torch.no_grad():
        for got, want in zip(card(x.to(cuda)), cpu(x)):
            assert got.dtype == dtype and _rel(got.cpu(), want) <= tol


def test_predictor_prior_request_on_card(cuda, tmp_path, monkeypatch):
    """A tiny float32 Mixer with a tiny prior (C = D = 32), the same weights on
    the card and on the CPU: 1x1 and 2x2 requests with prior=True (the prior's
    z drawn from the request's CPU generator on both) within 2/255 of the CPU's
    PNG; prior=True changes the card's images."""
    path = tmp_path / "merges.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as fd:
        fd.write("#version: 0.2\nh e\nl l\nhe ll\nhell o</w>\n")
    monkeypatch.setenv("FFVC_BPE_PATH", str(path))
    bpe.get_tokenizer.cache_clear()
    vq = dict(n_embed=32, embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2),
              num_res_blocks=1, attn_resolutions=(4,), resolution=8)
    cfg = dict(clip_model="tiny", vqgan_arch=vq, model_type="mlp_mixer", dim=64, depth=2,
               dropout=0, vq_image_size=4, compute_dtype="float32", noise_dim=0)
    mapper = build_mapper(make_config(**cfg), vq_channels=8)
    mapper.init_random_(torch.Generator().manual_seed(3))
    model = save_model(str(tmp_path / "tiny.th"), mapper, cfg)
    prior_cfg = {"model": dict(PRIOR_MODEL, hidden_dim=64, embedding_dim=16)}
    prior = flow.build_prior_model(prior_cfg, 32, 32, device="cpu")
    prior.init_random_(torch.Generator().manual_seed(4))
    prior_path = flow.save_prior(str(tmp_path / "prior.th"), prior, prior_cfg)
    preds = {}
    for dev in ("cpu", "cuda"):
        preds[dev] = Predictor([model], {"tiny.th": prior_path}, device=dev)
        preds[dev].setup()
    cpu, card = preds["cpu"], preds["cuda"]
    for key, perc in cpu.perceptors.items():
        card.perceptors[key].module.load_state_dict(perc.module.state_dict())
    for key, (cvq, _) in cpu.vqgans.items():
        card_vq = card.vqgans[key][0]
        card_vq.load_state_dict(cvq.state_dict())
        card.vqgans[key] = (card_vq, latent_bounds(card_vq))

    def png(pred, name, **kw):
        out = pred.predict("hello", "tiny.th", seed=5, out_path=str(tmp_path / name), **kw)
        with open(out, "rb") as f:
            return decode_png(f.read()).astype(np.int32)

    for grid in ("1x1", "2x2"):
        got = png(card, "card.png", grid_size=grid, prior=True)
        want = png(cpu, "cpu.png", grid_size=grid, prior=True)
        assert got.shape == want.shape and np.abs(got - want).max() <= 2, grid
        assert np.abs(got - png(card, "plain.png", grid_size=grid)).max() > 2, grid


# crowsonkb's CLOOB ViT at a small config (the full one is chip_smoke.py's [perceptors])
CLOOB_SMALL = dict(d_embed=64, image_layers=2, image_d_model=128, image_heads=4,
                   image_size=64, patch_size=16, text_layers=2, text_d_model=128,
                   text_heads=2, text_size=77, vocab_size=49408)
# an OpenCLIP ViT outside the registry, read by sniffing its file's shapes
SNIFFED_VIT = dict(image_size=64, patch_size=16, vision_width=128, vision_layers=2,
                   vision_heads=2, embed_dim=64, text_width=128, text_layers=2,
                   text_heads=2, vocab_size=49408, context_length=77)


def _card_against_cpu(load, cuda, size):
    """encode_text and encode_image of load(device) on the card against the CPU,
    float32: within 1e-4 of max(1, max |CPU|)."""
    cpu, card = load("cpu"), load(cuda)
    toks = example_tokens(2)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, size, size, 3)).astype(
        np.float32))
    with torch.no_grad():
        for got, want in ((card.encode_text(toks.to(cuda)), cpu.encode_text(toks)),
                          (card.encode_image(x.to(cuda)), cpu.encode_image(x))):
            err = (got.cpu() - want).abs().max().item()
            assert err <= 1e-4 * max(1.0, want.abs().max().item())


def test_cloob_vit_and_sniffed_tower_on_card_match_cpu(cuda, tmp_path, monkeypatch):
    from feed_forward_vqgan_clip_tpu_torch.models import cloob
    from feed_forward_vqgan_clip_tpu_torch.models.perceptor import load_perceptor

    src = cloob.CrowsonCLOOB(CLOOB_SMALL).init_random_(torch.Generator().manual_seed(1))
    _card_against_cpu(lambda dev: copy.deepcopy(src).to(dev).eval(), cuda, 64)
    src = make_clip_from_config(SNIFFED_VIT, act="gelu", image=True)
    src.init_random_(torch.Generator().manual_seed(2))
    path = str(tmp_path / "sniffed.pt")
    torch.save({f"module.{k}": v.half() for k, v in src.state_dict().items()}, path)
    _card_against_cpu(lambda dev: load_perceptor("openclip/ViT-S-16-custom/x", path,
                                                 dtype=torch.float32, device=dev), cuda, 64)


def test_jax_checkpoint_dir_serves_bitwise_like_its_th(cuda, tmp_path, monkeypatch):
    """A tiny Mixer written as a `.th` and as a JAX checkpoint directory (the
    port's msgpack writer): the card's Predictor renders the same PNGs from
    both, byte for byte (K4 at 1x1, 2x2; K2 at 3x3)."""
    from feed_forward_vqgan_clip_tpu_torch.io.checkpoint import save_checkpoint_dir
    from feed_forward_vqgan_clip_tpu_torch.io.from_jax import mixer_tree

    path = tmp_path / "merges.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as fd:
        fd.write("#version: 0.2\nh e\nl l\nhe ll\nhell o</w>\n")
    monkeypatch.setenv("FFVC_BPE_PATH", str(path))
    bpe.get_tokenizer.cache_clear()
    vq = dict(n_embed=32, embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2),
              num_res_blocks=1, attn_resolutions=(4,), resolution=8)
    cfg = dict(clip_model="tiny", vqgan_arch=vq, model_type="mlp_mixer", dim=64, depth=2,
               dropout=0, vq_image_size=4, compute_dtype="bfloat16", noise_dim=0)
    mapper = build_mapper(make_config(**cfg), vq_channels=8)
    mapper.init_random_(torch.Generator().manual_seed(5))
    th = save_model(str(tmp_path / "tiny.th"), mapper, cfg)
    jdir = save_checkpoint_dir(str(tmp_path), "tiny_dir", mixer_tree(mapper.state_dict()), cfg,
                               step=1, epoch=0)
    pred = Predictor([th, jdir], device=cuda)
    pred.setup()
    for grid in ("1x1", "2x2", "3x3"):
        outs = [pred.predict("hello", name, grid_size=grid, seed=7,
                             out_path=str(tmp_path / f"{name}.png"))
                for name in ("tiny.th", "tiny_dir")]
        with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
            assert a.read() == b.read(), grid


def test_encoder_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """The webdataset encoder with the registry's tiny CLIP (random from a seed),
    float32: the card's features within 1e-4 of max(1, max |CPU|), same rows."""
    import io
    import tarfile

    from PIL import Image

    from feed_forward_vqgan_clip_tpu_torch.data import encode

    path = tmp_path / "merges.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as fd:
        fd.write("#version: 0.2\nh e\nl l\nhe ll\nhell o</w>\n")
    monkeypatch.setenv("FFVC_BPE_PATH", str(path))
    bpe.get_tokenizer.cache_clear()
    rng = np.random.default_rng(4)
    with tarfile.open(tmp_path / "shard-000.tar", "w") as tf:
        for i in range(9):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, size=(40, 48, 3), dtype=np.uint8)).save(
                buf, "JPEG")
            for name, data in ((f"{i:03d}.input.jpg", buf.getvalue()),
                               (f"{i:03d}.output.txt", f"hello {i}".encode())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    clip = make_clip_from_config(CLIP_VIT_CONFIGS["tiny"], image=True)
    clip.init_random_(torch.Generator().manual_seed(6))  # one draw for both devices
    clip_path = str(tmp_path / "tiny_clip.pt")
    torch.save(clip.state_dict(), clip_path)
    load = encode.load_perceptor
    monkeypatch.setattr(encode, "load_perceptor",
                        lambda *a, **k: load(*a, **{**k, "dtype": torch.float32}))
    outs = {}
    for dev in ("cpu", cuda):
        outs[str(dev)] = encode._load_pairs(encode.encode_text_and_images_webdataset(
            str(tmp_path / "shard-*.tar"), clip_model="tiny", clip_path=clip_path, batch_size=4,
            device=dev, out=str(tmp_path / f"f_{dev}.npz")))
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert got.shape == want.shape == (9, 32)
        assert np.abs(got - want).max() <= 1e-4 * max(1.0, float(np.abs(want).max()))


def test_native_tokenizer_is_active(cuda):
    """The g++-built BPE core builds on the card's machine: no silent fallback."""
    merges = ["h e", "l l", "he ll", "hell o</w>"]
    tok, pure = bpe.ClipTokenizer(merges=merges), bpe.ClipTokenizer(merges=merges)
    assert tok.native is not None
    pure.native = None
    assert tok.encode("hello hello") == pure.encode("hello hello")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_upsample_transposed_matches_reference_on_card(cuda, dtype):
    """Upsample (conv_transpose2d on the folded 4x4 taps) against the reference
    graph on its weights (NN-2x then the 3x3 conv) at 128 channels: the output,
    the input gradient and the weight gradient, float32 within 1e-4 and bf16
    within 5e-2 of max |reference| (JAX tests/test_vqgan.py's bf16 tolerance)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=cuda).manual_seed(5)
    m = Upsample(128, dtype=dtype, device=cuda)
    with torch.no_grad():
        m.conv.weight.normal_(0.0, (9 * 128) ** -0.5, generator=gen)
        m.conv.bias.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(2, 128, 32, 32, generator=gen, device=cuda)
    g = torch.randn(2, 128, 64, 64, generator=gen, device=cuda)
    outs = []
    for fn in (lambda v: m.conv(F.interpolate(v, scale_factor=2.0, mode="nearest")), m):
        m.zero_grad()
        xx = x.clone().requires_grad_(True)
        y = fn(xx)
        (y.float() * g).sum().backward()
        outs.append((y.detach(), xx.grad, m.conv.weight.grad.clone()))
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    assert outs[1][0].shape == (2, 128, 64, 64)
    for got, want in zip(outs[1], outs[0]):
        assert _rel(got, want) <= tol


def test_bench_legs_on_card(cuda, monkeypatch, capsys):
    """`cli bench` at a tiny model on the card: the three JSON lines and the
    headline again, each leg's `#` line with its kernel launches (K1 and K2 in
    the infer leg at batch 16, K4 in the latency leg at batch 1, K6-K8, K9, K10
    in the train leg)."""
    import functools
    import json
    import re

    from feed_forward_vqgan_clip_tpu_torch import bench, cli
    from feed_forward_vqgan_clip_tpu_torch import entry as entry_module

    tiny = dict(clip_model="tiny", dim=64, depth=2, vq_image_size=4)
    monkeypatch.setattr(entry_module, "build_generator",
                        functools.partial(build_generator, vqgan_config=TINY_VQ, **tiny))
    monkeypatch.setattr(bench, "train_entry", functools.partial(
        entry_module.train_entry, cutn=2, mapper_config=dict(tiny, vqgan_arch=TINY_VQ)))
    monkeypatch.setattr(bench, "TIMED_SECONDS", 0.5)
    cli.main(["bench", "--batch", "16", "--train-batch", "2"])
    out, err = capsys.readouterr()
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert [x["metric"] for x in lines] == [bench.METRICS[m] for m in
                                            ("infer", "train", "latency", "infer")]
    want = {"infer": ("vq_argmin", "mixer_block"), "latency": ("vq_argmin", "mixer_stream"),
            "train": ("vq_argmin", "mixer_fwd_res", "mixer_channel_bwd", "mixer_token_bwd",
                      "warp_forward", "warp_adjoint")}
    for leg, names in want.items():
        got = json.loads(re.search(rf"^# {leg}:.*; launches (\{{[^}}]*\}});", err, re.M).group(1))
        assert all(got.get(n, 0) > 0 for n in names), (leg, got)


# (channels, side) of every GroupNorm in the f16-16384 decoder at a 16 x 16 latent
GN_DECODER_SHAPES = [(512, 16), (512, 32), (256, 32), (256, 64), (256, 128), (128, 128),
                     (128, 256)]


def _gn_case(b, c, h, w, dtype, cuda, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (1.5 * torch.randn(b, c, h, w, generator=gen, device=cuda)
         + torch.randn(1, c, 1, 1, generator=gen, device=cuda)).to(dtype)
    weight = 1.0 + 0.1 * torch.randn(c, generator=gen, device=cuda)
    bias = 0.1 * torch.randn(c, generator=gen, device=cuda)
    return x, weight, bias


def _gn_check(x, weight, bias, silu, pre_bias=None):
    """The kernel against the plain form by the tolerances of the module docstring."""
    got = group_norm_silu(x, weight, bias, silu=silu, pre_bias=pre_bias).float()
    ref = group_norm_silu_plain(x.float(), weight, bias, silu=silu, pre_bias=pre_bias)
    top = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    assert torch.isfinite(got).all()
    if x.dtype == torch.float32:
        assert err <= 1e-5 * top, (err, top)
    else:
        plain = (group_norm_silu_plain(x, weight, bias, silu=silu, pre_bias=pre_bias).float()
                 - ref).abs().max()
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        assert err <= plain.item() + ulp, (err, plain.item(), ulp)


@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last],
                         ids=["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("c,side", GN_DECODER_SHAPES)
def test_group_norm_kernel_matches_plain(cuda, c, side, b, dtype, layout):
    """Both layouts the kernel reads; the output keeps the input's."""
    x, weight, bias = _gn_case(b, c, side, side, dtype, cuda)
    x = x.contiguous(memory_format=layout)
    with torch.no_grad():
        assert group_norm_silu(x, weight, bias).is_contiguous(memory_format=layout)
        for silu in (False, True):
            _gn_check(x, weight, bias, silu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,c,h,w,offset", [(2, 20, 5, 7, 0), (3, 64, 3, 5, 0), (2, 64, 2, 2, 0),
                                             (2, 96, 8, 8, 1), (3, 8, 5, 3, -1),
                                             (2, 2048, 3, 3, -1)],
                         ids=["per_channel_ragged", "groups32_ragged", "hw4", "misaligned",
                              "nhwc_per_channel", "nhwc_2048"])
def test_group_norm_kernel_ragged_and_misaligned(cuda, b, c, h, w, offset, dtype):
    """The NCHW path: spans whose H W is no multiple of 8, and an input whose
    storage starts one element past a 16-byte boundary; channels-last (offset -1)
    at the ends of its channel range, odd pixel counts."""
    x, weight, bias = _gn_case(b, c, h, w, dtype, cuda, seed=1)
    if offset < 0:
        x = x.contiguous(memory_format=torch.channels_last)
        assert not x.is_contiguous()
    if offset > 0:
        buf = torch.empty(x.numel() + offset, dtype=dtype, device=cuda)
        buf[offset:] = x.reshape(-1)
        x = buf[offset:].view(b, c, h, w)
        assert x.is_contiguous() and x.data_ptr() % 16
    with torch.no_grad():
        for silu in (False, True):
            _gn_check(x, weight, bias, silu)


@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last],
                         ids=["nchw", "nhwc"])
@pytest.mark.parametrize("b,c,side", [(1, 128, 256), (4, 512, 16)])
def test_group_norm_kernel_repeats_bitwise(cuda, b, c, side, layout):
    x, weight, bias = _gn_case(b, c, side, side, torch.bfloat16, cuda, seed=2)
    x = x.contiguous(memory_format=layout)
    span = c * side * side if layout == torch.channels_last else c // 32 * side * side
    if b == 1:  # the spans split: every CTA folds its span's partials
        assert gn_plan(span, c if layout == torch.channels_last else None).splits > 1
    with torch.no_grad():
        first = group_norm_silu(x, weight, bias, silu=True)
        second = group_norm_silu(x, weight, bias, silu=True)
    assert torch.equal(first, second)


@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last],
                         ids=["nchw", "nhwc"])
@pytest.mark.parametrize("c,side", [(128, 128), (512, 16)])
def test_group_norm_kernel_is_batch_invariant(cuda, c, side, layout):
    """Each image of a batch normalizes bit for bit as it does alone: the plan
    slices a span by its length, not by the batch."""
    x, weight, bias = _gn_case(5, c, side, side, torch.bfloat16, cuda, seed=4)
    x = x.contiguous(memory_format=layout)
    with torch.no_grad():
        whole = group_norm_silu(x, weight, bias, silu=True)
        for i in range(x.shape[0]):
            alone = x[i:i + 1].contiguous(memory_format=layout)
            assert torch.equal(group_norm_silu(alone, weight, bias, silu=True), whole[i:i + 1])


def test_group_norm_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, weight, bias = _gn_case(2, 64, 8, 8, torch.float32, cuda)
    with torch.no_grad():
        with pytest.raises(ValueError):
            group_norm_silu(x.transpose(2, 3), weight, bias)
        with pytest.raises(TypeError):
            group_norm_silu(x.half(), weight, bias)
        with pytest.raises(TypeError):
            group_norm_silu(x, weight.double(), bias)
        with pytest.raises(ValueError):
            group_norm_silu(x, weight.cpu(), bias)
        x96, w96, b96 = _gn_case(2, 96, 4, 4, torch.bfloat16, cuda)
        with pytest.raises(ValueError):  # channels-last, 96 channels: no power of two
            group_norm_silu(x96.contiguous(memory_format=torch.channels_last), w96, b96)
        norm96 = GroupNorm32(96, dtype=torch.bfloat16, device=cuda)
        assert norm96(x96.contiguous(memory_format=torch.channels_last)).is_contiguous()
    with pytest.raises(RuntimeError):
        group_norm_silu(x.clone().requires_grad_(True), weight, bias)
    norm = GroupNorm32(64, device=cuda)
    xg = x.clone().requires_grad_(True)
    assert not norm.takes_kernel(xg) and not norm.takes_kernel(x)  # the parameters record
    with torch.no_grad():
        assert norm.takes_kernel(xg)


def _pre_bias(c, cuda, seed=3):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return 0.5 * torch.randn(c, generator=gen, device=cuda)


@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last],
                         ids=["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,c,side", [(1, 512, 16), (4, 256, 32), (2, 128, 128), (2, 64, 5),
                                      (3, 8, 3)])
def test_group_norm_kernel_with_pre_bias_matches_plain(cuda, b, c, side, dtype, layout):
    """x + pre_bias normalized: both layouts, at decoder shapes, at H W no multiple
    of 8 and with one channel a group (C = 8), by the plain form's tolerances; the
    output keeps x's layout."""
    x, weight, bias = _gn_case(b, c, side, side, dtype, cuda, seed=5)
    x = x.contiguous(memory_format=layout)
    pre_bias = _pre_bias(c, cuda)
    with torch.no_grad():
        out = group_norm_silu(x, weight, bias, pre_bias=pre_bias)
        assert out.is_contiguous(memory_format=layout)
        assert not torch.equal(out, group_norm_silu(x, weight, bias))
        for silu in (False, True):
            _gn_check(x, weight, bias, silu, pre_bias)


@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last],
                         ids=["nchw", "nhwc"])
@pytest.mark.parametrize("c,side", [(128, 128), (512, 16)])
def test_group_norm_kernel_with_pre_bias_is_batch_invariant(cuda, c, side, layout):
    x, weight, bias = _gn_case(5, c, side, side, torch.bfloat16, cuda, seed=6)
    x = x.contiguous(memory_format=layout)
    pre_bias = _pre_bias(c, cuda)
    with torch.no_grad():
        whole = group_norm_silu(x, weight, bias, silu=True, pre_bias=pre_bias)
        assert torch.equal(whole, group_norm_silu(x, weight, bias, silu=True, pre_bias=pre_bias))
        for i in range(x.shape[0]):
            alone = x[i:i + 1].contiguous(memory_format=layout)
            assert torch.equal(group_norm_silu(alone, weight, bias, silu=True, pre_bias=pre_bias),
                               whole[i:i + 1])


def test_group_norm_wrapper_raises_on_a_pre_bias_the_kernel_does_not_take(cuda):
    x, weight, bias = _gn_case(2, 64, 8, 8, torch.bfloat16, cuda)
    pre_bias = _pre_bias(64, cuda)
    with torch.no_grad():
        with pytest.raises(TypeError):
            group_norm_silu(x, weight, bias, pre_bias=pre_bias.double())
        with pytest.raises(ValueError):
            group_norm_silu(x, weight, bias, pre_bias=pre_bias[:32])
        with pytest.raises(ValueError):
            group_norm_silu(x, weight, bias, pre_bias=pre_bias.cpu())
    with pytest.raises(RuntimeError):  # the kernel has no backward
        group_norm_silu(x, weight, bias, pre_bias=pre_bias.clone().requires_grad_(True))


def _residual_case(b, c, h, w, dtype, cuda, layout=torch.contiguous_format, seed=7):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    skip, hh = (torch.randn(b, c, h, w, generator=gen, device=cuda).to(dtype)
                .contiguous(memory_format=layout) for _ in range(2))
    return skip, hh, torch.randn(c, generator=gen, device=cuda)


@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last],
                         ids=["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,c,side", [(2, 128, 64), (3, 512, 16), (1, 8, 4)])
def test_residual_kernel_matches_plain_bitwise(cuda, b, c, side, dtype, layout):
    """One launch; skip + h + vec summed in float32 in that order and rounded once,
    as the plain form does: equal bit for bit, in x's layout."""
    skip, h, vec = _residual_case(b, c, side, side, dtype, cuda, layout)
    with torch.no_grad():
        before = residual_add.launches
        got = residual_add(skip, h, vec)
        assert residual_add.launches - before == 1
    assert got.dtype == dtype and got.is_contiguous(memory_format=layout)
    assert torch.equal(got, residual_add_plain(skip, h, vec))
    if dtype == torch.float32:
        assert torch.equal(got, skip + h + vec.reshape(1, -1, 1, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["ragged_nchw", "misaligned", "channels_of_12"])
def test_residual_kernel_reads_ragged_and_misaligned_operands_element_wise(cuda, case, dtype):
    """Contiguous operands the vectors do not fit, H W no multiple of 8, a base one
    element past 16 bytes, C = 12 made contiguous: one launch on the element path,
    the plain form bit for bit."""
    skip, h, vec = _residual_case(2, 64, 5, 7, dtype, cuda)
    if case == "misaligned":
        skip, h, vec = _residual_case(2, 64, 8, 8, dtype, cuda)
        buf = torch.empty(h.numel() + 1, dtype=h.dtype, device=cuda)
        buf[1:] = h.reshape(-1)
        h = buf[1:].view(h.shape)
        assert h.is_contiguous() and h.data_ptr() % 16
    elif case == "channels_of_12":
        skip, h, vec = _residual_case(2, 12, 3, 3, dtype, cuda)
    with torch.no_grad():
        before = residual_add.launches
        got = residual_add(skip, h, vec)
        assert residual_add.launches - before == 1
    assert got.is_contiguous() and torch.equal(got, residual_add_plain(skip, h, vec))


@pytest.mark.parametrize("case", ["channels_not_of_8", "mixed_layouts", "mixed_dtypes",
                                  "records_a_graph"])
def test_residual_kernel_raises_on_what_it_does_not_read(cuda, case):
    """No launch and no plain form on the card: channels-last with C no multiple of
    8, operands in two layouts or two dtypes raise ValueError; a graph for
    autograd to record raises RuntimeError (the kernel has no backward)."""
    cl = torch.channels_last
    skip, h, vec = _residual_case(2, 64, 8, 8, torch.bfloat16, cuda)
    error = ValueError
    if case == "channels_not_of_8":
        skip, h, vec = _residual_case(2, 12, 4, 4, torch.bfloat16, cuda, cl)
    elif case == "mixed_layouts":
        h = h.contiguous(memory_format=cl)
    elif case == "mixed_dtypes":
        skip = skip.float()
    elif case == "records_a_graph":
        h.requires_grad_(True)
        error = RuntimeError
    before = residual_add.launches
    with pytest.raises(error):
        residual_add(skip, h, vec)
    assert residual_add.launches == before


def _f16_decoder_pair(cuda, dtype, seed=11):
    """The f16-16384 VQGAN on the CPU (float32) and on the card (`dtype`) holding
    the same weights: init_random_ from a CPU generator, then norm scales 1 +
    N(0, 0.1), norm shifts and conv biases N(0, 0.1)."""
    from feed_forward_vqgan_clip_tpu_torch.registry import VQGAN_CONFIGS

    cfg = VQGAN_CONFIGS["vqgan_imagenet_f16_16384"]
    gen = torch.Generator().manual_seed(seed)
    cpu = make_vqgan(cfg).init_random_(gen)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, GroupNorm32):
                m.weight.add_(0.1 * torch.randn(m.weight.shape, generator=gen))
                m.bias.normal_(0.0, 0.1, generator=gen)
            elif isinstance(m, torch.nn.Conv2d):
                m.bias.normal_(0.0, 0.1, generator=gen)
    card = make_vqgan(cfg, dtype, device=cuda)
    card.load_state_dict(cpu.state_dict())
    return cpu.eval().requires_grad_(False), card.eval().requires_grad_(False), gen


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_f16_decoder_on_card_matches_cpu_and_launches_two_a_norm(cuda, dtype, tol):
    """The whole f16-16384 decoder (39 GroupNorms, a 4 x 4 latent) under no_grad:
    every norm on the kernel, two launches each, channels-last in and out as the
    convolutions hand it on; 41 of the decoder's 58 conv biases handed on, the 17
    ResnetBlocks' residual adds on their kernel; the image within `tol` of max
    |CPU| (the CPU's convs add their own biases)."""
    cpu, card, gen = _f16_decoder_pair(cuda, dtype)
    z = torch.randn(2, 4, 4, 256, generator=gen)
    norms = [m for m in card.modules() if isinstance(m, GroupNorm32)]
    assert len(norms) == 39
    layouts = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: layouts.append(
        (inp[0].is_contiguous(memory_format=torch.channels_last),
         out.is_contiguous(memory_format=torch.channels_last)))) for m in norms]
    with torch.no_grad():
        want = cpu.decode_latent(z)
        before = group_norm_silu.launches
        counts = (residual_add.launches, Decoder.folded, Decoder.library)
        got = card.decode_latent(z.to(cuda)).float().cpu()
        assert group_norm_silu.launches - before == 2 * len(norms)
        assert (residual_add.launches - counts[0], Decoder.folded - counts[1],
                Decoder.library - counts[2]) == (17, 41, 17)
    for h in hooks:
        h.remove()
    # the NHWC latent keeps cuDNN channels-last, and each norm keeps its input's layout
    assert layouts == [(True, True)] * len(norms)
    assert got.shape == (2, 64, 64, 3) and torch.isfinite(got).all()
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_f16_decoder_folded_matches_library_biases_on_card(cuda, dtype, tol, monkeypatch):
    """The card's decode with its conv biases handed on against the same decode
    with every bias added by the library's convs (hands_biases_on forced off),
    within `tol` of max |library|."""
    _, card, gen = _f16_decoder_pair(cuda, dtype, seed=12)
    z = torch.randn(2, 4, 4, 256, generator=gen).to(cuda)
    with torch.no_grad():
        folded = Decoder.folded
        got = card.decode_latent(z).float()
        assert Decoder.folded - folded == 41
        monkeypatch.setattr(Decoder, "hands_biases_on", lambda self, z: False)
        launches = residual_add.launches
        want = card.decode_latent(z).float()
        assert residual_add.launches == launches
    assert torch.isfinite(got).all() and _rel(got, want) <= tol


def test_train_step_takes_no_group_norm_kernel(cuda):
    """One step of the tiny train step: the decoder's input carries the mapper's
    gradient, so its norms take the plain form and the kernel launches 0 times;
    every conv keeps its bias and no residual kernel runs."""
    from feed_forward_vqgan_clip_tpu_torch import entry as entry_module

    tiny = dict(clip_model="tiny", dim=64, depth=2, vq_image_size=4, vqgan_arch=TINY_VQ)
    step_fn, state, batch = entry_module.train_entry(cuda, batch=2, cutn=2, mapper_config=tiny)
    before = group_norm_silu.launches
    counts = (residual_add.launches, Decoder.folded, Decoder.library)
    state, metrics = step_fn(state, batch, torch.Generator(cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert group_norm_silu.launches == before
    assert residual_add.launches == counts[0] and Decoder.folded == counts[1]
    assert Decoder.library > counts[2]
    assert np.isfinite(float(metrics["loss"]))

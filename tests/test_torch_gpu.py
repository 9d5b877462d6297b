"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. The file imports no
JAX, so it also runs where JAX is not installed; tests/conftest.py does import
JAX, so there run it without the conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider

Tolerances: VQ indices equal except at near-ties (plain top-2 score gap below
the fp32 bound 4*C*eps*(|x| max|c| + max|c|^2)), at least 99.9% agreement;
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
for bit. The pools' backward, the tiny trainer's steps and the plain-PyTorch
backwards of Et, Ts and R (no kernel of their own: a sorted fixed-order segment
sum and weight-matrix products) must repeat bit for bit. The dot-product test of
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
features within 1e-4 of the CPU's; the native BPE core built.
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
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import latent_bounds
from feed_forward_vqgan_clip_tpu_torch.models.clip_fused import encode_image_fused
from feed_forward_vqgan_clip_tpu_torch.models.clip_resnet import CLIPResNet
from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip_from_config
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
from feed_forward_vqgan_clip_tpu_torch.models.mappers.fused import (
    make_mapper_apply,
    make_mapper_train_apply,
    make_streamed_mixer_apply,
)
from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import Mixer
from feed_forward_vqgan_clip_tpu_torch.config import make_config
from feed_forward_vqgan_clip_tpu_torch.ops import augment, pooling
from feed_forward_vqgan_clip_tpu_torch.ops.kernels import mixer_stream as mixer_stream_module
from feed_forward_vqgan_clip_tpu_torch.ops.kernels import wgmma
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
    ChannelGrads,
    MixerBlockWeights,
    MixerResiduals,
    TokenGrads,
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
    """The stacked-weight mapper forward, float32: 2 rows through K4 (one
    launch), 9 rows through K5 (one launch per block), each within 1e-4 of the
    CPU plain versions."""
    mapper = _random_mapper(8, 64, 3, torch.float32, 6)
    cpu_apply = make_streamed_mixer_apply(mapper)
    card_apply = make_streamed_mixer_apply(copy.deepcopy(mapper).to(cuda))
    for rows, k4, k5 in ((2, 1, 0), (9, 0, 3)):
        x = torch.from_numpy(np.random.default_rng(rows).normal(size=(rows, 8)).astype(np.float32))
        counts = (mixer_stream.launches, mixer_block_stacked.launches)
        got = card_apply(x.to(cuda))
        assert (mixer_stream.launches, mixer_block_stacked.launches) == (
            counts[0] + k4, counts[1] + k5)
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
    vq0, mix0 = nearest_codebook_indices_kernel.launches, mixer_block.launches
    got = card.render(card.encode_tokens(toks.to(cuda))).cpu()
    assert nearest_codebook_indices_kernel.launches == vq0 + 1
    assert mixer_block.launches == mix0 + 2
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

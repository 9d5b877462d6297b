"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. The file imports no
JAX, so it also runs where JAX is not installed; tests/conftest.py does import
JAX, so there run it without the conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider

Tolerances: VQ indices equal except at near-ties (plain top-2 score gap below
the fp32 bound 4*C*eps*(|x| max|c| + max|c|^2)), at least 99.9% agreement;
the Mixer block f32 (TF32 off) within 1e-3 and bf16 within 3e-2 of max |plain|;
the tiny slice, f32, within 1e-3 of the CPU module path.
"""

import copy

import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu_torch.entry import example_tokens
from feed_forward_vqgan_clip_tpu_torch.infer import Generator, build_generator
from feed_forward_vqgan_clip_tpu_torch.models.mappers.mixer import Mixer
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
    mixer_block,
    mixer_block_plain,
)
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.vq_lookup import (
    nearest_codebook_indices_kernel,
    nearest_codebook_indices_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,k", [(1000, 16384), (77, 1000), (4096, 16384)])
def test_vq_kernel_matches_plain(cuda, n, k):
    gen = torch.Generator(device=cuda).manual_seed(n + k)
    x = torch.randn(n, 256, generator=gen, device=cuda)
    cb = torch.randn(k, 256, generator=gen, device=cuda)
    before = nearest_codebook_indices_kernel.launches
    got = nearest_codebook_indices_kernel(x, cb)
    assert nearest_codebook_indices_kernel.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n,)
    ref = nearest_codebook_indices_plain(x, cb)
    scores = cb.square().sum(-1)[None] - 2 * x @ cb.T
    top2 = scores.topk(2, dim=1, largest=False).values
    bound = 4 * 256 * torch.finfo(torch.float32).eps * (
        x.norm(dim=1) * cb.norm(dim=1).max() + cb.square().sum(-1).max())
    diff = got != ref
    assert diff.float().mean().item() <= 1e-3
    assert not (diff & (top2[:, 1] - top2[:, 0] >= bound)).any().item()


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


def test_slice_on_card_matches_cpu_module_path(cuda):
    vq = dict(n_embed=32, embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2),
              num_res_blocks=1, attn_resolutions=(4,), resolution=8)
    cpu = build_generator(clip_model="tiny", vqgan_config=vq, dim=64, depth=2,
                          vq_image_size=4, dtype=torch.float32, seed=0)
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

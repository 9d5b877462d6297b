"""The port's entry points, flagship geometry, random weights from a seed, bf16,
one device:

  * `entry`: the counterpart of `__graft_entry__.entry`, the prompt->image step
    (CLIP ViT-B/32 text encode -> MLP-Mixer 32x1024 mapper -> clamp ->
    straight-through VQ -> VQGAN f16-16384 decode -> [0, 1] image);
  * `train_entry`: the set-up of the JAX package's train bench
    (`bench.train_bench`), one train step of the mapper at B=8, cutn=8, 224-px
    cutouts, ViT-B/32 spherical loss, Adam with bf16 moments;
  * `dryrun_multichip`: the counterpart of `__graft_entry__.dryrun_multichip`,
    the whole trainer on n processes of one mesh (parallel/multiproc.py).
"""

from typing import Optional

import torch

from feed_forward_vqgan_clip_tpu_torch.config import make_config, vqgan_arch_config
from feed_forward_vqgan_clip_tpu_torch.infer import build_generator
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
from feed_forward_vqgan_clip_tpu_torch.ops.cutouts import MakeCutouts
from feed_forward_vqgan_clip_tpu_torch.train.loop import build_frozen, make_train_step
from feed_forward_vqgan_clip_tpu_torch.train.state import make_optimizer, make_train_state

SOT, EOT = 49406, 49407  # CLIP's start/end-of-text ids


def example_tokens(batch: int, device=None):
    """`[SOT, 320, EOT, 0, ...]` per row: the token ids `__graft_entry__` feeds."""
    tokens = torch.zeros(batch, 77, dtype=torch.long, device=device)
    tokens[:, 0], tokens[:, 1], tokens[:, 2] = SOT, 320, EOT
    return tokens


def entry(device="cuda", *, batch: int = 4, dtype=torch.bfloat16, seed: int = 0):
    """-> (prompt_to_image, (tokens,)): prompt_to_image(tokens) gives images
    (B, 256, 256, 3) float32 in [0, 1]. On the card the mapper runs the whole
    block stack in one kernel launch at batch <= 8 and one launch per block
    above (models/mappers/fused.py `mapper_route`)."""
    gen = build_generator(dtype=dtype, device=device, seed=seed)

    def prompt_to_image(tokens):
        return gen.render(gen.encode_tokens(tokens))

    return prompt_to_image, (example_tokens(batch, device),)


def train_entry(device="cuda", *, batch: int = 8, cutn: int = 8, seed: int = 0,
                mapper_config: Optional[dict] = None, fuse_geometric: bool = False,
                opt_dtype: str = "bfloat16"):
    """-> (step_fn, state, batch_dict): `step_fn(state, batch_dict, generator,
    mark=None)` runs one train step and returns (state, metrics).

    The geometry of `bench.train_bench`: CLIP ViT-B/32 (both towers, frozen),
    Mixer dim 1024 depth 32 over 16x16 tokens, noise_dim 0, dropout 0, VQGAN
    f16-16384 (frozen), bf16 compute with float32 master weights, Adam lr 1e-3
    with bf16 moments (`opt_dtype`), `cutn` 224-px pooled cutouts with additive noise, one
    text encode per step (same_io), tokens `[SOT, 0, EOT, 0...]`, and the
    default augmentations `Af`, `Pe`, `Ji`, `Er`. `mapper_config`: config keys
    that replace the flagship's (`model_type`, `dim`, `depth`, `vq_image_size`,
    `num_heads`, `clip_model`: another released mapper and its perceptor, whose
    input size the cutouts take). `fuse_geometric` and `opt_dtype` are the JAX
    bench's FFVC_BENCH_FUSE_AUGS and FFVC_BENCH_OPT_DTYPE: the cutouts' Af and
    Pe as one warp, and the dtype of Adam's moments."""
    dtype = torch.bfloat16
    cfg = make_config(**{**dict(clip_model="ViT-B/32", model_type="mlp_mixer", dim=1024,
                                depth=32, dropout=0, vq_image_size=16, noise_dim=0),
                         **(mapper_config or {}),
                         **dict(batch_size=batch, cutn=cutn, compute_dtype="bfloat16")})
    frozen = build_frozen(cfg, dtype, device=device, seed=seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    mapper = build_mapper(dict(cfg), vq_channels=int(vqgan_arch_config(cfg)["z_channels"]),
                          dtype=dtype, device=device)
    mapper.init_random_(gen)
    state = make_train_state(mapper.parameters(), make_optimizer(1e-3, opt_dtype=opt_dtype))
    size = frozen.perceptor.size  # 224 for ViT-B/32
    cutouts = MakeCutouts(cut_size=size, cutn=cutn, pool_size=size, fuse_geometric=fuse_geometric)
    step_fn, _ = make_train_step(cfg, mapper, frozen, cutouts, inp_is_tokens=True,
                                 out_is_tokens=True, same_io=True)
    tokens = torch.zeros(batch, 77, dtype=torch.long, device=device)
    tokens[:, 0], tokens[:, 2] = SOT, EOT
    return step_fn, state, {"inp": tokens, "out": tokens}


def dryrun_multichip(n_devices: int, *, device="cuda", timeout: float = 900) -> str:
    """The whole trainer, tiny, on `n_devices` processes of one process group,
    {data: n/2, model: 2} where n is even and at least 4, else {data: n}
    (parallel/multiproc.run_dryrun: equal parameters on every rank, files
    written by rank 0 alone, the in-train eval run); -> the run's folder. On
    CUDA the processes share the card through Gloo (FFVC_DIST_BACKEND=gloo),
    as NCCL refuses two ranks on one device."""
    from feed_forward_vqgan_clip_tpu_torch.parallel.multiproc import run_dryrun

    env = {"FFVC_DIST_BACKEND": "gloo"} if torch.device(device).type == "cuda" else None
    tmp = run_dryrun(n_devices, device=device, timeout=timeout, env=env)
    print(f"dryrun_multichip OK: {n_devices} processes, DP+TP train steps, identical "
          f"params on every rank ({tmp})")
    return tmp

"""The amortized VQGAN-CLIP trainer, on one device.

Port of feed_forward_vqgan_clip_tpu/train/loop.py. `make_train_step`: text
encode (frozen CLIP, no grad; once when the input and the target are the same
tokens, `same_io`) -> `repeat` tiling (+ noise concat when `noise_dim > 0`) ->
mapper (a Mixer through its train kernels on the card, the other families as
modules; with dropout > 0 the module path, masks from the step's generator) ->
clamp_with_grad -> straight-through VQ -> frozen VQGAN decode (-> with a
`diversity_coef`, frozen VGG16 features of the CLIP-normalised renders and the
diversity term) -> cutouts with augmentations in `aug_dtype` -> CLIP
normalisation -> frozen CLIP image encode (the fused tower of
models/clip_fused.py where FFVC_FUSED_CLIP asks for it) -> spherical loss
against the cutn-major tiled targets (+ input, L2 and TV terms, - the diversity
term) -> backward -> Adam -> EMA. Loss parity with the reference's `train`,
term by term.

`train(cfg)` is the host loop around it: per-epoch batches, noise-bank rows
keyed on (seed, step), a per-step torch.Generator seeded from (seed, step) (the
counterpart of `fold_in(root_key, step)`), the device-side loss EMA and the
per-log-interval scalar flush, previews, in-train eval, TensorBoard / wandb,
checkpoints in the reference's layout (io/checkpoint.py) written by a background
thread, and a resume that skips the batches already consumed, so an interrupted
and resumed run repeats the uninterrupted one. The mesh, multi-process and
tensor-parallel paths wait for ROADMAP A12.
"""

import contextlib
import copy
import logging
import os
import threading
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from feed_forward_vqgan_clip_tpu_torch.config import (
    COMPUTE_DTYPES,
    TrainConfig,
    dtype_of,
    resolved_clip_geometry,
    vqgan_arch_config,
)
from feed_forward_vqgan_clip_tpu_torch.data.datasets import epoch_shard_batches, load_dataset
from feed_forward_vqgan_clip_tpu_torch.io import checkpoint as ckpt_io
from feed_forward_vqgan_clip_tpu_torch.io.images import save_grid
from feed_forward_vqgan_clip_tpu_torch.models.clip_fused import make_clip_image_apply
from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
from feed_forward_vqgan_clip_tpu_torch.models.mappers.fused import (
    make_mapper_apply,
    make_mapper_train_apply,
)
from feed_forward_vqgan_clip_tpu_torch.models.perceptor import Perceptor, load_perceptor
from feed_forward_vqgan_clip_tpu_torch.models.vgg import VGG16Features, load_vgg16
from feed_forward_vqgan_clip_tpu_torch.models.vqgan import VQGAN, latent_bounds, load_vqgan, synth
from feed_forward_vqgan_clip_tpu_torch.ops.augment import resize_bilinear
from feed_forward_vqgan_clip_tpu_torch.ops.cutouts import MakeCutouts
from feed_forward_vqgan_clip_tpu_torch.ops.grad_ops import clamp_with_grad
from feed_forward_vqgan_clip_tpu_torch.ops.losses import (
    diversity_loss,
    l2_loss,
    normalize,
    spherical_dist,
    spherical_dist_loss,
    tv_loss,
)
from feed_forward_vqgan_clip_tpu_torch.registry import CLIP_MEAN, CLIP_STD
from feed_forward_vqgan_clip_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
    make_train_state,
)

log = logging.getLogger(__name__)

# the stages a step reports to its `mark` callback, in order
STAGES = ("text", "mapper", "decode", "diversity", "cutouts", "image_tower", "loss",
          "backward", "adam")
PROFILE_STEPS = (10, 15)  # the torch.profiler window of `profile_dir`


class FrozenModels(NamedTuple):
    """The frozen perceptor (both CLIP towers), VQGAN, for in-train eval with an
    `eval_clip_model` the eval perceptor, and for the diversity term the VGG16
    features."""

    perceptor: Perceptor
    vq: VQGAN
    eval_perceptor: Optional[Perceptor] = None
    vgg: Optional[VGG16Features] = None


def build_frozen(cfg: TrainConfig, dtype, *, device="cuda", seed: int = 0) -> FrozenModels:
    """The frozen models: the weights at the config's `clip_model_path`,
    `vqgan_checkpoint`, `eval_clip_model_path` and (with a `diversity_coef`)
    `vgg_path`, else random from `seed` (the VGG16 from seed + 1, as JAX draws it
    from PRNGKey(1)); their parameters do not require grad."""
    perceptor = load_perceptor(cfg.get("clip_model"), cfg.get("clip_model_path"), dtype=dtype,
                               device=device, seed=seed)
    eval_p = None
    if cfg.get("eval_path") and cfg.get("eval_clip_model"):
        eval_p = load_perceptor(cfg.get("eval_clip_model"), cfg.get("eval_clip_model_path"),
                                dtype=dtype, device=device, seed=seed)
    vgg = None
    if cfg.get("diversity_coef"):
        vgg = load_vgg16(cfg.get("vgg_path"), dtype=dtype, device=device, seed=seed + 1)
    return FrozenModels(perceptor, load_vqgan(cfg, dtype, device=device, seed=seed), eval_p,
                        vgg)


def make_train_step(cfg: TrainConfig, mapper, frozen: FrozenModels, make_cutouts: MakeCutouts,
                    *, inp_is_tokens: bool, out_is_tokens: bool, same_io: bool = False):
    """-> (train_step, loss_fn).

    loss_fn(batch, generator, mark=None) -> (loss, metrics), differentiable in the
    mapper's parameters; train_step(state, batch, generator, mark=None) ->
    (state, metrics) runs it, the backward and Adam, updating `state` in place.
    `batch` holds "inp" and "out" (token ids (B, 77) or features (B, dim)) and
    optionally "noise" (repeat, noise_dim) bank rows. `mark(stage)`, where given,
    is called as each stage of STAGES has been enqueued (for per-stage timing).
    Metrics are 0-d tensors on the device: loss, dists, diversity, l2, tv."""
    repeat = int(cfg.get("repeat"))
    cutn = int(cfg.get("cutn"))
    noise_dim = int(cfg.get("noise_dim") or 0)
    normalize_input = bool(cfg.get("normalize_input"))
    input_loss = bool(cfg.get("input_loss"))
    input_loss_coef = float(cfg.get("input_loss_coef"))
    target_loss_coef = float(cfg.get("target_loss_coef"))
    l2_coef = float(cfg.get("l2_coef"))
    tv_coef = float(cfg.get("tv_coef"))
    diversity_coef = float(cfg.get("diversity_coef"))
    diversity_mode = cfg.get("diversity_mode")
    if diversity_coef and frozen.vgg is None:
        raise ValueError("diversity_coef needs the frozen VGG16 (build_frozen builds it)")
    dropout = float(cfg.get("dropout") or 0.0)
    aug_dtype = COMPUTE_DTYPES[str(cfg.get("aug_dtype") or cfg.get("compute_dtype"))]
    perceptor, vq = frozen.perceptor, frozen.vq
    mapper_train_apply = make_mapper_train_apply(mapper)
    # the image encode of the cutouts: the module path unless FFVC_FUSED_CLIP=1
    # routes it through the K11 sublayers (models/clip_fused.py)
    clip_image_apply = make_clip_image_apply(perceptor.module)

    def loss_fn(batch, generator: torch.Generator, mark: Optional[Callable] = None):
        mark = mark or (lambda stage: None)
        z_lo, z_hi = latent_bounds(vq)
        inp, out = batch["inp"], batch["out"]
        bs = inp.shape[0]
        dev = inp.device
        inp_feats = perceptor.encode_text(inp).float() if inp_is_tokens else inp.float()
        # text-only datasets feed the same tokens as input and target: encode once
        if same_io:
            out_feats = inp_feats
        elif out_is_tokens:
            out_feats = perceptor.encode_text(out).float()
        else:
            out_feats = out.float()
        if normalize_input:
            inp_feats = normalize(inp_feats)
        mark("text")
        # (repeat*bs, dim), repeat-major
        inp_feats = inp_feats.repeat(repeat, 1)
        out_feats = out_feats.repeat(repeat, 1)
        if noise_dim:
            if "noise" in batch:  # fixed bank rows (repeat, noise_dim)
                noise = batch["noise"].repeat_interleave(bs, dim=0)
            else:
                noise = torch.randn(repeat * bs, noise_dim, generator=generator, device=dev)
            net_in = torch.cat([inp_feats, noise.to(inp_feats.dtype)], dim=1)
        else:
            net_in = inp_feats
        if dropout > 0:  # the module path, its masks drawn from the step's generator
            z = mapper(net_in, generator)
        else:
            z = mapper_train_apply(net_in)  # (repeat*bs, S, S, C)
        l2 = l2_loss(z) if l2_coef > 0 else torch.zeros((), device=dev)
        mark("mapper")
        # float32: JAX's clip promotes the compute-dtype latent against f32 bounds
        z = clamp_with_grad(z.float(), z_lo, z_hi)
        xr = synth(vq, z).float()  # (repeat*bs, H, W, 3)
        tv = tv_loss(xr) if tv_coef > 0 else torch.zeros((), device=dev)
        mark("decode")
        mean = torch.tensor(CLIP_MEAN, device=dev)
        std = torch.tensor(CLIP_STD, device=dev)
        if diversity_coef:
            feats = frozen.vgg((xr - mean) / std)
            div = diversity_loss([f.float() for f in feats], repeat, bs, diversity_mode)
        else:
            div = torch.zeros((), device=dev)
        mark("diversity")
        x = make_cutouts(generator, xr.to(aug_dtype))  # (cutn*repeat*bs, h, w, 3)
        x = (x - mean.to(aug_dtype)) / std.to(aug_dtype)
        mark("cutouts")
        embed = normalize(clip_image_apply(x).float())
        mark("image_tower")
        h = normalize(out_feats.repeat(cutn, 1))  # (cutn*repeat*bs, dim), cutn-major
        dists = target_loss_coef * spherical_dist_loss(h, embed)
        if input_loss:
            hi = normalize(inp_feats.repeat(cutn, 1))
            dists = dists + input_loss_coef * spherical_dist_loss(hi, embed)
        loss = dists - diversity_coef * div + l2_coef * l2 + tv_coef * tv
        mark("loss")
        metrics = {"loss": loss, "dists": dists, "diversity": div, "l2": l2, "tv": tv}
        return loss, {k: v.detach().float() for k, v in metrics.items()}

    def train_step(state: TrainState, batch, generator: torch.Generator,
                   mark: Optional[Callable] = None):
        mark = mark or (lambda stage: None)
        for p in state.params:
            p.grad = None
        loss, metrics = loss_fn(batch, generator, mark)
        loss.backward()
        mark("backward")
        state.apply_gradients()
        # the loss EMA stays on the device: no host sync per step
        state.avg_loss = metrics["loss"] * 0.01 + state.avg_loss * 0.99
        mark("adam")
        return state, metrics

    return train_step, loss_fn


def make_render_fn(frozen: FrozenModels):
    """Images for the previews: render(mapper, net_in) -> (N, H, W, 3) float32 in
    [0, 1], the mapper's deterministic forward (its current parameters through
    the Mixer-block kernel on the card), clamp, synth; no cutouts."""
    vq = frozen.vq

    @torch.no_grad()
    def render(mapper, net_in):
        z_lo, z_hi = latent_bounds(vq)
        z = make_mapper_apply(mapper)(net_in)
        return synth(vq, clamp_with_grad(z.float(), z_lo, z_hi)).float()

    return render


def make_eval_step(frozen: FrozenModels, eval_p: Perceptor):
    """In-train eval: eval_step(mapper, feats) -> (dists, scores) per row: no
    cutouts, bilinear resize to the eval perceptor's size, its spherical distance
    and its CLIP score (logit scale)."""
    clip_size = eval_p.size
    vq = frozen.vq

    @torch.no_grad()
    def eval_step(mapper, feats):
        z_lo, z_hi = latent_bounds(vq)
        z = make_mapper_apply(mapper)(feats)
        xr = resize_bilinear(synth(vq, clamp_with_grad(z.float(), z_lo, z_hi)).float(),
                             clip_size)
        mean = torch.tensor(CLIP_MEAN, device=xr.device)
        std = torch.tensor(CLIP_STD, device=xr.device)
        embed = normalize(eval_p.encode_image((xr - mean) / std).float())
        h = normalize(feats[:, : embed.shape[1]].float())
        scores = eval_p.logit_scale * (h * embed).sum(1)
        return spherical_dist(h, embed), scores

    return eval_step


def _run_eval(eval_step, mapper, eval_data, eval_p: Perceptor, bs: int, noise_dim: int,
              device):
    """Mean eval distance and CLIP score over `eval_data` in batches of `bs` (the
    last one padded by wrap-around, its padding dropped), noise columns zero."""
    data = np.asarray(eval_data if not isinstance(eval_data, tuple) else eval_data[0])
    dists_all, scores_all = [], []
    for i in range(0, len(data), bs):
        chunk = data[i: i + bs]
        valid = len(chunk)
        if valid < bs:
            chunk = np.resize(np.concatenate([chunk, data]), (bs,) + data.shape[1:])
        if np.issubdtype(chunk.dtype, np.integer):
            feats = eval_p.encode_text(torch.as_tensor(chunk, dtype=torch.long, device=device))
        else:
            feats = torch.as_tensor(chunk, dtype=torch.float32, device=device)
        feats = feats.float()
        if noise_dim:
            feats = torch.cat([feats, feats.new_zeros(len(feats), noise_dim)], dim=1)
        d, s = eval_step(mapper, feats)
        dists_all.append(d.cpu().numpy()[:valid])
        scores_all.append(s.cpu().numpy()[:valid])
    return float(np.concatenate(dists_all).mean()), float(np.concatenate(scores_all).mean())


def _features_for(frozen: FrozenModels, inp, inp_is_tokens: bool, cfg: TrainConfig):
    feats = frozen.perceptor.encode_text(inp) if inp_is_tokens else inp
    if cfg.get("normalize_input"):
        feats = normalize(feats.float())
    return feats.float()


def _make_token_decoder():
    """The tokenizer's decode, or None where no BPE table is found."""
    try:
        from feed_forward_vqgan_clip_tpu_torch.tokenizer.bpe import get_tokenizer

        return get_tokenizer().decode
    except FileNotFoundError:
        return None


def noise_bank_rows(seed: int, step: int, bank_size: int, repeat: int) -> np.ndarray:
    """The bank rows of step `step`: the first `repeat` of a permutation drawn
    from an rng keyed on (seed, step), so a resumed run draws the uninterrupted
    run's rows."""
    return np.random.default_rng((seed, step)).permutation(bank_size)[:repeat]


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step `step` (augmentations, noise factors, dropout masks,
    noise rows without a bank), seeded from (seed, step) alone."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))


class _AsyncSaver:
    """Single-slot background checkpoint writer: at most one write in flight;
    submit() joins the previous write first and re-raises its error, wait()
    joins the last one (called before the loop returns)."""

    def __init__(self):
        self._t = None
        self._err = None

    def submit(self, fn):
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:  # surfaced at the next submit or wait
                self._err = e

        self._t = threading.Thread(target=run, daemon=True, name="ffvc-ckpt-writer")
        self._t.start()

    def wait(self):
        if self._t is not None:
            self._t.join()
            self._t = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def _host_copy(state_dict):
    """A CPU copy of every tensor, finished before it returns (the state is
    updated in place by the next step)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in state_dict.items()}


def _save_all(folder, cfg, state: TrainState, mapper, ema_mapper, names, epoch, noise_bank,
              saver: Optional[_AsyncSaver] = None):
    """Checkpoint the mapper, its EMA and Adam (io/checkpoint.py's layout). The
    device->host copies are made here, synchronously; with `saver` the file
    writes run on its thread. The stored step is state.step, the number of
    updates in the saved parameters."""
    step = int(state.step)
    params = _host_copy(mapper.state_dict())
    ema = _host_copy(ema_mapper.state_dict()) if ema_mapper is not None else None
    opt = state.opt_state
    opt = type(opt)(opt.count, [m.detach().to("cpu", copy=True) for m in opt.mu],
                    [v.detach().to("cpu", copy=True) for v in opt.nu])
    config = dict(cfg)

    def write():
        ckpt_io.save_optimizer(folder, names, opt, step)
        if ema is not None:
            ckpt_io.save_checkpoint(folder, "checkpoint_ema", ema, config, step, epoch,
                                    noise_bank)
        # last: checkpoint.th is the commit point of a resume
        ckpt_io.save_checkpoint(folder, "checkpoint", params, config, step, epoch, noise_bank)

    if saver is not None:
        saver.submit(write)
    else:
        write()


def _log_step_artifacts(cfg, folder, mapper, ema_mapper, frozen, state, batch, render, step,
                        epoch, noise_bank, decode_tokens, fixed_inp, noise_dim, inp_is_tokens,
                        names, saver=None):
    """The log step's previews, prompt sidecars and checkpoints: progress.png
    (the step's batch, current parameters), progress.txt, fixed_batch_progress.png
    (the first batch, EMA parameters where kept) and fixed_batch.txt at step 0."""
    bs, repeat = int(cfg.get("batch_size")), int(cfg.get("repeat"))
    dev = batch["inp"].device
    net_in = _features_for(frozen, batch["inp"], inp_is_tokens, cfg).repeat(repeat, 1)
    if noise_dim:
        if "noise" in batch:
            noise = batch["noise"].repeat_interleave(net_in.shape[0] // len(batch["noise"]), 0)
        else:
            noise = torch.randn(net_in.shape[0], noise_dim, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(step))
        net_in = torch.cat([net_in, noise.to(net_in.dtype)], dim=1)
    xr = render(mapper, net_in).cpu().numpy()
    save_grid(xr, os.path.join(folder, "progress.png"), nrow=bs)
    save_grid(xr, os.path.join(folder, f"progress_{step:010d}.png"), nrow=bs)
    if inp_is_tokens and decode_tokens is not None:
        text = "\n".join(decode_tokens(t) for t in batch["inp"].cpu().numpy())
        for name in ("progress.txt", f"progress_{step:010d}.txt"):
            with open(os.path.join(folder, name), "w") as fd:
                fd.write(text)

    _save_all(folder, cfg, state, mapper, ema_mapper, names, epoch, noise_bank, saver)

    net_in = _features_for(frozen, fixed_inp, inp_is_tokens, cfg)
    if noise_dim:
        n = net_in.shape[0]
        if noise_bank is not None and len(noise_bank) >= n:
            nz = torch.as_tensor(noise_bank[:n], device=dev)
        else:
            nz = torch.randn(n, noise_dim, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(0))
        net_in = torch.cat([net_in, nz.to(net_in.dtype)], dim=1)
    xf = render(ema_mapper if ema_mapper is not None else mapper, net_in).cpu().numpy()
    save_grid(xf, os.path.join(folder, "fixed_batch_progress.png"), nrow=bs)
    save_grid(xf, os.path.join(folder, f"fixed_batch_progress_{step:010d}.png"), nrow=bs)
    if step == 0 and inp_is_tokens and decode_tokens is not None:
        with open(os.path.join(folder, "fixed_batch.txt"), "w") as fd:
            fd.write("\n".join(decode_tokens(t) for t in fixed_inp.cpu().numpy()))


def _as_rows(rows: np.ndarray, device):
    """Dataset rows as a tensor on `device`: token ids as int64, features float32."""
    if np.issubdtype(rows.dtype, np.integer):
        return torch.as_tensor(rows.astype(np.int64), device=device)
    return torch.as_tensor(rows.astype(np.float32), device=device)


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN restricted to its deterministic algorithms while the block runs,
    restored after: at some shapes its default backward algorithms add with
    atomics (the tiny decoder of tests/test_torch_gpu.py's trainer test)."""
    cudnn = torch.backends.cudnn
    old = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = old


def train(cfg: TrainConfig, *, device="cuda") -> TrainState:
    """Train a mapper from `cfg` (load_config / make_config) in `cfg.folder`,
    resuming from the checkpoints there; -> the final TrainState. Runs on the
    card unless `device` says otherwise. Every sum of the step runs in a fixed
    order (the kernels, the matmul pools, cuDNN's deterministic algorithms), so
    a resumed run repeats the uninterrupted one bit for bit."""
    with deterministic_convolutions():
        return _train(cfg, device=device)


def _train(cfg: TrainConfig, *, device) -> TrainState:  # noqa: C901 - one loop, as JAX's
    if cfg.get("mesh_shape"):
        raise NotImplementedError("mesh_shape: multi-device training is ROADMAP A12")
    dtype = dtype_of(cfg)
    folder = cfg.get("folder") or "."
    os.makedirs(folder, exist_ok=True)
    seed = int(cfg.get("seed") or 0)

    # ---- data
    data = load_dataset(cfg.get("path"))
    if isinstance(data, tuple):
        inp_all, out_all = np.asarray(data[0]), np.asarray(data[1])
    else:
        inp_all = out_all = np.asarray(data)
    inp_is_tokens = np.issubdtype(inp_all.dtype, np.integer)
    out_is_tokens = np.issubdtype(out_all.dtype, np.integer)
    same_io = inp_all is out_all  # text-only dataset: one text encode per step
    log.info("Number of examples: %d", len(inp_all))

    # ---- frozen models, mapper, EMA, optimizer
    frozen = build_frozen(cfg, dtype, device=device, seed=seed)
    clip_size, _ = resolved_clip_geometry(cfg)
    mapper = build_mapper(dict(cfg), vq_channels=int(vqgan_arch_config(cfg)["z_channels"]),
                          dtype=dtype, device=device)
    noise_dim = int(cfg.get("noise_dim") or 0)
    nb_noise = cfg.get("nb_noise")
    epoch0, step, noise_bank, ema_sd = 0, 0, None, None
    resumed = ckpt_io.checkpoint_exists(folder)
    if resumed:
        sd, _, step, epoch0, noise = ckpt_io.load_checkpoint(ckpt_io.checkpoint_path(folder))
        mapper.load_state_dict(sd)
        noise_bank = noise.numpy() if noise is not None else None
        log.info("Resuming model from %s (step %d, epoch %d)", folder, step, epoch0)
        if ckpt_io.checkpoint_exists(folder, "checkpoint_ema"):
            ema_sd = ckpt_io.load_checkpoint(ckpt_io.checkpoint_path(folder, "checkpoint_ema"))[0]
    else:
        mapper.init_random_(torch.Generator(device=device).manual_seed(seed))
    if noise_dim and nb_noise and noise_bank is None:
        # the fixed noise bank, stored with every checkpoint
        noise_bank = np.random.default_rng((seed, 1)).standard_normal(
            (int(nb_noise), noise_dim)).astype(np.float32)
    names = [n for n, _ in mapper.named_parameters()]
    ema_mapper = None
    if cfg.get("use_ema"):
        ema_mapper = copy.deepcopy(mapper).requires_grad_(False)
        if ema_sd is not None:
            ema_mapper.load_state_dict(ema_sd)
    tx = make_optimizer(float(cfg.get("lr")), scheduler=cfg.get("scheduler"),
                        max_steps=cfg.get("max_steps"), clip_grad_norm=cfg.get("clip_grad_norm"),
                        opt_dtype=cfg.get("opt_dtype"))
    state = make_train_state(
        mapper.parameters(), tx, use_ema=ema_mapper is not None,
        ema_decay=float(cfg.get("ema_decay")), ema_warmup=bool(cfg.get("ema_warmup", True)),
        step=step, ema_params=list(ema_mapper.parameters()) if ema_mapper is not None else None)
    opt = ckpt_io.load_optimizer(folder) if resumed else None
    if opt is not None and opt["step"] != step:
        log.warning("opt.th holds step %d, checkpoint.th step %d: Adam starts afresh",
                    opt["step"], step)
    elif opt is not None:
        log.info("Resuming optimizer state from %s", folder)
        state.opt_state.count = int(opt["count"])
        for n, m, v in zip(names, state.opt_state.mu, state.opt_state.nu):
            m.copy_(opt["mu"][n])
            v.copy_(opt["nu"][n])

    make_cutouts = MakeCutouts(
        cut_size=int(cfg.get("cut_size") or clip_size), cutn=int(cfg.get("cutn")),
        augs=cfg.get("augs"), pool=bool(cfg.get("pool", True)),
        pool_size=int(cfg.get("pool_size") or clip_size),
        interpolate=bool(cfg.get("interpolate")),
        interp_size=int(cfg.get("interp_size") or clip_size),
        noise_fac=float(cfg.get("noise_fac")), fuse_geometric=bool(cfg.get("fuse_geometric")))
    train_step, _ = make_train_step(cfg, mapper, frozen, make_cutouts,
                                    inp_is_tokens=inp_is_tokens, out_is_tokens=out_is_tokens,
                                    same_io=same_io)
    render = make_render_fn(frozen)
    eval_data = None
    if cfg.get("eval_path"):
        eval_data = load_dataset(cfg.get("eval_path"))
        eval_p = frozen.eval_perceptor or frozen.perceptor
        eval_step = make_eval_step(frozen, eval_p)

    writer = None
    try:
        from torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter(folder)
    except Exception as e:  # pragma: no cover
        log.warning("TensorBoard writer unavailable: %s", e)
    use_wandb = bool(cfg.get("use_wandb"))
    wandb_run = None
    if use_wandb:
        try:
            import wandb

            wandb_run = wandb.init(project=cfg.get("wandb_project"),
                                   entity=cfg.get("wandb_entity"), resume=False, config=dict(cfg))
        except Exception as e:  # pragma: no cover
            log.warning("wandb unavailable: %s", e)
            use_wandb = False

    bs = int(cfg.get("batch_size"))
    repeat = int(cfg.get("repeat"))
    log_interval = int(cfg.get("log_interval"))
    max_steps = cfg.get("max_steps")
    epochs = int(cfg.get("epochs"))
    n_examples = len(inp_all)

    def epoch_ids(epoch):
        return epoch_shard_batches(n_examples, bs, seed=seed, epoch=epoch)

    def batch_for(ids, step_):
        b_inp = _as_rows(inp_all[ids], device)
        b = {"inp": b_inp, "out": b_inp if same_io else _as_rows(out_all[ids], device)}
        if noise_dim and nb_noise is not None and noise_bank is not None:
            rows = noise_bank_rows(seed, step_, len(noise_bank), repeat)
            b["noise"] = torch.as_tensor(noise_bank[rows], device=device)
        return b

    fixed_inp = _as_rows(inp_all[epoch_ids(epoch0)[0]], device)  # the fixed preview batch
    decode_tokens = _make_token_decoder() if inp_is_tokens else None
    profile_dir = cfg.get("profile_dir")
    profiler = None

    # every step's scalars stay on the device; a log step fetches the window at once
    wandb_log_interval = int(cfg.get("wandb_log_interval") or 1)
    pending: list = []  # [(step, metrics of 0-d device tensors)]

    def flush_scalars():
        if not pending:
            return {}
        steps_ = [s for s, _ in pending]
        stacked = {k: torch.stack([m[k] for _, m in pending]).float().cpu().numpy()
                   for k in pending[0][1]}
        if writer:
            for i, s in enumerate(steps_):
                for k, vals in stacked.items():
                    writer.add_scalar(k, float(vals[i]), s)
        if use_wandb and wandb_run:
            for i, s in enumerate(steps_):
                if s % wandb_log_interval == 0 and s != steps_[-1]:
                    wandb_run.log({k: float(vals[i]) for k, vals in stacked.items()}, step=s)
        pending.clear()
        return {k: float(vals[-1]) for k, vals in stacked.items()}

    def save_final(epoch):
        flush_scalars()
        _save_all(folder, cfg, state, mapper, ema_mapper, names, epoch, noise_bank, saver)
        saver.wait()  # the files are complete before train returns
        if writer:
            writer.close()

    t_start = time.time()
    saver = _AsyncSaver()
    for epoch in range(epoch0, epochs):
        epoch_batches = epoch_ids(epoch)
        # every epoch has the same batch count: on resume, skip the batches this
        # epoch consumed before the checkpoint
        done_here = step - epoch * len(epoch_batches)
        for ids in epoch_batches[max(done_here, 0):]:
            if profile_dir and step == PROFILE_STEPS[0]:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if torch.device(device).type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            batch = batch_for(ids, step)
            state, metrics = train_step(state, batch, step_generator(seed, step, device))
            pending.append((step, metrics))
            if profiler is not None and step == PROFILE_STEPS[1]:
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize(device)
                profiler.stop()
                os.makedirs(profile_dir, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
                profiler = None
                log.info("Wrote profiler trace to %s", profile_dir)

            if step % log_interval == 0:
                m = flush_scalars()
                avg_loss = float(state.avg_loss)
                print(f"epoch:{epoch:03d}, step:{step:05d}, avg_loss:{avg_loss:.3f}, "
                      f"loss:{m['loss']:.3f}, dists:{m['dists']:.3f}, "
                      f"div:{m['diversity']:.3f}, l2:{m['l2']:.3f} tv:{m['tv']}", flush=True)
                _log_step_artifacts(cfg, folder, mapper, ema_mapper, frozen, state, batch,
                                    render, step, epoch, noise_bank, decode_tokens, fixed_inp,
                                    noise_dim, inp_is_tokens, names, saver)
                if eval_data is not None:
                    ed, es = _run_eval(eval_step, mapper, eval_data, eval_p, bs, noise_dim,
                                       device)
                    print(f"Eval dists: {ed:.3f}\nEval clip score: {es:.3f}", flush=True)
                    if writer:
                        writer.add_scalar("eval_dists", ed, step)
                        writer.add_scalar("eval_clip_score", es, step)
                if use_wandb and wandb_run:
                    payload = dict(m, avg_loss=avg_loss)
                    try:
                        import wandb as _wandb

                        payload["image"] = [_wandb.Image(os.path.join(folder, "progress.png"))]
                        payload["image_fixed"] = [_wandb.Image(
                            os.path.join(folder, "fixed_batch_progress.png"))]
                    except Exception:  # pragma: no cover
                        pass
                    wandb_run.log(payload, step=step)

            step += 1
            if max_steps is not None and step >= int(max_steps):
                save_final(epoch)
                log.info("Reached max_steps=%s in %.1fs", max_steps, time.time() - t_start)
                return state
    save_final(max(epochs - 1, epoch0))
    return state

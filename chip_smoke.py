#!/usr/bin/env python3
"""Drive the PyTorch port's prompt->image path once on one NVIDIA GPU, in phases.

    python3 chip_smoke.py

1. Device: needs torch.cuda.is_available(); prints the card's name and power
   limit (nvidia-smi), torch and CUDA versions, and whether triton imports.
2. Build: compiles csrc/*.cu with nvcc for sm_90a (ops/kernels/build.py).
3. VQ kernel against its plain version on the card (stated near-tie rule).
4. Mixer-block kernel against its plain version, float32 (TF32 off) and bf16.
5. Kernel and plain times at the flagship shapes, CUDA events.
6. The slice: the flagship generator (CLIP ViT-B/32 text tower, Mixer 32x1024,
   VQGAN f16-16384, bf16, random weights from a seed) answers requests of
   batch 1, 4 and 16; the kernels' launch counters must rise; one PNG grid.
7. Prints the kernels' JSON line, then `{"ok": true, "device": {...}}` last.

Any failed check raises, so the script exits nonzero before the last line. It
imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

# f32 tolerances are ceilings relative to the reference's largest magnitude
MIXER_F32_TOL = 1e-3
MIXER_BF16_TOL = 3e-2
VQ_MIN_AGREEMENT = 0.999
REQUEST_BATCHES = (1, 4, 16)
SEED = 0


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds of fn() over `iters` launches, CUDA events, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn)
    k1 = cuda_ms(kernel_fn)
    k2 = cuda_ms(kernel_fn)
    p2 = cuda_ms(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke needs a GPU")
    smi = nvidia_smi_line()
    try:
        import triton  # noqa: F401

        has_triton = f"yes ({triton.__version__})"
    except ImportError:
        has_triton = "no"
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
        f"triton {has_triton}, devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    log(f"[build] {build.library_path().name} built (or found) and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in (build.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def _vq_case(n, k, c, gen, tie=False):
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.vq_lookup import (
        nearest_codebook_indices_kernel,
        nearest_codebook_indices_plain,
    )

    dev = "cuda"
    x = torch.randn(n, c, generator=gen, device=dev)
    cb = torch.randn(k, c, generator=gen, device=dev)
    if tie:  # duplicated halves: every winner must be the lower copy
        cb[k // 2:] = cb[: k // 2]
    got = nearest_codebook_indices_kernel(x, cb).long()
    torch.cuda.synchronize()
    ref = nearest_codebook_indices_plain(x, cb).long()
    # float64 scores of both choices, and the plain version's own top-2 gap
    x64, cb64 = x.double(), cb.double()
    s64 = (cb64.square().sum(-1)[None, :] - 2.0 * x64 @ cb64.T)
    s_got = s64.gather(1, got[:, None])[:, 0]
    s_ref = s64.gather(1, ref[:, None])[:, 0]
    scores32 = cb.square().sum(-1)[None, :] - 2.0 * (x @ cb.T)
    top2 = scores32.topk(2, dim=1, largest=False).values
    gap = top2[:, 1] - top2[:, 0]
    # near-tie bound: fp32 error of |c|^2 - 2 x.c, 2*2*C*eps*(|x||c|max + max|c|^2)
    eps = torch.finfo(torch.float32).eps
    bound = 4 * c * eps * (x.norm(dim=1) * cb.norm(dim=1).max() + cb.square().sum(-1).max())
    diff = got != ref
    agree = 1.0 - diff.float().mean().item()
    bad = diff & (gap >= bound)
    max_err = (s_got - s_ref).abs().max().item()
    ok = agree >= VQ_MIN_AGREEMENT and not bad.any().item() and got.min() >= 0 and got.max() < k
    if tie:
        ok = ok and bool((got < k // 2).all().item())
    log(f"[vq] N={n} K={k} C={c}{' tie' if tie else ''}: agreement {agree:.6f}, "
        f"{int(diff.sum())} flips (all near-ties: {not bad.any().item()}), "
        f"max |score(kernel) - score(plain)| {max_err:.3e}")
    if not ok:
        raise AssertionError(f"vq kernel disagrees with plain at N={n} K={k} tie={tie}")
    return max_err


def phase_vq(gen):
    errs = [
        _vq_case(1024, 16384, 256, gen),
        _vq_case(1000, 16384, 256, gen),
        _vq_case(1000, 1000, 256, gen),
        _vq_case(300, 2048, 256, gen, tie=True),
    ]
    return max(errs)


def random_block_weights(t, d, dtype, gen):
    """One Mixer block's kernel weights, random at lecun scales, on the card."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import MixerBlockWeights

    et, ec = 4 * t, 4 * d

    def n(*shape, std):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    return MixerBlockWeights(
        ln1_w=1 + n(d, std=0.1), ln1_b=n(d, std=0.1),
        t1=n(et, t, std=t ** -0.5).to(dtype), t1b=n(et, std=0.1),
        t2=n(t, et, std=et ** -0.5).to(dtype), t2b=n(t, std=0.1),
        ln2_w=1 + n(d, std=0.1), ln2_b=n(d, std=0.1),
        w1=n(ec, d, std=d ** -0.5).to(dtype), b1=n(ec, std=0.1),
        w2=n(d, ec, std=ec ** -0.5).to(dtype), b2=n(d, std=0.1),
    )


def phase_mixer(gen):
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
        mixer_block,
        mixer_block_plain,
    )

    worst_bf16 = 0.0
    for (b, t, d) in ((4, 256, 1024), (3, 64, 96), (2, 50, 100)):
        for dtype, tol in ((torch.float32, MIXER_F32_TOL), (torch.bfloat16, MIXER_BF16_TOL)):
            w = random_block_weights(t, d, dtype, gen)
            x = torch.randn(b, t, d, generator=gen, device="cuda").to(dtype)
            got = mixer_block(x, w)
            torch.cuda.synchronize()
            ref = mixer_block_plain(x, w)
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            log(f"[mixer] B={b} T={t} D={d} {str(dtype)[6:]}: max abs err {err:.3e}, "
                f"max|ref| {scale:.3e}, ratio {err / scale:.3e} (ceiling {tol:g})")
            if not (torch.isfinite(got).all().item() and err <= tol * scale):
                raise AssertionError(f"mixer block kernel disagrees at {(b, t, d)} {dtype}")
            if dtype == torch.bfloat16 and (b, t, d) == (4, 256, 1024):
                worst_bf16 = err
    return worst_bf16


def phase_timing(gen, smi):
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
        mixer_block,
        mixer_block_plain,
    )
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.vq_lookup import (
        nearest_codebook_indices_kernel,
        nearest_codebook_indices_plain,
    )

    times = {}
    cb = torch.rand(16384, 256, generator=gen, device="cuda") * (2.0 / 16384)
    for b in (1, 4, 16):
        x = torch.randn(b * 256, 256, generator=gen, device="cuda") * (2.0 / 16384)
        k_ms, p_ms = paired_ms(lambda: nearest_codebook_indices_kernel(x, cb),
                               lambda: nearest_codebook_indices_plain(x, cb))
        log(f"[time] vq N={b * 256} K=16384 C=256 f32: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms ({smi})")
        times[("vq", b)] = (k_ms, p_ms)
    for b in (1, 4, 16):
        w = random_block_weights(256, 1024, torch.bfloat16, gen)
        x = torch.randn(b, 256, 1024, generator=gen, device="cuda").to(torch.bfloat16)
        k_ms, p_ms = paired_ms(lambda: mixer_block(x, w), lambda: mixer_block_plain(x, w))
        flops = b * 2 * 256 * 1024 * (2 * 1024 + 2 * 4096)
        log(f"[time] mixer block B={b} T=256 D=1024 bf16: kernel {k_ms:.4f} ms "
            f"({flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} ms "
            f"({flops / p_ms / 1e9:.1f} TFLOP/s) ({smi})")
        times[("mixer", b)] = (k_ms, p_ms)
    return times


TINY_VQGAN = dict(n_embed=32, embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2),
                  num_res_blocks=1, attn_resolutions=(4,), resolution=8)


def phase_reference():
    """The whole path on a small input: card (kernels) against CPU (module path),
    float32, same weights."""
    import copy

    import torch

    from feed_forward_vqgan_clip_tpu_torch.entry import example_tokens
    from feed_forward_vqgan_clip_tpu_torch.infer import Generator, build_generator

    cpu = build_generator(clip_model="tiny", vqgan_config=TINY_VQGAN, dim=64, depth=2,
                          vq_image_size=4, dtype=torch.float32, device="cpu", seed=SEED)
    card = Generator(
        cpu.perceptor._replace(module=copy.deepcopy(cpu.perceptor.module).cuda()),
        copy.deepcopy(cpu.mapper).cuda(), copy.deepcopy(cpu.vq).cuda(),
    )
    tokens = example_tokens(3)
    tokens[1, 1], tokens[2, 1:3] = 1000, torch.tensor([2000, 3000])
    tokens[2, 3] = 49407
    h_cpu = cpu.encode_tokens(tokens)
    h_card = card.encode_tokens(tokens.cuda())
    z_cpu = cpu._mapper_apply(h_cpu)
    z_card = card._mapper_apply(h_card)
    img_cpu = cpu.render(h_cpu)
    img_card = card.render(h_card)
    torch.cuda.synchronize()
    z_err = (z_card.cpu() - z_cpu).abs().max().item() / z_cpu.abs().max().item()
    img_err = (img_card.cpu() - img_cpu).abs().max().item()
    log(f"[reference] tiny slice f32, card vs CPU module path: latent rel err {z_err:.3e} "
        f"(limit 1e-4), image max abs err {img_err:.3e} (limit 1e-3), shape "
        f"{tuple(img_card.shape)}")
    if not (z_err <= 1e-4 and img_err <= 1e-3):
        raise AssertionError("the card's slice disagrees with the CPU module path")


def phase_slice(smi):
    """The flagship slice answers requests of batch 1, 4 and 16 through the kernels."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.entry import entry, example_tokens
    from feed_forward_vqgan_clip_tpu_torch.io.images import save_grid
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import mixer_block
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.vq_lookup import (
        nearest_codebook_indices_kernel as vq_kernel,
    )

    t0 = time.perf_counter()
    prompt_to_image, _ = entry("cuda", batch=4, seed=SEED)
    prompt_to_image(example_tokens(1, "cuda"))  # warm-up, outside the counted run
    torch.cuda.synchronize()
    log(f"[slice] flagship generator built and warmed in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    vq_kernel.launches = 0
    mixer_block.launches = 0
    for b in REQUEST_BATCHES:
        tokens = example_tokens(b, "cuda")
        latencies = []
        for _ in range(3):
            vq0, mix0 = vq_kernel.launches, mixer_block.launches
            t = time.perf_counter()
            images = prompt_to_image(tokens)
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t)
            if vq_kernel.launches - vq0 != 1 or mixer_block.launches - mix0 < 32:
                raise AssertionError(
                    f"batch {b}: vq launches {vq_kernel.launches - vq0} (need 1), mixer "
                    f"block launches {mixer_block.launches - mix0} (need >= 32)")
        if tuple(images.shape) != (b, 256, 256, 3):
            raise AssertionError(f"batch {b}: images {tuple(images.shape)}")
        if not (torch.isfinite(images).all().item() and images.min().item() >= 0.0
                and images.max().item() <= 1.0):
            raise AssertionError(f"batch {b}: images not finite or outside [0, 1]")
        lat = sorted(latencies)[1]
        log(f"[slice] batch {b}: median latency {lat * 1e3:.2f} ms of 3, {b / lat:.2f} img/s, "
            f"image mean {images.mean().item():.4f} ({smi})")
    launches = {"vq": vq_kernel.launches, "mixer_block": mixer_block.launches}
    log(f"[slice] launches in the run: {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "chip_smoke_grid.png")
        save_grid(images.cpu().numpy(), path, nrow=8)
        with open(path, "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError("PNG grid was not written")
        log(f"[slice] wrote {path} ({os.path.getsize(path)} bytes)")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU",
              file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    vq_err = phase_vq(gen)
    mixer_err = phase_mixer(gen)
    times = phase_timing(gen, smi)
    phase_reference()
    launches = phase_slice(smi)
    kernels = [
        {"name": "vq_argmin", "route": "cuda",
         "source": "feed_forward_vqgan_clip_tpu_torch/csrc/vq_lookup.cu",
         "replaces": "feed_forward_vqgan_clip_tpu/ops/pallas/vq_lookup.py:33",
         "launches": launches["vq"], "max_abs_err": vq_err,
         "ms": times[("vq", 4)][0], "plain_ms": times[("vq", 4)][1]},
        {"name": "mixer_block", "route": "cuda",
         "source": "feed_forward_vqgan_clip_tpu_torch/csrc/mixer_block.cu",
         "replaces": "feed_forward_vqgan_clip_tpu/ops/pallas/mixer_block.py:225",
         "launches": launches["mixer_block"], "max_abs_err": mixer_err,
         "ms": times[("mixer", 4)][0], "plain_ms": times[("mixer", 4)][1]},
    ]
    if any(k["launches"] == 0 for k in kernels):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

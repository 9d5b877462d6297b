#!/usr/bin/env python3
"""Drive the PyTorch port's prompt->image, serving, train-step and trainer paths
(the default cutouts, then the unpooled crops), the released mapper families,
the flow prior (served and trained), the diversity loss, the offline
evaluation, the remaining perceptors, the JAX package's checkpoint formats and
the data preparation once on one NVIDIA GPU, in phases.

    python3 chip_smoke.py
    python3 chip_smoke.py --step-ab   # the determinism repairs' cost (step_ab)
    python3 chip_smoke.py --warp-against DIR   # K9, K10 against another tree's (warp_against)

1. [device] Needs torch.cuda.is_available(); prints the card's name and power
   limit (nvidia-smi), torch and CUDA versions, and whether triton imports.
2. [build] Compiles csrc/*.cu with nvcc for sm_90a (ops/kernels/build.py);
   counts the HGMMA (wgmma) instructions of each instantiation of the Hopper
   GEMM (csrc/wgmma_gemm.cuh) in the library's SASS (cuobjdump, where the
   toolkit has it), with the GEMMs of K11 and of the Mixer kernels that
   launch it, in K4's persistent bf16 kernel (csrc/mixer_stream_wgmma.cu) and in
   K1's search (csrc/vq_lookup.cu); fails if one the paths launch holds none.
3. [vq] VQ kernel (K1) against its plain version on the card (stated near-tie
   rule) at N = 1024, 1000, 256 and 2048 against the flagship codebook, N=1000
   against 1000 codes, N=77 at C=70 and a tie case; its split kernel's bf16
   pieces bitwise equal to the plain split; two launches bitwise equal.
4. [mixer] Mixer-block kernel against its plain version, float32 (TF32 off)
   and bf16, with its GEMMs' routes (mixer_block.mixer_gemm_route) and as many
   wgmma launches as the routes name.
5. [mixer-train] The train kernels (forward with residuals, channel backward,
   token backward) against their plain versions, float32 and bf16; the train
   forward's output equal to the inference block's; two backward runs bitwise
   equal; the wgmma GEMMs each call launched (the wrappers' `wgmma_launches`)
   equal to its routes', 4 in K6, 4 in K7 and 4 in K8 at the flagship's B=8 in
   bf16.
6. [warp] The warp forward (K9) and its adjoint (K10) against their plain
   versions at the train step's shape (64 crops of 224x224x3 with real Af and Pe
   draws), bf16 and float32, and on a horizon-crossing and a far-overshoot draw
   at 64x64; then with a 224x224 output frame of a 64x256x256x3 input (the
   unpooled crops): real Re draws, Re's largest zoom, Cc (a pure shift), the
   whole frame (shrinking) and a fused Af-then-Pe map; Af at the ends of its
   ranges (rotation +-15 degrees, translation +-10%, and a draw pushed onto two
   edges: the longest border strips); two K9 and two K10 runs bitwise equal;
   <K9 x, g> = <x, K10 g> in float32.
7. [stream] The whole-stack Mixer kernel (K4, one launch for 32 blocks)
   against its plain version at the flagship shape (T=256, D=1024, 32 blocks)
   at B=1 and 4, float32 and bf16, with its route and launch plan (bf16: one
   persistent wgmma CTA per SM, the GEMM phases' tiles and K splits, the grid
   barriers); bf16 also at T=49 on the WMMA-tile route (rows TMA cannot read);
   bf16 within a ceiling of ||err||/||plain|| too, which a planted fault (one
   block's bias dropped) exceeds, over three more draws for every bf16 way to
   the stack (K4 under three plans, the tile-route K4, 32 x K2); two K4
   launches bitwise equal; the stacked-layout block (K5) against its plain
   version at B=4, blocks 0 and 31.
8. [mlp-ln] The CLIP MLP sublayer (K11) forward, and its backward with dx
   alone and with the six parameter grads, against their plain versions at the
   train loss's shape (3200 x 768 x 3072, quick_gelu), at 100 rows of the same
   widths (ragged against the GEMM's 128-row tile) and a small gelu shape,
   float32 and bf16; two backward runs bitwise equal.
   [c3] The plain backwards of the R, Et and Ts codes, run twice at 64 crops of
   224 px (R from 256 px), float32: bitwise equal.
9. [time] Kernel and plain times at the flagship shapes, CUDA events, beside
   each kernel's bound; K1 at N = 256, 1024, 2048, 4096, eager and from a CUDA
   graph, with its split kernel alone, beside the tensor-core bound of its six
   bf16 products and the f32 CUDA-core bound of one; for the warps, eager and
   from a CUDA graph (K9 in f32 too), also grid_sample's forward and backward,
   square (224 -> 224) and rectangular (256 -> 224, Re draws);
   K4 (eager and from a CUDA graph; its plan against the plan without
   split-K) beside 32 x K2 (eager and from one CUDA graph) and 32 x K5 at the
   same batch; K11 beside the eager module sublayer (ln_2 -> mlp) forward and
   backward, each with its TFLOP/s;
   `[time] Mixer GEMM`: each GEMM of K6, K7 and K8 at B=8 and of K2 at B=1, 4, 16
   alone, on the wgmma GEMM at each tile width (the planned one marked), on the
   WMMA tile, and as one bf16 torch.matmul (cuBLAS, a yardstick on no path);
   K10 on the Af, Pe and rectangular draws beside grid_sample's input gradient.
10. [reference] The tiny prompt->image slice, card against CPU module path;
   the tiny serving Predictor, card (K4 at 2x2, K2 at 3x3) against CPU.
11. [train-reference] A tiny train step, f32, with Af and Pe at pinned draws,
   card (kernels) against CPU (module path, plain warps): loss and mapper grads.
12. [slice] The flagship generator (CLIP ViT-B/32 text tower, Mixer 32x1024,
   VQGAN f16-16384, bf16, random weights from a seed) answers requests of
   batch 1, 4 and 16; the kernels' launch counters must rise; one PNG grid.
   Then the same in stream mode (`entry(stream_mixer=True)`): K4 at batch 1 and
   4, K5 x 32 at batch 16, on the same tokens.
13. [serve] The serving Predictor: the flagship mapper saved as a reference
   `.th` checkpoint, loaded with ViT-B/32 and VQGAN f16-16384 (random from the
   seed) and a synthetic BPE table; grids 1x1, 2x2 and 4x4, a warm-up and 3
   timed requests each; K4 once per request of n <= 8 images, K2 32 times at
   n = 16; per-stage CUDA-event ms, request ms, peak memory; after each
   request's time, its float images n x 256 x 256 x 3 and finite in [0, 1].
14. [train] The flagship train step (entry.train_entry: B=8, cutn=8, 224-px
   cutouts with the default augs Af/Pe/Ji/Er, ViT-B/32 loss, Adam), built twice:
   the image tower as modules, and through K11 (FFVC_FUSED_CLIP=1). A warm-up
   step each, then 3 timed steps each, in turns, each with a finite loss,
   changed parameters, the Mixer train kernels' counters up by 32 each, the VQ
   kernel's by 1, the warp kernels' by 2 each and, fused, K11's forward and
   backward by 12 each; per-stage CUDA-event times.
15. [trainer] `train(cfg, device="cuda")` at the same geometry on a token file,
   FFVC_FUSED_CLIP=1, EMA, cosine schedule, clipping: 5 steps with two log
   steps (previews, checkpoints), a resume to step 7, the run folder checked;
   step, log-step, save and write times and checkpoint bytes. Then, at mapper
   depth 2, 4 steps against 2 + 2 resumed and against a second uninterrupted
   run: parameters, EMA and Adam moments bitwise equal.
16. [cutouts] MakeCutouts on the card against the CPU, float32, at draws pinned
   from a CPU generator: `pool: false` + Re, `pool_size` 256 + Cc, `interpolate`,
   `fuse_geometric`; output and input gradient.
17. [trainer-crops] `train(cfg, device="cuda")` at the flagship with `pool: false`
   and augs Re, Af, Pe, Ji, Er (noise 0.1), module tower, beside the default
   cutouts in the same harness: per step a finite loss, changed parameters, the
   warp counters up by 3 forward and 3 adjoint, one pair of them from 256 to
   224 px (2 and 2, none, by default); step and per-stage ms, peak memory. Then
   two identical 2-step runs at depth 2, bitwise equal.
18. [mappers] The released mapper families the flagship is not, at full width
   with random weights from seeds of the phase's own (MAPPER_MODELS): the VitGAN
   Generator 32x1024 (ViT-B/32), the x-transformer 256x16 at 512 px
   (32 x 32 latent tokens) and the Mixer 32x1024 with the ml-jku CLOOB RN50
   perceptor. Each saved as a `.th`, served by the Predictor (VitGAN and Mixer
   at 1x1, 2x2, 4x4, the x-transformer at 1x1, 2x2; per-stage CUDA-event ms,
   peak memory; images finite in [0, 1]; K1 once a request, the Mixer's K4 at
   n <= 8 and 32 x K2 above, no Mixer kernel for the others), then one train
   step through entry.train_entry (finite loss, changed parameters; K1, K9 x 2,
   K10 x 2, and K6, K7, K8 x 32 for the Mixer).
19. [prior] The flagship `.th` served with a prior `.th` of the released
   prior's widths (PRIOR_MODEL: 2 flows, hidden 1024, over 512-d embeddings),
   random from a seed: grids 1x1, 2x2, 4x4 with prior=True and 1x1 without
   (serve_timed: the stages text, prior, mapper, decode; K1 once, K4 at
   n <= 8, 32 x K2 at 16); prior=True moves the mapper input; the card's
   reverse on a pinned z against the CPU's, float32, within 1e-4 of
   max(1, max |CPU|); `cli test --prior-path` once.
20. [prior-train] `train_prior` on 16384 seeded pairs of 512-d (y a fixed
   random linear map of x plus noise), batch 128, lr 1e-4: 300 steps, a rerun
   to 400, against 400 at once: median step ms (CUDA events), the loss at
   steps 0, 100, 300 (falling), parameters and Adam moments bitwise equal.
21. [diversity] The flagship train step with 4 prompts x repeat 2, noise_dim
   128 and the diversity term (coefficient 1, between the repeats of a prompt,
   random VGG16) beside coefficient 0: median step and stage ms, peak memory;
   the term > 0 and moving the mapper's grads; K1, K6-K8 x 32, K9 and K10 x 2
   a step; VGG16 in bf16 on the card within 2e-2 of the CPU's float32 max per
   slice.
22. [eval] `cli evaluate --compute-fid` on the flagship `.th` over 256 prompts
   of the synthetic BPE table, batch 64, eval perceptor ViT-B/32 and
   InceptionV3 random, seeded "real" features: prompts/s, the Inception's
   CUDA-event ms a batch, the FID's host time; K1 once and K2 32 times a
   batch; the JSON's keys and finite values. Each of [prior] to [eval] draws
   from generators seeded apart from the shared one, so [stream]'s draws stay.
23. [perceptors] crowsonkb's CLOOB ViT-B/16 (cloob_laion_400m_vit_b_16_32_epochs)
   at full width, random, written as a haiku pickle of numpy arrays and read
   back bitwise: card vs CPU (two rows of each encode, float32, within 1e-4 of
   max(1, max |CPU|)), bf16 encode ms and peak memory; the flagship Mixer served
   with it from the pickle (1x1, 2x2: K1, K4) and trained one step through
   entry.train_entry (K1, K6-K8 x 32, K9 x 2, K10 x 2), as [mappers] runs a
   model. Then open_clip's ViT-B-16-plus-240 at its published widths, random,
   as fp16 OpenCLIP state dicts, one with the text tower under `text.`: the
   sniffed config equal to those widths, card vs CPU, encode ms.
24. [native-ckpt] The flagship Mixer at noise_dim 128 with a noise bank written
   as a `.th` and as a JAX checkpoint directory (io/from_jax.mixer_tree and the
   port's msgpack writer): the directory's bytes and read seconds; one
   Predictor serves both, 1x1 and 2x2 images and PNGs bitwise equal (K1, K4);
   a legacy whole-module pickle of a stand-in mapper (the reference's module
   name, not importable) loads with its config and noise, outputs bitwise.
25. [encode] 4096 seeded 256-px JPEG / caption pairs in 4 tars (one corrupt)
   through `cli encode-text-and-images-webdataset` with ViT-B/32 (random) at
   batch 512 and the NIMA filter (IRv2, random, Cadene keys; threshold the
   median MOS of a first scoring pass): pairs/s, CUDA-event ms per batch of the
   text tower, image tower and NIMA, the host's share, the rows dropped; card
   vs CPU features on 8 samples (float32); spill and no-prefetch runs equal to
   the default; `cli merge-features` equal to the concatenation and read by
   `train_prior` for 5 steps; the words the encoder's tokenizer merged and
   how many of them reached the native BPE core; `cli tokenize` on 10000 lines
   of random-letter words and of prompt-like English, the native BPE core
   against pure Python on a synthetic letter-merge table (equal tokens, both
   times, the words each core call took; the core must build).
   Each of [perceptors] to [encode] draws from generators of its own.
26. Prints the card's line, the kernels' JSON line (K11's launches from the
   [trainer] runs, the warps' from [train], [trainer-crops], [mappers],
   [diversity] and [perceptors], with the rectangular warps' times, and their
   launches in [trainer-crops] as the wrappers counted them, under "rect"; K1,
   K2, K4, K6-K8 with [mappers]', [prior]'s, [diversity]'s, [eval]'s,
   [perceptors]' and [native-ckpt]'s too), then `{"ok": true, "device": {...}}`
   last.

Any failed check raises, so the script exits nonzero before the last line. It
imports nothing of JAX.
"""

import contextlib
import gzip
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

# f32 tolerances are ceilings relative to the reference's largest magnitude
MIXER_F32_TOL = 1e-3
MIXER_BF16_TOL = 3e-2
# K4 in bf16 (32 blocks): ||err|| / ||plain|| beside the max-abs ceiling, a limit
# between every bf16 way to the stack (1.90-2.08e-2 on an H100) and a planted fault
# (the plain version with one of these blocks' b2 dropped: from 2.69e-2) (PERF.md);
# fresh draws of the error study
MIXER_BF16_REL_L2 = 2.4e-2
STREAM_CONTROL_BLOCKS = (0, 31)
STREAM_ERROR_DRAWS = 3
# the warps: the same taps and weights as the plain versions, sums in another order
WARP_F32_TOL = 1e-4
WARP_BF16_TOL = 3e-2
WARP_SHAPE = (64, 224, 224, 3)  # the train step's cutouts: B=8 x cutn=8
RECT_IN = (64, 256, 256, 3)  # the unpooled renders, tiled cutn-major, cut to 224
# a Pe-family draw at distortion 1.4 whose horizon crosses the 64-px frame
HORIZON_END_DISP = [[20.89, 41.26], [-32.96, 4.26], [-40.97, -30.36], [0.75, -2.43]]
VQ_MIN_AGREEMENT = 0.999
REQUEST_BATCHES = (1, 4, 16)
STREAM_DEPTH = 32  # the flagship Mixer's blocks
FORWARD_GEMMS = ("g1", "r", "g3", "out")  # K2, K5, K6 (mixer_block.MIXER_GEMMS)
CHANNEL_BWD_GEMMS = ("da3", "drn", "dw2", "dw1")  # K7
TOKEN_BWD_GEMMS = ("da1", "dxn", "dt2", "dt1")  # K8
STREAM_BATCHES = (1, 4)
SERVE_GRIDS = ("1x1", "2x2", "4x4")
SERVE_REQUESTS = 3
PROMPT = "hello world"
# a synthetic BPE merge table (the release vocabulary is not in the repository)
BPE_MERGES = ["h e", "l l", "he ll", "o</w> !</w>", "hell o</w>", "w o", "r l", "wo rl",
              "worl d</w>"]
TRAIN_STEPS = 3
SEED = 0
# the flagship of __graft_entry__.entry, as a released checkpoint's config holds it
FLAGSHIP_CONFIG = dict(clip_model="ViT-B/32", model_type="mlp_mixer", dim=1024, depth=32,
                       dropout=0, vq_image_size=16, noise_dim=0,
                       vqgan_model="vqgan_imagenet_f16_16384", compute_dtype="bfloat16")
# [mappers]: the released mapper checkpoints the flagship is not, at their widths
# (random weights from a seed of the phase's own): label, config, serving grids.
# "256x16" of the x-transformer's file name read as dim x depth (depth 256 at
# width 16 is no trainable transformer); its config is not in the repository.
MAPPER_COMMON = dict(dropout=0, noise_dim=0, vqgan_model="vqgan_imagenet_f16_16384",
                     compute_dtype="bfloat16")
MAPPER_MODELS = (
    ("vitgan_32x1024", dict(clip_model="ViT-B/32", model_type="vitgan", dim=1024, depth=32,
                            vq_image_size=16, num_heads=6), ("1x1", "2x2", "4x4")),
    ("xtransformer_256x16_512px", dict(clip_model="ViT-B/32", model_type="xtransformer",
                                       dim=256, depth=16, vq_image_size=32, num_heads=6,
                                       initial_proj=True, add_input=False), ("1x1", "2x2")),
    ("mlp_mixer_32x1024_cloob_rn50", dict(clip_model="cloob_rn50", model_type="mlp_mixer",
                                          dim=1024, depth=32, vq_image_size=16),
     ("1x1", "2x2", "4x4")),
)
MAPPERS_SEED = 11
# [prior]: the released prior of the ViT-B/32 mappers, prior_cc12m_2x1024_clip_ViTB32_v0.4.th,
# at the widths its name reads as (2 flows of hidden width 1024, as the mapper names
# read depth x width; hidden depth 2, embedding 1024, the conditioning embedder's
# defaults), over ViT-B/32's 512-d embeddings; the file's own config is not in the
# repository. Each new phase draws from generators seeded apart from main()'s.
PRIOR_MODEL = dict(n_flows=2, hidden_dim=1024, hidden_depth=2, embedding_dim=1024)
PRIOR_SEED = 21
PRIOR_TRAIN_PAIRS = 16384
DIVERSITY_SEED = 31
EVAL_SEED = 41
EVAL_PROMPTS, EVAL_BATCH = 256, 64
# [perceptors], [native-ckpt] and [encode], each on generators of its own (so
# [stream]'s draws stay):
# [perceptors] crowsonkb's CLOOB ViT and an OpenCLIP arch outside the registry at
# its published widths (open_clip's ViT-B-16-plus-240: image 240 px, patch 16,
# width 896, 12 layers; text width 640, 12 layers; embedding 640)
PERCEPTORS_SEED = 51
CLOOB_NAME = "cloob_laion_400m_vit_b_16_32_epochs"
OPENCLIP_NAME = "openclip/ViT-B-16-plus-240/laion400m_e32"
OPENCLIP_PLUS_240 = dict(image_size=240, patch_size=16, vision_width=896, vision_layers=12,
                         vision_heads=14, embed_dim=640, text_width=640, text_layers=12,
                         text_heads=10, vocab_size=49408, context_length=77)
# [native-ckpt]: the JAX checkpoint directory and a legacy pickle of the reference's class
NATIVE_CKPT_SEED = 61
LEGACY_MODULE = "mlp_mixer_pytorch"
# [encode]: the data preparation at the JAX package's default batch
ENCODE_SEED = 71
ENCODE_PAIRS, ENCODE_BATCH = 4096, 512
TOKENIZE_LINES = 10000
# prompt-like English for `cli tokenize`: a vocabulary of the kind prompts draw on
PROMPT_WORDS = """a an the of in on at with and by from under over above beside
painting photo photograph drawing sketch illustration render portrait landscape
cityscape still life poster cover concept art oil watercolor pencil charcoal digital
red blue green yellow orange purple pink black white golden silver dark bright
pastel neon misty foggy sunny rainy snowy stormy night sunset sunrise morning
cat dog horse bird owl fox wolf dragon robot astronaut knight wizard girl boy woman
man child king queen castle city street forest mountain river ocean lake beach desert
island village house tower bridge garden flower tree sky cloud moon star planet space
ship car train window door table chair book lamp candle mirror clock
beautiful detailed intricate highly realistic photorealistic surreal abstract
minimalist vintage retro futuristic ancient medieval cyberpunk steampunk fantasy
epic cinematic dramatic lighting volumetric studio trending artstation unreal engine
style by van gogh monet picasso greg rutkowski""".split()
CLIP_BLOCKS = 12  # ViT-B/32's image tower: one K11 forward and backward per block
MLP_SHAPE = (3200, 768, 3072)  # K11 at the train loss: 64 crops x 50 tokens, D, E
TRAINER_LR = 1e-3
AB_ROUNDS = 5  # --step-ab: timed steps of each variant
# csrc/wgmma_gemm.cuh's compiled (A M-major, B MN-major, epilogue) instantiations and the
# GEMMs that launch them (K11: fc1, fc2, dgh, dxn; the Mixer block: MIXER_GEMMS)
WGMMA_EPILOGUES = ("act", "res", "mul", "f32", "act_only")
WGMMA_USERS = {
    (0, 0, 0): "K11 fc1, K6 g3", (0, 0, 4): "K2/K5 g3", (0, 0, 1): "K11 fc2, K2/K5/K6 out",
    (0, 1, 0): "K6 g1", (0, 1, 4): "K2/K5 g1", (0, 1, 1): "K2/K5/K6 r",
    (0, 1, 2): "K11 dgh, K7 da3", (0, 1, 3): "K11 dxn, K7 drn",
    (1, 1, 3): "K7 dW2, K7 dW1, K8 dxn", (1, 1, 2): "K8 da1", (0, 0, 3): "K8 dt2, K8 dt1",
}
# K4's persistent bf16 kernel (csrc/mixer_stream_wgmma.cu), which runs the GEMM's tile
# walk inside itself
STREAM_WGMMA_KERNEL = "mixer_stream_wgmma_kernel"
VQ_KERNEL = "vq_argmin_kernel"  # K1's search (csrc/vq_lookup.cu): six bf16 wgmma products
# published peaks of one H100 SXM (dense) at a 700 W limit, for the bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


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


def graph_ms(fn, iters=20):
    """Mean milliseconds of fn's launches replayed from one CUDA graph, CUDA
    events: the device's time without the host's enqueue (Python, ctypes, tensor
    maps), which the eager launches of the Mixer kernels are now as long as. fn
    runs once eagerly first (builds, attributes, the caching allocator); it must
    launch on the current stream as it finds it at each call (the kernel
    wrappers build their launcher per call), or its launches miss the graph."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, iters)
    del graph
    return ms


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
        if "Compiling entry function" in line:
            log(f"[build]   {line.split(chr(39))[1]}")  # the mangled kernel name
        elif "registers" in line or "spill" in line:
            log(f"[build]     {line.strip()}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", str(build.library_path())],
                              capture_output=True, text=True, timeout=300).stdout
        counts, kernel = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                kernel = line.split("Function :")[1].strip()
            elif "HGMMA" in line and kernel:
                counts[kernel] = counts.get(kernel, 0) + 1
        wgmma = {k: n for k, n in counts.items() if "wgmma_gemm_kernel" in k}
        log(f"[build] HGMMA (wgmma) instructions in the SASS: {sum(wgmma.values())} in "
            f"{len(wgmma)} wgmma_gemm_kernel instantiations, "
            f"{sum(counts.values()) - sum(wgmma.values())} elsewhere")
        users, found = {}, set()
        for name, n in sorted(wgmma.items()):
            # _ZN4ffvc17wgmma_gemm_kernelILi<BN>ELi<A M-major>ELi<B MN-major>ELi<epilogue>
            # ELb<row bias>E...
            bn, ta, tb, epi, rows = (int(v) for v in re.search(
                r"ILi(\d+)ELi(\d)ELi(\d)ELi(\d)ELb(\d)E", name).groups())
            who = WGMMA_USERS.get((ta, tb, epi), "")
            log(f"[build]   wgmma_gemm_kernel<{bn}, A {'M' if ta else 'K'}-major, B "
                f"{'MN' if tb else 'K'}-major, {WGMMA_EPILOGUES[epi]}"
                f"{', row bias' if rows else ''}>: {n} HGMMA ({who})")
            if n:
                found.add((ta, tb, epi))
                for u in who.split(", "):
                    users[u] = users.get(u, 0) + n
        log(f"[build] HGMMA by user: {users}")
        missing = set(WGMMA_USERS) - found
        if missing:
            raise AssertionError(f"wgmma GEMM instantiations without HGMMA instructions: "
                                 f"{[WGMMA_USERS[k] for k in missing]}")
        for kernel, who in ((STREAM_WGMMA_KERNEL, "K4, bf16"), (VQ_KERNEL, "K1")):
            n = sum(v for k, v in counts.items() if kernel in k)
            log(f"[build] {kernel} ({who}): {n} HGMMA")
            if not n:
                raise AssertionError(f"{who}'s kernel {kernel} holds no HGMMA instruction")
    else:
        log("[build] cuobjdump not found: the SASS is not inspected")


def _vq_case(n, k, c, gen, tie=False):
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.vq_lookup import (
        nearest_codebook_indices_kernel,
        nearest_codebook_indices_plain,
        split_pieces,
        vq_plan,
    )

    dev = "cuda"
    x = torch.randn(n, c, generator=gen, device=dev)
    cb = torch.randn(k, c, generator=gen, device=dev)
    if tie:  # duplicated halves: every winner must be the lower copy
        cb[k // 2:] = cb[: k // 2]
    got = nearest_codebook_indices_kernel(x, cb).long()
    again = nearest_codebook_indices_kernel(x, cb).long()
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
    # the split kernel's bf16 pieces against the plain split, bit for bit
    plan = vq_plan(n, k, c, torch.cuda.get_device_properties(0).multi_processor_count)
    pieces = split_pieces(x, cb, plan.channels)
    plain_pieces = split_pieces(x.cpu(), cb.cpu(), plan.channels)
    same_pieces = all(torch.equal(a.cpu(), b) for a, b in zip(pieces, plain_pieces))
    repeat = torch.equal(got, again)
    ok = (agree >= VQ_MIN_AGREEMENT and not bad.any().item() and got.min() >= 0
          and got.max() < k and same_pieces and repeat)
    if tie:
        ok = ok and bool((got < k // 2).all().item())
    log(f"[vq] N={n} K={k} C={c}{' tie' if tie else ''}: agreement {agree:.6f}, "
        f"{int(diff.sum())} flips (all near-ties: {not bad.any().item()}), "
        f"max |score(kernel) - score(plain)| {max_err:.3e}; {plan.splits} splits x "
        f"{plan.row_blocks} row blocks, {plan.channels} channels; pieces bitwise equal to "
        f"the plain split: {same_pieces}; two launches bitwise equal: {repeat}")
    if not ok:
        raise AssertionError(f"vq kernel disagrees with plain at N={n} K={k} C={c} tie={tie}")
    return max_err


def phase_vq(gen):
    """K1 against its plain version: the four cases of the shared stream `gen`, then
    N = 256 (1x1), 2048 (the train step) and a ragged C = 70 on a generator of their
    own, so that every later phase draws what it drew before they were added, and
    [eval]'s N = 16384 (64 images) on another."""
    import torch

    errs = [
        _vq_case(1024, 16384, 256, gen),
        _vq_case(1000, 16384, 256, gen),
        _vq_case(1000, 1000, 256, gen),
        _vq_case(300, 2048, 256, gen, tie=True),
    ]
    own = torch.Generator(device="cuda").manual_seed(SEED + 1)
    errs += [
        _vq_case(256, 16384, 256, own),
        _vq_case(2048, 16384, 256, own),
        _vq_case(77, 1000, 70, own),
    ]
    # [eval]'s batch of EVAL_BATCH images, on a generator of its own
    rows = EVAL_BATCH * FLAGSHIP_CONFIG["vq_image_size"] ** 2
    errs.append(_vq_case(rows, 16384, 256, torch.Generator(device="cuda").manual_seed(EVAL_SEED)))
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
        mixer_gemm_routes,
    )

    worst_bf16 = 0.0
    # [eval]'s B=64 last, on a generator of its own: the shared draws stay where they were
    own = torch.Generator(device="cuda").manual_seed(EVAL_SEED)
    cases = [(shape, gen) for shape in ((4, 256, 1024), (3, 64, 96), (2, 50, 100))]
    for (b, t, d), draw in cases + [((EVAL_BATCH, 256, 1024), own)]:
        for dtype, tol in ((torch.float32, MIXER_F32_TOL), (torch.bfloat16, MIXER_BF16_TOL)):
            w = random_block_weights(t, d, dtype, draw)
            x = torch.randn(b, t, d, generator=draw, device="cuda").to(dtype)
            before = mixer_block.wgmma_launches
            got = mixer_block(x, w)
            torch.cuda.synchronize()
            routes = mixer_gemm_routes(t, d, 4 * t, 4 * d, dtype)
            want = sum(routes[n] == "wgmma" for n in FORWARD_GEMMS)
            if mixer_block.wgmma_launches - before != want:
                raise AssertionError(f"mixer_block launched {mixer_block.wgmma_launches - before} "
                                     f"wgmma GEMMs at {(b, t, d)} {dtype}, its routes {want}")
            ref = mixer_block_plain(x, w)
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            log(f"[mixer] B={b} T={t} D={d} {str(dtype)[6:]}: max abs err {err:.3e}, "
                f"max|ref| {scale:.3e}, ratio {err / scale:.3e} (ceiling {tol:g}); GEMM routes "
                f"{[routes[n] for n in FORWARD_GEMMS]}")
            if not (torch.isfinite(got).all().item() and err <= tol * scale):
                raise AssertionError(f"mixer block kernel disagrees at {(b, t, d)} {dtype}")
            if dtype == torch.bfloat16 and (b, t, d) == (4, 256, 1024):
                worst_bf16 = err
    return worst_bf16


def phase_mixer_train(gen):
    """The three train kernels against their plain versions, each output and
    parameter grad within the ceiling relative to max |plain|; -> {kernel name:
    max abs err at the flagship shape in bf16}."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
        mixer_block,
        mixer_block_fwd_res,
        mixer_block_fwd_res_plain,
        mixer_channel_bwd,
        mixer_channel_bwd_plain,
        mixer_gemm_routes,
        mixer_token_bwd,
        mixer_token_bwd_plain,
    )

    worst = {}
    for (b, t, d) in ((8, 256, 1024), (3, 64, 96), (2, 50, 100)):
        for dtype, tol in ((torch.float32, MIXER_F32_TOL), (torch.bfloat16, MIXER_BF16_TOL)):
            w = random_block_weights(t, d, dtype, gen)
            x = torch.randn(b, t, d, generator=gen, device="cuda").to(dtype)
            dout = torch.randn(b, t, d, generator=gen, device="cuda")
            wg = (mixer_block_fwd_res.wgmma_launches, mixer_channel_bwd.wgmma_launches,
                  mixer_token_bwd.wgmma_launches)
            out, res = mixer_block_fwd_res(x, w)
            ch = mixer_channel_bwd(dout, res, w)
            tok = mixer_token_bwd(ch.dr, x, res.g1, res.dg1, w)
            launched = (mixer_block_fwd_res.wgmma_launches - wg[0],
                        mixer_channel_bwd.wgmma_launches - wg[1],
                        mixer_token_bwd.wgmma_launches - wg[2])
            routes = mixer_gemm_routes(t, d, 4 * t, 4 * d, dtype)
            want = tuple(sum(routes[n] == "wgmma" for n in names)
                         for names in (FORWARD_GEMMS, CHANNEL_BWD_GEMMS, TOKEN_BWD_GEMMS))
            if (b, t, d, dtype) == (8, 256, 1024, torch.bfloat16) and want != (4, 4, 4):
                raise AssertionError(f"the flagship's K6 / K7 / K8 GEMM routes at B=8: {routes}")
            log(f"[mixer-train] B={b} T={t} D={d} {str(dtype)[6:]}: wgmma GEMMs launched by K6 "
                f"{launched[0]}, by K7 {launched[1]}, by K8 {launched[2]} (routes {routes})")
            if launched != want:
                raise AssertionError(f"wgmma launches {launched}, the routes {want}")
            if not torch.equal(out, mixer_block(x, w)):
                raise AssertionError(f"train forward output differs from mixer_block at "
                                     f"{(b, t, d)} {dtype}")
            ref_out, ref_res = mixer_block_fwd_res_plain(x, w)
            pairs = {
                "mixer_fwd_res": [(out, ref_out)] + list(zip(res, ref_res)),
                "mixer_channel_bwd": list(zip(ch, mixer_channel_bwd_plain(dout, res, w))),
                "mixer_token_bwd": list(zip(
                    tok, mixer_token_bwd_plain(ch.dr, x, res.g1, res.dg1, w))),
            }
            for name, outs in pairs.items():
                abs_err = max((g.float() - r.float()).abs().max().item() for g, r in outs)
                ratio = max((g.float() - r.float()).abs().max().item()
                            / max(r.float().abs().max().item(), 1e-30) for g, r in outs)
                finite = all(torch.isfinite(g).all().item() for g, _ in outs)
                log(f"[mixer-train] {name} B={b} T={t} D={d} {str(dtype)[6:]}: max abs err "
                    f"{abs_err:.3e}, worst err / max|plain| over {len(outs)} outputs "
                    f"{ratio:.3e} (ceiling {tol:g})")
                if not (finite and ratio <= tol):
                    raise AssertionError(f"{name} disagrees with its plain version at "
                                         f"{(b, t, d)} {dtype}")
                if dtype == torch.bfloat16 and b == 8:
                    worst[name] = abs_err
            again = mixer_token_bwd(mixer_channel_bwd(dout, res, w).dr, x, res.g1, res.dg1, w)
            if not all(torch.equal(a, c) for a, c in zip(tok, again)):
                raise AssertionError(f"backward grads differ between two runs at {(b, t, d)}")
    log("[mixer-train] train forward output equals mixer_block's bit for bit; two backward "
        "runs bitwise equal at every shape")
    return worst


def warp_draws(gen, b, h, w):
    """{name: (m (b, 3, 3) on the card, padding mode)}: the train step's Af
    (border) and Pe (zeros) maps from their samplers."""
    from feed_forward_vqgan_clip_tpu_torch.ops import augment

    af = augment.af_matrices(*augment.af_sample(gen, b, h, w, "cuda"), h, w)
    pe = augment.pe_matrices(*augment.pe_sample(gen, b, h, w, "cuda"), h, w)
    return {"Af": (af, "border"), "Pe": (pe, "zeros")}


def rect_draws(gen, b, h, w, out):
    """{name: (m (b, 3, 3) on the card, padding mode)} of warps from an (h, w)
    frame onto an (out, out) one: the Re sampler's boxes, Re's largest zoom (the
    scale-0.1 area at both ends of the aspect range), the centre crop (a pure
    shift), the whole frame (shrinking) and a fused Af-then-Pe map."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops import augment

    dev = "cuda"
    area = 0.1 * h * w
    aspect = torch.tensor([0.75, 1.333], device=dev).repeat(b // 2)
    cw, ch = torch.sqrt(area * aspect), torch.sqrt(area / aspect)
    x0 = torch.rand(b, generator=gen, device=dev) * (w - cw)
    y0 = torch.rand(b, generator=gen, device=dev) * (h - ch)
    full = torch.full((b,), float(h), device=dev)
    shift = torch.full((b,), (h - out) / 2.0, device=dev)
    side = torch.full((b,), float(out), device=dev)
    return {
        "Re": (augment.crop_matrices(*augment.re_sample(gen, b, h, w, augment.RE_SCALE, dev),
                                     out), "border"),
        "Re max zoom": (augment.crop_matrices(x0, y0, cw, ch, out), "border"),
        "Cc": (augment.crop_matrices(shift, shift, side, side, out), "border"),
        "whole frame": (augment.crop_matrices(full * 0, full * 0, full, full, out), "border"),
        "fused Af-Pe": (augment.fused_matrices(*augment.fused_sample(gen, b, h, w, dev), h, w),
                        "border"),
    }


def af_extremes(h, w):
    """Af's maps (on the card) at the ends of its ranges: rotation +-15 degrees and
    translation +-10% on both axes in every sign combination, then a draw pushed
    onto two edges at once; the border strips of K10's edge pixels are longest."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops import augment

    combos = [(a, x, y) for a in (augment.AF_DEGREES, -augment.AF_DEGREES)
              for x in (augment.AF_TRANSLATE, -augment.AF_TRANSLATE)
              for y in (augment.AF_TRANSLATE, -augment.AF_TRANSLATE)]
    combos.append((augment.AF_DEGREES, augment.AF_TRANSLATE, augment.AF_TRANSLATE))
    ang, tx, ty = (torch.tensor([v[i] for v in combos], device="cuda") for i in range(3))
    return augment.af_matrices(ang, tx * w, ty * h, h, w)


def warp_cases(gen):
    """[(label, m, padding mode, input shape, output frame)]: the train step's Af and
    Pe draws at its square shape, a horizon-crossing and a far-overshoot draw at
    64x64, Af's extremes, and the rectangular draws from 256 to 224 px."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops import augment

    b, h, w, c = WARP_SHAPE
    cases = [(f"{name} {b}x{h}x{w}x{c}", m, mode, WARP_SHAPE, (h, w))
             for name, (m, mode) in warp_draws(gen, b, h, w).items()]
    start, _ = augment.pe_sample(gen, 1, 64, 64, "cuda")
    horizon = augment.solve_homography(start + torch.tensor([HORIZON_END_DISP], device="cuda"),
                                       start)
    cases.append(("horizon 1x64x64x3", horizon, "zeros", (1, 64, 64, 3), (64, 64)))
    far = augment._affine3(augment._affine_inverse_about_center(
        torch.tensor([0.2], device="cuda"), torch.tensor([55.0], device="cuda"),
        torch.tensor([-60.0], device="cuda"), torch.ones(1, device="cuda"), 64, 64))
    cases.append(("far-overshoot border 1x64x64x3", far, "border", (1, 64, 64, 3), (64, 64)))
    extremes = af_extremes(h, w)
    cases.append((f"Af extremes {extremes.shape[0]}x{h}x{w}x{c}", extremes, "border",
                  (extremes.shape[0], h, w, c), (h, w)))
    rb, rh, rw, rc = RECT_IN
    cases += [(f"{name} {rb}x{rh}x{rw}x{rc} -> {h}x{w}", m, mode, RECT_IN, (h, w))
              for name, (m, mode) in rect_draws(gen, rb, rh, rw, h).items()]
    return cases


def phase_warp(gen):
    """K9 and K10 against their plain versions, each within its ceiling of max
    |plain|, at equal frames and from 256 to 224 px; two K9 and two K10 runs
    bitwise equal; the dot-product test in float32. -> {kernel name: max abs err in
    bf16 at the train step's square shape, and under "rect" at the rectangular one}."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_adjoint import (
        warp_adjoint,
        warp_adjoint_plain,
    )
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_forward import (
        warp_forward,
        warp_forward_plain,
    )

    cases = warp_cases(gen)
    worst = {"warp_forward": 0.0, "warp_adjoint": 0.0}
    rect = {"warp_forward": 0.0, "warp_adjoint": 0.0}
    for label, m, mode, shape, out_hw in cases:
        in_hw = tuple(shape[1:3])
        for dtype, tol in ((torch.float32, WARP_F32_TOL), (torch.bfloat16, WARP_BF16_TOL)):
            x = torch.rand(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn((shape[0], *out_hw, shape[3]), generator=gen, device="cuda").to(dtype)
            out = warp_forward(x, m, mode, out_hw)
            out_again = warp_forward(x, m, mode, out_hw)
            grad = warp_adjoint(g, m, mode, in_hw)
            again = warp_adjoint(g, m, mode, in_hw)
            torch.cuda.synchronize()
            for name, got, ref in (("warp_forward", out, warp_forward_plain(x, m, mode, out_hw)),
                                   ("warp_adjoint", grad,
                                    warp_adjoint_plain(g, m, mode, in_hw))):
                err = (got.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                log(f"[warp] {name} {label} {mode} {str(dtype)[6:]}: max abs err {err:.3e}, "
                    f"max|plain| {scale:.3e}, ratio {err / max(scale, 1e-30):.3e} "
                    f"(ceiling {tol:g})")
                if not (torch.isfinite(got).all().item() and err <= tol * scale):
                    raise AssertionError(f"{name} disagrees with its plain version at {label} "
                                         f"{mode} {dtype}")
                if dtype == torch.bfloat16 and shape == WARP_SHAPE:
                    worst[name] = max(worst[name], err)
                if dtype == torch.bfloat16 and shape == RECT_IN:
                    rect[name] = max(rect[name], err)
            if not (torch.equal(grad, again) and torch.equal(out, out_again)):
                raise AssertionError(f"a warp kernel differs between two runs at {label} {dtype}")
            if dtype == torch.float32:
                terms = out.double() * g.double()
                lhs, rhs = terms.sum().item(), (x.double() * grad.double()).sum().item()
                dot_err = abs(lhs - rhs) / terms.abs().sum().item()
                log(f"[warp] <K9 x, g> = {lhs:.6e}, <x, K10 g> = {rhs:.6e}: difference / "
                    f"sum |terms| {dot_err:.3e} (limit 1e-5) at {label}")
                if not dot_err <= 1e-5:
                    raise AssertionError(f"warp_adjoint is not the transpose of warp_forward at "
                                         f"{label}")
    log("[warp] two forward and two adjoint runs bitwise equal at every draw, pair of frames "
        "and dtype")
    worst["rect"] = rect
    return worst


def flagship_stack(gen, dtype):
    """STREAM_DEPTH blocks of random flagship weights (random_block_weights, T=256,
    D=1024) -> (the per-block MixerBlockWeights in `dtype`, their stacked,
    LN2-folded layout in `dtype`)."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
        MATRICES,
        stack_mixer_params,
    )

    blocks = [random_block_weights(256, 1024, torch.float32, gen) for _ in range(STREAM_DEPTH)]
    per_block = [w._replace(**{n: getattr(w, n).to(dtype) for n in MATRICES}) for w in blocks]
    return per_block, stack_mixer_params(blocks, dtype)


def stream_err(got, ref):
    """(max abs err, max abs err / max|plain|, ||err|| / ||plain||) of `got`
    against the plain version's `ref`."""
    diff = got.float() - ref.float()
    err = diff.abs().max().item()
    return err, err / ref.float().abs().max().item(), (diff.norm() / ref.float().norm()).item()


def stream_error_study(gen, per_block, sp, b):
    """Every bf16 way to the flagship stack on one input x (B=b): the wgmma K4
    under its planner's plan, under the plan of half the SMs and with every K
    whole, the tile-route K4 (csrc/mixer_stream.cu) and 32 x K2 on the
    per-block weights (LN2 unfolded), each against the plain version ->
    {way: stream_err}."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels import mixer_stream as stream_module
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import mixer_block

    t, d = 256, 1024
    et, ec = sp.t1.shape[1], sp.w1f.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x = torch.randn(b, t, d, generator=gen, device="cuda").to(torch.bfloat16)
    ref = stream_module.mixer_stream_plain(x, sp)
    plans = {}
    for label, n in (("planner's", sms), ("half the SMs'", sms // 2), ("K whole", 1)):
        plan = stream_module.stream_plan(b, t, d, et, ec, n)
        if plan not in plans.values():
            plans[label] = plan
    readings = {}
    with torch.cuda.device(x.device):
        for label, plan in plans.items():
            readings[f"wgmma K4, {label} plan {plan.splits}"] = stream_err(
                stream_module._launch_wgmma(x, sp, plan), ref)
        readings["tile-route K4"] = stream_err(stream_module._launch_tile(x, sp), ref)
    h = x
    for w in per_block:
        h = mixer_block(h, w)
    readings["32 x K2"] = stream_err(h, ref)
    return readings


def dropped_bias_control(x, got, sp, block):
    """The planted fault the error measure must catch: the plain version with
    block `block`'s channel bias b2 dropped, against the kernel's `got` on the
    whole weights -> stream_err."""
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_stream import mixer_stream_plain

    b2 = sp.b2.clone()
    b2[block] = 0
    return stream_err(got, mixer_stream_plain(x, sp._replace(b2=b2)))


def phase_stream(gen):
    """K4 against its plain version (K5's plain version over the depth) at the
    flagship shape, full depth, B=1 and 4, float32 and bf16, each within its
    ceiling of max |plain|, bf16 also within MIXER_BF16_REL_L2 of ||plain||;
    two K4 launches bitwise equal; a planted fault (one block's b2 dropped)
    beyond MIXER_BF16_REL_L2. bf16 at T=49 (a 7 x 7 token grid, rows TMA cannot
    read) on the WMMA-tile route, the same checks. The error of every bf16 way
    to the flagship stack (stream_error_study) on STREAM_ERROR_DRAWS draws of
    weights and input, each within MIXER_BF16_REL_L2. K5 against its plain
    version at B=4 for the first and last block. -> {kernel name: max abs err at
    B=4 in bf16}."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
        mixer_block_stacked,
        mixer_block_stacked_plain,
        stack_mixer_params,
    )
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_stream import (
        STREAM_GEMMS,
        barriers_per_launch,
        gemm_plans,
        mixer_stream,
        mixer_stream_plain,
        stream_grid,
        stream_plan,
        stream_route,
    )

    def check(label, got, ref, tol):
        err, ratio, rel = stream_err(got, ref)
        bf16 = got.dtype == torch.bfloat16
        log(f"[stream] {label}: max abs err {err:.3e}, max|plain| {err / ratio:.3e}, ratio "
            f"{ratio:.3e} (ceiling {tol:g}), ||err||/||plain|| {rel:.3e}"
            + (f" (limit {MIXER_BF16_REL_L2:g})" if bf16 else ""))
        if not (torch.isfinite(got).all().item() and ratio <= tol
                and (not bf16 or rel <= MIXER_BF16_REL_L2)):
            raise AssertionError(f"{label} disagrees with its plain version")
        return err

    def k4_twice(label, x, sp, tol, route):
        before = mixer_stream.launches
        got = mixer_stream(x, sp)
        again = mixer_stream(x, sp)
        torch.cuda.synchronize()
        if mixer_stream.launches - before != 2:
            raise AssertionError("mixer_stream did not launch once per call")
        if stream_route(x, sp) != route:
            raise AssertionError(f"{label} took route {stream_route(x, sp)}, not {route}")
        err = check(label, got, mixer_stream_plain(x, sp), tol)
        if not torch.equal(got, again):
            raise AssertionError(f"two K4 launches differ at {label}")
        return got, err

    worst = {"mixer_stream": 0.0, "mixer_block_stacked": 0.0}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype, tol in ((torch.float32, MIXER_F32_TOL), (torch.bfloat16, MIXER_BF16_TOL)):
        name = str(dtype)[6:]
        _, sp = flagship_stack(gen, dtype)
        for b in STREAM_BATCHES:
            x = torch.randn(b, 256, 1024, generator=gen, device="cuda").to(dtype)
            route = stream_route(x, sp)
            if route == "wgmma":
                plan = stream_plan(b, 256, 1024, 1024, 4096, sms)
                log(f"[stream] K4 B={b} {name}: route wgmma, one launch of "
                    f"{stream_grid(x.device, dtype, route)} persistent CTAs (384 threads), per "
                    f"block LN1 -> g1 -> r -> LN-hat -> g3 -> out; 128 x 128 tiles "
                    f"{dict(zip(STREAM_GEMMS, plan.tiles))}, split-K "
                    f"{dict(zip(STREAM_GEMMS, plan.splits))} of "
                    f"{dict(zip(STREAM_GEMMS, plan.k_split))} K steps of 64; "
                    f"{plan.barriers(STREAM_DEPTH)} grid barriers")
            else:
                plans = gemm_plans(b, 256, 1024, 1024, 4096, dtype, sms)
                log(f"[stream] K4 B={b} {name}: route {route}, one launch of "
                    f"{stream_grid(x.device, dtype)} blocks, "
                    f"{barriers_per_launch(STREAM_DEPTH, plans)} grid barriers, split-K plans "
                    f"{plans}")
            got, err = k4_twice(f"K4 B={b} T=256 D=1024 L={STREAM_DEPTH} {name}", x, sp, tol,
                                route)
            if dtype == torch.bfloat16 and b == 4:
                worst["mixer_stream"] = err
            if dtype == torch.bfloat16 and b == 1:
                for block in STREAM_CONTROL_BLOCKS:
                    _, c_ratio, c_rel = dropped_bias_control(x, got, sp, block)
                    log(f"[stream] planted fault, block {block}'s b2 dropped from the plain "
                        f"version, B={b}: max abs err / max|plain| {c_ratio:.3e}, "
                        f"||err||/||plain|| {c_rel:.3e} (must exceed {MIXER_BF16_REL_L2:g})")
                    if not c_rel > MIXER_BF16_REL_L2:
                        raise AssertionError("the bf16 error limit misses a dropped bias")
        x = torch.randn(4, 256, 1024, generator=gen, device="cuda").to(dtype)
        for idx in (0, STREAM_DEPTH - 1):
            err = check(f"K5 B=4 block {idx} {name}", mixer_block_stacked(x, sp, idx),
                        mixer_block_stacked_plain(x, sp, idx), tol)
            if dtype == torch.bfloat16:
                worst["mixer_block_stacked"] = max(worst["mixer_block_stacked"], err)
    # bf16 at a shape TMA cannot read (T=49: t1's rows of 49): the WMMA-tile K4
    blocks = [random_block_weights(49, 1024, torch.float32, gen) for _ in range(STREAM_DEPTH)]
    sp = stack_mixer_params(blocks, torch.bfloat16)
    del blocks
    for b in STREAM_BATCHES:
        x = torch.randn(b, 49, 1024, generator=gen, device="cuda").to(torch.bfloat16)
        log(f"[stream] K4 B={b} T=49 bf16: route wmma, split-K plans "
            f"{gemm_plans(b, 49, 1024, 196, 4096, torch.bfloat16, sms)}")
        k4_twice(f"K4 B={b} T=49 D=1024 L={STREAM_DEPTH} bf16", x, sp, MIXER_BF16_TOL, "wmma")
    # the bf16 error of every way to the flagship stack, over fresh draws
    for draw in range(STREAM_ERROR_DRAWS):
        per_block, sp = flagship_stack(gen, torch.bfloat16)
        for b in STREAM_BATCHES:
            for way, (_, ratio, rel) in stream_error_study(gen, per_block, sp, b).items():
                log(f"[stream] bf16 error, draw {draw}, B={b}, {way}: max abs err / max|plain| "
                    f"{ratio:.3e}, ||err||/||plain|| {rel:.3e} (limit {MIXER_BF16_REL_L2:g})")
                if not rel <= MIXER_BF16_REL_L2:
                    raise AssertionError(f"{way} disagrees with the plain version, draw {draw}")
    log("[stream] two K4 launches bitwise equal at every batch, dtype and route")
    return worst


def random_mlp_weights(d, e, dtype, gen):
    """One CLIP MLP sublayer's kernel weights (ln_2, c_fc, c_proj), random at
    lecun scales, on the card."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mlp_ln import MlpLnWeights

    def n(*shape, std):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    return MlpLnWeights(ln_w=1 + n(d, std=0.1), ln_b=n(d, std=0.1),
                        w1=n(e, d, std=d ** -0.5).to(dtype), b1=n(e, std=0.1),
                        w2=n(d, e, std=e ** -0.5).to(dtype), b2=n(d, std=0.1))


def phase_mlp_ln(gen):
    """K11 forward and backward (dx alone, and with the six parameter grads)
    against their plain versions at the train loss's shape (MLP_SHAPE,
    quick_gelu) and at a small gelu shape, float32 (TF32 off) and bf16, every
    output within its ceiling of max |plain|; two backward runs bitwise equal.
    -> {kernel name: max abs err at the train shape in bf16}."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mlp_ln import (
        mlp_ln,
        mlp_ln_bwd,
        mlp_ln_bwd_plain,
        mlp_ln_plain,
    )

    worst = {"mlp_ln": 0.0, "mlp_ln_bwd": 0.0}
    for (n, d, e), act in ((MLP_SHAPE, "quick_gelu"), ((100, *MLP_SHAPE[1:]), "quick_gelu"),
                           ((300, 96, 384), "gelu")):
        for dtype, tol in ((torch.float32, MIXER_F32_TOL), (torch.bfloat16, MIXER_BF16_TOL)):
            w = random_mlp_weights(d, e, dtype, gen)
            x = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
            dy = torch.randn(n, d, generator=gen, device="cuda")
            out, g, dg = mlp_ln(x, w, act)
            ref_out, ref_g, ref_dg = mlp_ln_plain(x, w, act)
            full = mlp_ln_bwd(dy, x, g, dg, w, params=True)
            only = mlp_ln_bwd(dy, x, g, dg, w, params=False)
            again = mlp_ln_bwd(dy, x, g, dg, w, params=True)
            torch.cuda.synchronize()
            ref = mlp_ln_bwd_plain(dy, x, g, dg, w, params=True)
            pairs = {
                "mlp_ln": [(out, ref_out), (g, ref_g), (dg, ref_dg)],
                "mlp_ln_bwd": list(zip(full, ref)) + [(only.dx, ref.dx)],
            }
            label = f"N={n} D={d} E={e} {act} {str(dtype)[6:]}"
            for name, outs in pairs.items():
                abs_err = max((a.float() - b.float()).abs().max().item() for a, b in outs)
                ratio = max((a.float() - b.float()).abs().max().item()
                            / max(b.float().abs().max().item(), 1e-30) for a, b in outs)
                finite = all(torch.isfinite(a).all().item() for a, _ in outs)
                log(f"[mlp-ln] {name} {label}: max abs err {abs_err:.3e}, worst err / "
                    f"max|plain| over {len(outs)} outputs {ratio:.3e} (ceiling {tol:g})")
                if not (finite and ratio <= tol):
                    raise AssertionError(f"{name} disagrees with its plain version at {label}")
                if dtype == torch.bfloat16 and (n, d, e) == MLP_SHAPE:
                    worst[name] = abs_err
            if not (all(torch.equal(a, b) for a, b in zip(full, again))
                    and torch.equal(only.dx, full.dx) and all(v is None for v in only[1:])):
                raise AssertionError(f"mlp_ln_bwd differs between runs or modes at {label}")
    log("[mlp-ln] two backward runs bitwise equal, and dx alone equal to dx with the "
        "parameter grads, at every shape and dtype")
    return worst


def phase_c3(gen):
    """The plain backwards of the R, Et and Ts codes (ops/augment.py: weight-matrix
    products for R, the gather's sorted fixed-order segment sum for Et and Ts),
    run twice at 64 crops of 224 px (R from 256 px) in float32: bitwise equal."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops import augment

    b, h, w, c = WARP_SHAPE
    g = torch.randn(WARP_SHAPE, generator=gen, device="cuda")
    noise = torch.rand(b, h, w, 2, generator=gen, device="cuda") * 2 - 1
    src, dst = augment.ts_sample(gen, b, "cuda")
    for code, side, fn in (("R", RECT_IN[1], lambda v: augment.resize_bilinear(v, h)),
                           ("Et", h, lambda v: augment.elastic_warp(v, noise)),
                           ("Ts", h, lambda v: augment.tps_warp(v, src, dst))):
        x = torch.rand(b, side, side, c, generator=gen, device="cuda").requires_grad_()
        first, second = (torch.autograd.grad(fn(x), x, g)[0] for _ in range(2))
        torch.cuda.synchronize()
        same = torch.equal(first, second)
        log(f"[c3] {code} backward at {b}x{side}x{side}x{c} f32, two runs: bitwise equal "
            f"{same}, max |diff| {(first - second).abs().max().item():.3e}, finite "
            f"{torch.isfinite(first).all().item()}")
        if not (same and torch.isfinite(first).all().item()):
            raise AssertionError(f"the {code} backward differs between two runs")


def bound(inputs, outputs, flops, peak):
    """(bound_ms, bound_by): the larger of the bytes the function must move (each
    input read once, each output written once) over the memory rate and its
    operations over the peak rate of their type."""
    import torch

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))

    t_bytes = (nbytes(inputs) + nbytes(outputs)) / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def recorder(smi):
    """The [time] line and JSON row of one kernel: record(label, kernel ms, plain
    ms, (bound ms, bound by), flops, CUDA-graph ms) -> {ms, plain_ms, bound_ms,
    bound_by[, graph_ms]}."""

    def record(label, k_ms, p_ms, bnd, flops=None, g_ms=None):
        rate = f" ({flops / k_ms / 1e9:.1f} TFLOP/s)" if flops else ""
        graph = ""
        if g_ms is not None:
            graph = (f", CUDA-graph replay {g_ms:.4f} ms"
                     + (f" ({flops / g_ms / 1e9:.1f} TFLOP/s)" if flops else ""))
        log(f"[time] {label}: kernel {k_ms:.4f} ms{rate}{graph}, plain {p_ms:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}) ({smi})")
        row = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0], "bound_by": bnd[1]}
        return row if g_ms is None else {**row, "graph_ms": g_ms}

    return record


def vq_timing(gen, smi, record):
    """K1 at N = 256 (1x1), 1024 (2x2), 2048 (the train step's B=8) and 4096 (4x4)
    tokens against the flagship codebook (16384 x 256), f32: eager and from a CUDA
    graph beside the plain version (one f32 matmul and argmin), with the split
    kernel's graph time alone; bound by the six bf16 products on the tensor cores,
    and beside it the f32 CUDA-core bound of one product. -> the row at N=1024."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.vq_lookup import (
        nearest_codebook_indices_kernel,
        nearest_codebook_indices_plain,
        split_pieces,
        vq_plan,
    )

    k, c = 16384, 256
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cb = torch.rand(k, c, generator=gen, device="cuda") * (2.0 / k)
    row = None
    for n in (256, 1024, 2048, 4096):
        x = torch.randn(n, c, generator=gen, device="cuda") * (2.0 / k)
        plan = vq_plan(n, k, c, sms)
        k_ms, p_ms = paired_ms(lambda: nearest_codebook_indices_kernel(x, cb),
                               lambda: nearest_codebook_indices_plain(x, cb))
        g_ms = graph_ms(lambda: nearest_codebook_indices_kernel(x, cb))
        prep_ms = graph_ms(lambda: split_pieces(x, cb, plan.channels))
        out = nearest_codebook_indices_kernel(x, cb)
        flops = 2 * n * k * c
        tensor = bound([x, cb], [out], 6 * flops, "bf16")
        f32 = bound([x, cb], [out], flops, "f32")
        r = record(f"vq N={n} K={k} C={c} f32 (six bf16 products)", k_ms, p_ms, tensor,
                   6 * flops, g_ms)
        log(f"[time] vq N={n}: split kernel alone (CUDA graph) {prep_ms:.4f} ms "
            f"({prep_ms / g_ms:.0%} of the kernel's graph time); f32 CUDA-core bound "
            f"{f32[0]:.4f} ms; plan {plan.splits} splits x {plan.row_blocks} row blocks = "
            f"{plan.ctas} CTAs ({smi})")
        if n == 1024:
            row = {**r, "f32_bound_ms": f32[0], "split_graph_ms": prep_ms}
    return row


def phase_timing(gen, smi):
    """Kernel and plain times (CUDA events) at the paths' shapes, each beside its
    bound; -> {kernel name: {ms, plain_ms, bound_ms, bound_by}} at the shapes the
    JSON line reports (VQ and Mixer block at the slice's B=4, the train kernels at
    the train step's B=8)."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
        mixer_block,
        mixer_block_fwd_res,
        mixer_block_fwd_res_plain,
        mixer_block_plain,
        mixer_channel_bwd,
        mixer_channel_bwd_plain,
        mixer_token_bwd,
        mixer_token_bwd_plain,
    )

    record = recorder(smi)
    times = {"vq_argmin": vq_timing(gen, smi, record)}
    t, d, et, ec = 256, 1024, 1024, 4096
    for b in (1, 4, 16):
        w = random_block_weights(t, d, torch.bfloat16, gen)
        x = torch.randn(b, t, d, generator=gen, device="cuda").to(torch.bfloat16)
        k_ms, p_ms = paired_ms(lambda: mixer_block(x, w), lambda: mixer_block_plain(x, w))
        flops = b * 2 * t * d * (2 * et + 2 * ec)
        bnd = bound([x, *w], [x], flops, "bf16")
        row = record(f"mixer block B={b} T={t} D={d} bf16", k_ms, p_ms, bnd,
                     flops, graph_ms(lambda: mixer_block(x, w)))
        if b == 4:
            times["mixer_block"] = row
    b = 8
    w = random_block_weights(t, d, torch.bfloat16, gen)
    x = torch.randn(b, t, d, generator=gen, device="cuda").to(torch.bfloat16)
    dout = torch.randn(b, t, d, generator=gen, device="cuda")
    out, res = mixer_block_fwd_res(x, w)
    ch = mixer_channel_bwd(dout, res, w)
    tok = mixer_token_bwd(ch.dr, x, res.g1, res.dg1, w)
    fwd_flops = b * 2 * t * d * (2 * et + 2 * ec)
    cases = {
        "mixer_fwd_res": (lambda: mixer_block_fwd_res(x, w),
                          lambda: mixer_block_fwd_res_plain(x, w),
                          bound([x, *w], [out, *res], fwd_flops, "bf16"), fwd_flops),
        "mixer_channel_bwd": (lambda: mixer_channel_bwd(dout, res, w),
                              lambda: mixer_channel_bwd_plain(dout, res, w),
                              bound([dout, res.rhat, res.inv2, res.g3, res.dg3, w.ln2_w, w.ln2_b,
                                     w.w1, w.w2], list(ch), 4 * 2 * b * t * d * ec, "bf16"),
                              4 * 2 * b * t * d * ec),
        "mixer_token_bwd": (lambda: mixer_token_bwd(ch.dr, x, res.g1, res.dg1, w),
                            lambda: mixer_token_bwd_plain(ch.dr, x, res.g1, res.dg1, w),
                            bound([ch.dr, x, res.g1, res.dg1, w.ln1_w, w.ln1_b, w.t1, w.t2],
                                  list(tok), 4 * 2 * b * et * t * d, "bf16"),
                            4 * 2 * b * et * t * d),
    }
    for name, (kernel_fn, plain_fn, bnd, flops) in cases.items():
        k_ms, p_ms = paired_ms(kernel_fn, plain_fn)
        times[name] = record(f"{name} B={b} T={t} D={d} bf16", k_ms, p_ms, bnd, flops,
                             graph_ms(kernel_fn))
    mixer_gemm_timing(gen, smi)
    times.update(stream_timing(gen, smi, record))
    times.update(warp_timing(gen, smi, record))
    times.update(mlp_ln_timing(gen, smi, record))
    return times


def stream_timing(gen, smi, record):
    """K4 at B=1 and 4 (eager and from a CUDA graph, and its plan against the
    plan without split-K in turns; beside 32 x K2, eager and from one CUDA
    graph, and 32 x K5 on the same weights) and K5 at B=4, bf16, full depth;
    -> {kernel name: row} at B=4."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels import mixer_stream as stream_module
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
        StackedMixerWeights,
        mixer_block,
        mixer_block_stacked,
        mixer_block_stacked_plain,
    )
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_stream import (
        mixer_stream,
        mixer_stream_plain,
        stream_plan,
    )

    t, d, et, ec = 256, 1024, 1024, 4096
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_block, sp = flagship_stack(gen, torch.bfloat16)
    rows = {}
    for b in STREAM_BATCHES:
        x = torch.randn(b, t, d, generator=gen, device="cuda").to(torch.bfloat16)

        def k2_stack():
            h = x
            for w in per_block:
                h = mixer_block(h, w)
            return h

        def k5_stack():
            h = x
            for i in range(STREAM_DEPTH):
                h = mixer_block_stacked(h, sp, i)
            return h

        k_ms, p_ms = paired_ms(lambda: mixer_stream(x, sp), lambda: mixer_stream_plain(x, sp))
        k5_ms, k2_ms = paired_ms(k5_stack, k2_stack)
        k2_graph = graph_ms(k2_stack, iters=5)
        k4_graph = graph_ms(lambda: mixer_stream(x, sp), iters=5)
        # the plan against the plan of one SM (every K whole), in turns
        plan, whole = stream_plan(b, t, d, et, ec, sms), stream_plan(b, t, d, et, ec, 1)
        with torch.cuda.device(x.device):
            whole_ms, plan_ms = paired_ms(lambda: stream_module._launch_wgmma(x, sp, whole),
                                          lambda: stream_module._launch_wgmma(x, sp, plan))
        flops = b * 2 * t * d * (2 * et + 2 * ec) * STREAM_DEPTH
        row = record(f"mixer_stream (K4) B={b} T={t} D={d} L={STREAM_DEPTH} bf16", k_ms, p_ms,
                     bound([x, *sp], [x], flops, "bf16"), flops, k4_graph)
        log(f"[time] mixer stack B={b} bf16: K4 (one launch) {k_ms:.4f} ms, from a CUDA graph "
            f"{k4_graph:.4f} ms; 32 x K2 {k2_ms:.4f} ms, 32 x K5 {k5_ms:.4f} ms, 32 x K2 "
            f"replayed from one CUDA graph {k2_graph:.4f} ms ({smi})")
        log(f"[time] mixer stack B={b} bf16: K4 without split-K {whole_ms:.4f} ms against "
            f"its plan {plan_ms:.4f} ms (splits {plan.splits}) ({smi})")
        if b == 4:
            rows["mixer_stream"] = row
    x = torch.randn(4, t, d, generator=gen, device="cuda").to(torch.bfloat16)
    flops = 4 * 2 * t * d * (2 * et + 2 * ec)
    k_ms, p_ms = paired_ms(lambda: mixer_block_stacked(x, sp, 0),
                           lambda: mixer_block_stacked_plain(x, sp, 0))
    views = [getattr(sp, name)[0] for name in StackedMixerWeights._fields]
    rows["mixer_block_stacked"] = record(f"mixer_block_stacked (K5) B=4 T={t} D={d} bf16", k_ms,
                                         p_ms, bound([x, *views], [x], flops, "bf16"), flops,
                                         graph_ms(lambda: mixer_block_stacked(x, sp, 0)))
    return rows


def grid_sample_grid(m, x, out_hw):
    """The sample points of m's output frame as grid_sample's [-1, 1] grid
    (align_corners=True over x's (h, w) frame), in x's dtype."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops import augment

    h, w = x.shape[1:3]
    sx, sy = augment.inverse_coords(m, *out_hw)
    return torch.stack([sx * (2.0 / (w - 1)) - 1, sy * (2.0 / (h - 1)) - 1], -1).to(x.dtype)


def grid_sample_adjoint(x, g, m, mode):
    """() -> grid_sample's input gradient for output gradient g (NHWC) at m's samples
    of x's frame: the PyTorch call K10 is held against (grid build and permutes in)."""
    import torch

    pad = {"zeros": 0, "border": 1}[mode]
    out_hw = tuple(g.shape[1:3])
    return lambda: torch.ops.aten.grid_sampler_2d_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), grid_sample_grid(m, x, out_hw), 0, pad,
        True, [True, False])[0].permute(0, 2, 3, 1).contiguous()


def time_warp_pair(x, g, m, mode, label, smi, record):
    """K9 from x's frame onto g's and K10 back, bf16, each beside its plain
    version and grid_sample's forward or input gradient on the same NHWC data;
    -> {kernel name: row with library_ms}."""
    import torch.nn.functional as F

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_adjoint import (
        warp_adjoint,
        warp_adjoint_plain,
    )
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_forward import (
        warp_forward,
        warp_forward_plain,
    )

    b, h, w, c = x.shape
    out_hw, in_hw = tuple(g.shape[1:3]), (h, w)
    # per output pixel: s(q) (6 products, 6 sums, 2 divides, clamps) and 9 flops a channel
    ops = b * out_hw[0] * out_hw[1] * (20 + 9 * c)
    frames = f"{b}x{h}x{w}x{c}" + (f" -> {out_hw[0]}x{out_hw[1]}" if out_hw != in_hw else "")

    def grid():
        return grid_sample_grid(m, x, out_hw)

    def lib_fwd():
        return F.grid_sample(x.permute(0, 3, 1, 2), grid(), "bilinear", mode,
                             align_corners=True).permute(0, 2, 3, 1).contiguous()

    lib_bwd = grid_sample_adjoint(x, g, m, mode)

    out = warp_forward(x, m, mode, out_hw)
    rows = {}
    for name, kernel_fn, plain_fn, lib_fn, moved in (
            ("warp_forward", lambda: warp_forward(x, m, mode, out_hw),
             lambda: warp_forward_plain(x, m, mode, out_hw), lib_fwd, ([x, m], [out])),
            ("warp_adjoint", lambda: warp_adjoint(g, m, mode, in_hw),
             lambda: warp_adjoint_plain(g, m, mode, in_hw), lib_bwd, ([g, m], [x]))):
        k_ms, p_ms = paired_ms(kernel_fn, plain_fn)
        lib_ms = (cuda_ms(lib_fn) + cuda_ms(lib_fn)) / 2
        row = record(f"{name} {label} {mode} {frames} {str(x.dtype)[6:]}", k_ms, p_ms,
                     bound(*moved, ops, "f32"), g_ms=graph_ms(kernel_fn))
        log(f"[time] {name} {label}: grid_sample {'backward' if 'adj' in name else 'forward'} "
            f"{lib_ms:.4f} ms (bf16, with the grid build and the NHWC permutes) against the "
            f"kernel's {k_ms:.4f} ms: kernel {'faster' if k_ms < lib_ms else 'slower'} ({smi})")
        rows[name] = {**row, "library_ms": lib_ms}
    return rows


def warp_timing(gen, smi, record):
    """K9 and K10 at the train step's shape in bf16, for its Af (border) and Pe
    (zeros) draws; -> {kernel name: the mean over the two draws (one launch each
    per step), with under "rect" the row from 256 to 224 px (64 unpooled renders
    cut by the Re sampler's boxes, the [trainer-crops] path's warp)}."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops import augment
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_forward import warp_forward

    b, h, w, c = WARP_SHAPE
    x = torch.rand(WARP_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(WARP_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    rows = [time_warp_pair(x, g, m, mode, draw, smi, record)
            for draw, (m, mode) in warp_draws(gen, b, h, w).items()]
    times = {name: {k: (rows[0][name][k] + rows[1][name][k]) / 2 if k != "bound_by"
                    else rows[0][name][k] for k in rows[0][name]} for name in rows[0]}
    rb, rh, rw, rc = RECT_IN
    m_re = augment.crop_matrices(*augment.re_sample(gen, rb, rh, rw, augment.RE_SCALE, "cuda"),
                                 h)
    x = torch.rand(RECT_IN, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((rb, h, w, rc), generator=gen, device="cuda").to(torch.bfloat16)
    for name, row in time_warp_pair(x, g, m_re, "border", "Re", smi, record).items():
        times[name]["rect"] = {"shape": f"{rb}x{rh}x{rw}x{rc} -> {h}x{w}", **row}
    # K9's device time in float32 too, on the same draws
    x32 = torch.rand(WARP_SHAPE, generator=gen, device="cuda")
    for draw, (m, mode) in warp_draws(gen, b, h, w).items():
        f32_ms = graph_ms(lambda: warp_forward(x32, m, mode))
        log(f"[time] warp_forward {draw} {mode} {b}x{h}x{w}x{c} f32: CUDA-graph replay "
            f"{f32_ms:.4f} ms, bound {bound([x32, m], [x32], 0, 'f32')[0]:.4f} ms (bytes) ({smi})")
    x32 = torch.rand(RECT_IN, generator=gen, device="cuda")
    f32_ms = graph_ms(lambda: warp_forward(x32, m_re, "border", (h, w)))
    log(f"[time] warp_forward Re border {rb}x{rh}x{rw}x{rc} -> {h}x{w} f32: CUDA-graph replay "
        f"{f32_ms:.4f} ms, bound {bound([x32, m_re], [x32[:, :h, :w]], 0, 'f32')[0]:.4f} ms "
        f"(bytes) ({smi})")
    return times


def mlp_ln_timing(gen, smi, record):
    """K11 at the train loss's shape (MLP_SHAPE, quick_gelu, bf16): the forward,
    and the backward in the frozen tower's dx-only mode (what the train step
    launches) and with the parameter grads, each beside its plain version and
    the eager module sublayer (`ln_2` -> `mlp` of clip_vit.py with its residual,
    and its autograd backward to x) as the yardstick; -> {kernel name: row}."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import ResidualAttentionBlock
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mlp_ln import (
        MlpLnWeights,
        mlp_ln,
        mlp_ln_bwd,
        mlp_ln_bwd_plain,
        mlp_ln_plain,
    )

    n, d, e = MLP_SHAPE
    dt = torch.bfloat16
    blk = ResidualAttentionBlock(d, 12, dtype=dt, device="cuda").requires_grad_(False)
    w32 = random_mlp_weights(d, e, torch.float32, gen)
    with torch.no_grad():
        for p, v in zip((blk.ln_2.weight, blk.ln_2.bias, blk.mlp.c_fc.weight, blk.mlp.c_fc.bias,
                         blk.mlp.c_proj.weight, blk.mlp.c_proj.bias), w32):
            p.copy_(v)
    w = MlpLnWeights(*(v.to(dt) if name in ("w1", "w2") else v
                       for name, v in zip(MlpLnWeights._fields, w32)))
    x = torch.randn(n, d, generator=gen, device="cuda").to(dt)
    dy = torch.randn(n, d, generator=gen, device="cuda")
    out, g, dg = mlp_ln(x, w, "quick_gelu")
    eager_fwd = lambda: x + blk.mlp(blk.ln_2(x))  # noqa: E731
    xr = x.detach().requires_grad_()
    y = xr + blk.mlp(blk.ln_2(xr))
    dyd = dy.to(dt)
    eager_bwd = lambda: torch.autograd.grad(y, xr, dyd, retain_graph=True)  # noqa: E731
    only = mlp_ln_bwd(dy, x, g, dg, w, params=False)
    w_bytes = list(w)
    flops = 2 * 2 * n * d * e  # two products of (n, d) x (d, e)
    rows = {}
    for name, kernel_fn, plain_fn, eager_fn, ins, outs, ops in (
            ("mlp_ln", lambda: mlp_ln(x, w, "quick_gelu"),
             lambda: mlp_ln_plain(x, w, "quick_gelu"), eager_fwd, [x, *w_bytes],
             [out, g, dg], flops),
            ("mlp_ln_bwd", lambda: mlp_ln_bwd(dy, x, g, dg, w, params=False),
             lambda: mlp_ln_bwd_plain(dy, x, g, dg, w, params=False), eager_bwd,
             [dy, x, g, dg, w.ln_w, w.w1, w.w2], [only.dx], flops)):
        k_ms, p_ms = paired_ms(kernel_fn, plain_fn)
        eager_ms = (cuda_ms(eager_fn) + cuda_ms(eager_fn)) / 2
        row = record(f"{name} (K11) N={n} D={d} E={e} quick_gelu bf16"
                     f"{' dx only' if name == 'mlp_ln_bwd' else ''}", k_ms, p_ms,
                     bound(ins, outs, ops, "bf16"), ops)
        log(f"[time] {name}: eager module sublayer {'backward to x' if 'bwd' in name else ''}"
            f" {eager_ms:.4f} ms ({ops / eager_ms / 1e9:.1f} TFLOP/s; cuBLAS bf16 with the "
            f"LayerNorm and activation passes) against the kernel's {k_ms:.4f} ms "
            f"({ops / k_ms / 1e9:.1f} TFLOP/s) ({smi})")
        rows[name] = {**row, "eager_ms": eager_ms}
    gemm_widths(x, dy, g, dg, w, smi)
    full = mlp_ln_bwd(dy, x, g, dg, w, params=True)
    k_ms, p_ms = paired_ms(lambda: mlp_ln_bwd(dy, x, g, dg, w, params=True),
                           lambda: mlp_ln_bwd_plain(dy, x, g, dg, w, params=True))
    record(f"mlp_ln_bwd (K11) N={n} D={d} E={e} bf16 with the parameter grads", k_ms, p_ms,
           bound([dy, x, g, dg, *w_bytes], list(full), 2 * flops, "bf16"), 2 * flops)
    return rows


def gemm_widths(x, dy, g, dg, w, smi):
    """K11's four GEMMs (csrc/wgmma_gemm.cuh) alone at the train loss's shape, at
    each compiled tile width, CUDA events: ms and TFLOP/s, the planner's pick
    marked."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels import wgmma
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import _Launcher

    n, d = x.shape
    e = w.w1.shape[0]
    k = _Launcher(x.device, x.dtype)
    g2, dg2, da = (torch.empty_like(g) for _ in range(3))
    out, dxn = torch.empty_like(x), torch.empty(n, d, device=x.device)
    dyd = dy.to(x.dtype)
    gemms = (  # name, (M, N, K), launch at a width
        ("fc1", (n, e, d), lambda bn: wgmma.gemm(k, x, w.w1, g2, n, e, d, "act", bias=w.b1,
                                                 aux=dg2, act=1, bn=bn)),
        ("fc2", (n, d, e), lambda bn: wgmma.gemm(k, g, w.w2, out, n, d, e, "res", bias=w.b2,
                                                 res=x, bn=bn)),
        ("dgh", (n, e, d), lambda bn: wgmma.gemm(k, dyd, w.w2, da, n, e, d, "mul",
                                                 b_mn_major=True, mul=dg, bn=bn)),
        ("dxn", (n, d, e), lambda bn: wgmma.gemm(k, da, w.w1, dxn, n, d, e, "f32",
                                                 b_mn_major=True, bn=bn)),
    )
    for name, (mm, nn, kk), launch in gemms:
        pick = wgmma.wgmma_plan(mm, nn, k.sms)[0]
        cells = []
        for bn in wgmma.WGMMA_WIDTHS:
            ms = cuda_ms(lambda: launch(bn))
            cells.append(f"{bn}: {ms:.4f} ms {2 * mm * nn * kk / ms / 1e9:.1f} TFLOP/s"
                         f"{' (planned)' if bn == pick else ''}")
        log(f"[time] K11 GEMM {name} M={mm} N={nn} K={kk} by tile width: {'; '.join(cells)} "
            f"({smi})")


def mixer_gemm_timing(gen, smi):
    """The Mixer block's GEMMs alone at the flagship widths (T=256, D=1024, Et=1024,
    Ec=4096), bf16, CUDA events: K6's, K7's and K8's four at B=8 and K2's four at
    B=1, 4 and 16 (K8's dt2 and dt1 with their ordered batch sum), each on the wgmma GEMM at every compiled tile width (the
    planner's pick marked), on the WMMA tile of csrc/mixer_tile.cuh (split-K
    where its plan splits), and as one torch.matmul of the same bf16 product
    (cuBLAS: a yardstick only, on no path), with TFLOP/s; the route's pick marked.
    Device times: each launch replayed from a CUDA graph (`graph_ms`).
    -> {(chain, name, B): {"wgmma": ms at the planned width, "wmma": ms}}."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels import wgmma
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
        _Launcher,
        mixer_gemm_route,
    )

    t, d, et, ec = 256, 1024, 1024, 4096
    dt = torch.bfloat16

    def launcher():  # per call: it takes the current stream, the graph's while capturing
        return _Launcher(torch.device("cuda"), dt)

    k = launcher()
    w = random_block_weights(t, d, dt, gen)

    def act(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(dt)

    def empty(*shape, dtype=dt):
        return torch.empty(*shape, dtype=dtype, device="cuda")

    rows = {}
    for chain, b in (("K6", 8), ("K7", 8), ("K8", 8), ("K2", 1), ("K2", 4), ("K2", 16)):
        bt = b * t
        xn, x, g1, r = act(b, t, d), act(b, t, d), act(b, et, d), act(b, t, d)
        rn, g3, dout, da3 = act(bt, d), act(bt, ec), act(bt, d), act(bt, ec, std=0.1)
        save = chain == "K6"
        a_ = "act" if save else "act_only"
        aux = (lambda *s: empty(*s)) if save else (lambda *s: None)
        if chain == "K7":
            gemms = (  # name, a, b, c, (m, n, k), wgmma kwargs, cuBLAS product
                ("da3", dout, w.w2, empty(bt, ec), (bt, ec, d), "mul",
                 dict(b_mn_major=True, mul=g3, aux=empty(bt, ec, dtype=torch.float32)),
                 lambda: dout @ w.w2),
                ("drn", da3, w.w1, empty(bt, d, dtype=torch.float32), (bt, d, ec), "f32",
                 dict(b_mn_major=True), lambda: da3 @ w.w1),
                ("dw2", dout, g3, empty(d, ec, dtype=torch.float32), (d, ec, bt), "f32",
                 dict(a_m_major=True, b_mn_major=True), lambda: dout.T @ g3),
                ("dw1", da3, rn, empty(ec, d, dtype=torch.float32), (ec, d, bt), "f32",
                 dict(a_m_major=True, b_mn_major=True), lambda: da3.T @ rn),
            )
        elif chain == "K8":  # cuBLAS: the batch's products, without K8's ordered sum
            drd, da1, dg1 = act(b, t, d), act(b, et, d, std=0.1), act(b, et, d)
            gemms = (
                ("da1", w.t2, drd, empty(b, et, d), (et, d, t), "mul",
                 dict(a_m_major=True, b_mn_major=True, batch=b, sb=t * d, sc=et * d, mul=dg1,
                      aux=empty(b, et, d, dtype=torch.float32)),
                 lambda: torch.matmul(w.t2.T, drd)),
                ("dxn", w.t1, da1, empty(b, t, d, dtype=torch.float32), (t, d, et), "f32",
                 dict(a_m_major=True, b_mn_major=True, batch=b, sb=et * d, sc=t * d),
                 lambda: torch.matmul(w.t1.T, da1)),
                ("dt2", drd, g1, empty(t, et, dtype=torch.float32), (t, et, d), "f32",
                 dict(batch=b, sa=t * d, sb=et * d, batch_sum=True),
                 lambda: torch.bmm(drd, g1.transpose(1, 2))),
                ("dt1", da1, xn, empty(et, t, dtype=torch.float32), (et, t, d), "f32",
                 dict(batch=b, sa=et * d, sb=t * d, batch_sum=True),
                 lambda: torch.bmm(da1, xn.transpose(1, 2))),
            )
        else:
            gemms = (
                ("g1", w.t1, xn, empty(b, et, d), (et, d, t), a_,
                 dict(b_mn_major=True, batch=b, sb=t * d, sc=et * d, bias=w.t1b, bias_rows=True,
                      aux=aux(b, et, d)), lambda: torch.matmul(w.t1, xn)),
                ("r", w.t2, g1, empty(b, t, d), (t, d, et), "res",
                 dict(b_mn_major=True, batch=b, sb=et * d, sc=t * d, bias=w.t2b, bias_rows=True,
                      res=x), lambda: torch.matmul(w.t2, g1)),
                ("g3", rn, w.w1, empty(bt, ec), (bt, ec, d), a_,
                 dict(bias=w.b1, aux=aux(bt, ec)), lambda: rn @ w.w1.T),
                ("out", g3, w.w2, empty(bt, d), (bt, d, ec), "res", dict(bias=w.b2, res=r.view(bt, d)),
                 lambda: g3 @ w.w2.T),
            )
        for name, a, bm, c, (m, n, kk), epi, kw, cublas in gemms:
            batch = kw.get("batch", 1)
            flops = 2 * m * n * kk * batch
            pick = wgmma.wgmma_plan(m, n, k.sms, batch)[0]
            route = mixer_gemm_route(name, t, d, et, ec, dt, (a, bm, c))
            cells, row = [], {}
            for bn in wgmma.WGMMA_WIDTHS:
                ms = graph_ms(lambda: wgmma.gemm(launcher(), a, bm, c, m, n, kk, epi, bn=bn,
                                                 **kw))
                cells.append(f"{bn}: {ms:.4f} ms {flops / ms / 1e9:.1f} TFLOP/s"
                             f"{' (planned)' if bn == pick else ''}")
                if bn == pick:
                    row["wgmma"] = ms
            row["wmma"] = graph_ms(lambda: launcher().mm("wmma", a, bm, c, m, n, kk, epi, **kw))
            lib_ms = graph_ms(cublas)
            log(f"[time] Mixer GEMM {chain} {name} B={b} M={m} N={n} K={kk}"
                f"{f' x{batch}' if batch > 1 else ''} ({route} routed): wgmma {'; '.join(cells)}; "
                f"WMMA tile {row['wmma']:.4f} ms {flops / row['wmma'] / 1e9:.1f} TFLOP/s; "
                f"torch.matmul bf16 {lib_ms:.4f} ms {flops / lib_ms / 1e9:.1f} TFLOP/s ({smi})")
            rows[(chain, name, b)] = row
    return rows


def warp_against(parent):
    """`python3 chip_smoke.py --warp-against DIR`: K9 and K10 of this tree against the
    warp forward and adjoint of another tree's csrc/warp.cu (DIR, a checkout unpacked
    with git archive), built with nvcc beside this tree's kernels: bitwise equality on
    every draw of the [warp] phase (`warp_cases`), f32 and bf16, and the times of both
    trees' kernels and of grid_sample's forward and input gradient (bf16, in turns
    other, this, this, other; the kernels eager and from a CUDA graph). The card's line
    is printed last."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from feed_forward_vqgan_clip_tpu_torch.ops.kernels import build
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_adjoint import warp_adjoint
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_forward import warp_forward

    smi = phase_device()
    build.load_library()
    src = os.path.join(parent, "feed_forward_vqgan_clip_tpu_torch", "csrc", "warp.cu")
    lib_path = build.BUILD_DIR / "warp_other.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), src], check=True,
                   capture_output=True, timeout=600)
    other = ctypes.CDLL(str(lib_path))
    for name in ("ffvc_warp_forward", "ffvc_warp_adjoint"):
        getattr(other, name).argtypes = build._SIGNATURES[name]

    def other_call(name, src_t, m, mode, in_hw, out_hw):
        """The other tree's K9 (name ffvc_warp_forward: src_t an image of in_hw) or K10
        (ffvc_warp_adjoint: src_t a gradient of out_hw)."""
        b, c = src_t.shape[0], src_t.shape[3]
        dst = src_t.new_empty(b, *(out_hw if name == "ffvc_warp_forward" else in_hw), c)
        err = getattr(other, name)(src_t.data_ptr(), m.contiguous().data_ptr(), dst.data_ptr(),
                                   b, *in_hw, *out_hw, c, int(mode == "border"),
                                   int(src_t.dtype == torch.bfloat16),
                                   build.stream_handle(src_t.device))
        if err:
            raise RuntimeError(f"the other tree's {name}: CUDA error {err}")
        return dst

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timed = ("Af", "Pe", "Af extremes", "Re")
    for label, m, mode, shape, out_hw in warp_cases(gen):
        in_hw = tuple(shape[1:3])
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.rand(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn((shape[0], *out_hw, shape[3]), generator=gen, device="cuda").to(dtype)
            for kernel, this, theirs in (
                    ("K9", warp_forward(x, m, mode, out_hw),
                     other_call("ffvc_warp_forward", x, m, mode, in_hw, out_hw)),
                    ("K10", warp_adjoint(g, m, mode, in_hw),
                     other_call("ffvc_warp_adjoint", g, m, mode, in_hw, out_hw))):
                same = torch.equal(this, theirs)
                log(f"[warp-against] {kernel} {label} {mode} {str(dtype)[6:]}: bitwise equal to "
                    f"the other tree's {same}")
                if not same:
                    raise AssertionError(f"{kernel} differs from the other tree's at {label} "
                                         f"{dtype}")
            if dtype != torch.bfloat16 or not any(label.startswith(t + " ") for t in timed):
                continue
            pairs = (
                ("K9", lambda: warp_forward(x, m, mode, out_hw),
                 lambda: other_call("ffvc_warp_forward", x, m, mode, in_hw, out_hw),
                 lambda: F.grid_sample(x.permute(0, 3, 1, 2), grid_sample_grid(m, x, out_hw),
                                       "bilinear", mode, align_corners=True
                                       ).permute(0, 2, 3, 1).contiguous(),
                 "grid_sample"),
                ("K10", lambda: warp_adjoint(g, m, mode, in_hw),
                 lambda: other_call("ffvc_warp_adjoint", g, m, mode, in_hw, out_hw),
                 grid_sample_adjoint(x, g, m, mode), "grid_sampler_2d_backward"))
            for kernel, this_fn, other_fn, lib_fn, lib_name in pairs:
                this_ms, other_ms = paired_ms(this_fn, other_fn)
                this_g, other_g = graph_ms(this_fn), graph_ms(other_fn)
                lib_ms = cuda_ms(lib_fn)
                log(f"[warp-against] {kernel} {label} {mode} bf16: this tree {this_ms:.4f} ms "
                    f"(CUDA graph {this_g:.4f}), the other tree {other_ms:.4f} ms (CUDA graph "
                    f"{other_g:.4f}), {lib_name} {lib_ms:.4f} ms ({smi})")
    print(smi, flush=True)
    return 0


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


@contextlib.contextmanager
def bpe_table(folder, merges=BPE_MERGES):
    """`merges` (BPE_MERGES) written to `folder` as a .txt.gz and read through
    FFVC_BPE_PATH while the block runs."""
    from feed_forward_vqgan_clip_tpu_torch.tokenizer import bpe

    path = os.path.join(folder, f"bpe_merges_{len(merges)}.txt.gz")
    with gzip.open(path, "wt", encoding="utf-8") as fd:
        fd.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    old = os.environ.get("FFVC_BPE_PATH")
    os.environ["FFVC_BPE_PATH"] = path
    bpe.get_tokenizer.cache_clear()
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("FFVC_BPE_PATH")
        else:
            os.environ["FFVC_BPE_PATH"] = old
        bpe.get_tokenizer.cache_clear()


def read_png(path):
    from feed_forward_vqgan_clip_tpu_torch.io.images import decode_png

    with open(path, "rb") as f:
        return decode_png(f.read())


def phase_serve_reference():
    """The tiny Predictor, float32, the same weights on the card and on the CPU:
    a 2x2 grid (K4 on the card) and a 3x3 grid (n = 9: K2 per block), PNGs
    within 2/255 of the CPU's (plain versions and the module path)."""
    import numpy as np
    import torch

    from feed_forward_vqgan_clip_tpu_torch.config import make_config
    from feed_forward_vqgan_clip_tpu_torch.io.checkpoint import save_model
    from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
    from feed_forward_vqgan_clip_tpu_torch.models.vqgan import latent_bounds
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import mixer_block
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_stream import mixer_stream
    from feed_forward_vqgan_clip_tpu_torch.serve.predictor import Predictor

    cfg = dict(clip_model="tiny", vqgan_arch=TINY_VQGAN, model_type="mlp_mixer", dim=64, depth=2,
               dropout=0, vq_image_size=4, compute_dtype="float32", noise_dim=0,
               normalize_input=True)
    mapper = build_mapper(make_config(**cfg), vq_channels=8)
    mapper.init_random_(torch.Generator().manual_seed(SEED + 3))
    with tempfile.TemporaryDirectory() as tmp, bpe_table(tmp):
        path = save_model(os.path.join(tmp, "tiny.th"), mapper, cfg)
        cpu, card = Predictor([path], device="cpu"), Predictor([path], device="cuda")
        cpu.setup()
        card.setup()
        for key, perc in cpu.perceptors.items():
            card.perceptors[key].module.load_state_dict(perc.module.state_dict())
        for key, (vq, _) in cpu.vqgans.items():
            card_vq = card.vqgans[key][0]
            card_vq.load_state_dict(vq.state_dict())
            card.vqgans[key] = (card_vq, latent_bounds(card_vq))
        for grid, k4, k2 in (("2x2", 1, 0), ("3x3", 0, 2)):
            counts = (mixer_stream.launches, mixer_block.launches)
            got = read_png(card.predict(PROMPT, "tiny.th", grid_size=grid, seed=SEED,
                                        out_path=os.path.join(tmp, "card.png")))
            launched = (mixer_stream.launches - counts[0], mixer_block.launches - counts[1])
            want = read_png(cpu.predict(PROMPT, "tiny.th", grid_size=grid, seed=SEED,
                                        out_path=os.path.join(tmp, "cpu.png")))
            diff = int(np.abs(got.astype(np.int32) - want).max())
            log(f"[reference] tiny Predictor f32 grid {grid}, card vs CPU: PNG {got.shape}, max "
                f"pixel difference {diff}/255 (limit 2), launches K4 {launched[0]}, K2 "
                f"{launched[1]}")
            if got.shape != want.shape or diff > 2 or launched != (k4, k2):
                raise AssertionError(f"the card's Predictor disagrees with the CPU at {grid}")


def phase_slice(smi):
    """The flagship slice answers requests of batch 1, 4 and 16 through the kernels,
    per block (K2) and then in stream mode (K4 at batch <= 8, K5 per block above)."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.entry import entry, example_tokens
    from feed_forward_vqgan_clip_tpu_torch.io.images import save_grid
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import mixer_block
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.vq_lookup import (
        nearest_codebook_indices_kernel as vq_kernel,
    )

    t0 = time.perf_counter()
    prompt_to_image, _ = entry("cuda", batch=4, seed=SEED)
    # warm-up at every request size, outside the counted run: after a batch-1
    # warm-up alone, the median batch-4 latency of one tree ranged 31.9-49.1 ms
    # between runs on an H100 (first requests at a new size pay one-time costs)
    for b in REQUEST_BATCHES:
        prompt_to_image(example_tokens(b, "cuda"))
    torch.cuda.synchronize()
    log(f"[slice] flagship generator built and warmed in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    vq_kernel.launches = 0
    mixer_block.launches = 0
    block_ms, block_images = {}, {}
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
        block_ms[b], block_images[b] = lat * 1e3, images
        log(f"[slice] batch {b}: median latency {lat * 1e3:.2f} ms of 3, {b / lat:.2f} img/s, "
            f"image mean {images.mean().item():.4f} ({smi})")
    launches = {"vq": vq_kernel.launches, "mixer_block": mixer_block.launches}
    log(f"[slice] launches in the run: {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches["mixer_block_stacked"] = slice_stream_mode(smi, block_ms, block_images)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "chip_smoke_grid.png")
        save_grid(images.cpu().numpy(), path, nrow=8)
        with open(path, "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError("PNG grid was not written")
        log(f"[slice] wrote {path} ({os.path.getsize(path)} bytes)")
    return launches


def slice_stream_mode(smi, block_ms, block_images):
    """`entry(stream_mixer=True)` on the tokens of the per-block run: K4 once per
    request at batch <= 8, K5 32 times at batch 16, VQ once. The images are held
    to nothing here (the folded LN2 rounds otherwise in bf16; [stream] holds K4
    and K5 to their plain versions), only their mean difference is printed. ->
    K5's launches in the run."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.entry import entry, example_tokens
    from feed_forward_vqgan_clip_tpu_torch.models.mappers.fused import STREAM_MAX_BATCH
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import mixer_block_stacked
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_stream import mixer_stream
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.vq_lookup import (
        nearest_codebook_indices_kernel as vq_kernel,
    )

    prompt_to_image, _ = entry("cuda", batch=4, seed=SEED, stream_mixer=True)
    for b in REQUEST_BATCHES:
        prompt_to_image(example_tokens(b, "cuda"))
    torch.cuda.synchronize()
    counters = (vq_kernel, mixer_stream, mixer_block_stacked)
    for fn in counters:
        fn.launches = 0
    for b in REQUEST_BATCHES:
        tokens = example_tokens(b, "cuda")
        want = (1, 1, 0) if b <= STREAM_MAX_BATCH else (1, 0, STREAM_DEPTH)
        latencies = []
        for _ in range(3):
            before = [fn.launches for fn in counters]
            t = time.perf_counter()
            images = prompt_to_image(tokens)
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t)
            launched = tuple(fn.launches - c for fn, c in zip(counters, before))
            if launched != want:
                raise AssertionError(f"stream mode batch {b}: launches (vq, K4, K5) {launched}, "
                                     f"need {want}")
        if not (tuple(images.shape) == (b, 256, 256, 3) and torch.isfinite(images).all().item()
                and images.min().item() >= 0.0 and images.max().item() <= 1.0):
            raise AssertionError(f"stream mode batch {b}: images not finite in [0, 1]")
        lat = sorted(latencies)[1] * 1e3
        diff = (images - block_images[b]).abs().mean().item()
        log(f"[slice] stream mode batch {b}: median latency {lat:.2f} ms of 3 (per-block path "
            f"{block_ms[b]:.2f} ms), mean |image - per-block image| {diff:.4f} ({smi})")
    log(f"[slice] stream-mode launches in the run: vq {vq_kernel.launches}, K4 "
        f"{mixer_stream.launches}, K5 {mixer_block_stacked.launches}")
    return mixer_block_stacked.launches


def serve_timed(pred, name, grids, counters, want, route, tag, tmp, seed, smi, side, record,
                prior=False):
    """SERVE_REQUESTS timed requests of model `name` at each grid (with `prior`
    as the request's prior flag), after the caller's warm-up: host ms per
    request, CUDA-event ms per stage (`mark`), the kernels' launches of each
    request equal to `want(n)`; after the request's time is taken, its float
    images (kept in `record` by `recorded_images`) n x side x side, finite and
    in [0, 1], and the PNG their grid and not flat; one line per grid, tagged
    `tag`, the mapper's route `route(n)`. -> {grid: median request ms}."""
    import numpy as np
    import torch

    from feed_forward_vqgan_clip_tpu_torch.serve.predictor import STAGES

    medians = {}
    for grid in grids:
        gh, gw = (int(v) for v in grid.split("x"))
        n = gh * gw
        request_ms, stage_ms = [], {st: [] for st in STAGES}
        for i in range(SERVE_REQUESTS):
            before = {k: fn.launches for k, fn in counters.items()}
            record.clear()
            events = [torch.cuda.Event(enable_timing=True)]

            def mark(stage):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)

            t = time.perf_counter()
            events[0].record()
            out = pred.predict(PROMPT, name, prior=prior, grid_size=grid, seed=seed + i,
                               out_path=os.path.join(tmp, f"serve_{grid}.png"), mark=mark)
            request_ms.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            for j, st in enumerate(STAGES):
                stage_ms[st].append(events[j].elapsed_time(events[j + 1]))
            launched = {k: fn.launches - before[k] for k, fn in counters.items()}
            if launched != want(n):
                raise AssertionError(f"{tag} {grid}: launches {launched}, need {want(n)}")
            (imgs,) = record
            if not (imgs.shape == (n, side, side, 3) and np.isfinite(imgs).all()
                    and imgs.min() >= 0.0 and imgs.max() <= 1.0):
                raise AssertionError(f"{tag} {grid}: images {imgs.shape} in [{imgs.min()}, "
                                     f"{imgs.max()}], need ({n}, {side}, {side}, 3) finite in "
                                     "[0, 1]")
            img = read_png(out)
            png = (side + 2) * gh + 2
            if img.shape != (png, png, 3) or float(np.std(img)) == 0.0:
                raise AssertionError(f"{tag} {grid}: PNG {img.shape}, need ({png}, {png}, 3) "
                                     "and not flat")
        stages = ", ".join(f"{st} {sorted(v)[1]:.2f}" for st, v in stage_ms.items())
        med = medians[grid] = sorted(request_ms)[1]
        log(f"{tag} grid {grid} (n={n}, {route(n)}): median request {med:.2f} ms of "
            f"{SERVE_REQUESTS} ({', '.join(f'{v:.2f}' for v in request_ms)}), "
            f"{n / med * 1e3:.2f} img/s; median stage ms (CUDA events): {stages}; PNG "
            f"{png}x{png} ({smi})")
    return medians


def mixer_route(n, depth=STREAM_DEPTH):
    """The Predictor's Mixer route for a request of n images, as a label."""
    from feed_forward_vqgan_clip_tpu_torch.models.mappers.fused import STREAM_MAX_BATCH

    return "K4" if n <= STREAM_MAX_BATCH else f"{depth} x K2"


def save_flagship(folder, seed):
    """The flagship Mixer, random from `seed`, saved in `folder` as a reference
    `.th` (FLAGSHIP_CONFIG); -> its path."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.config import make_config
    from feed_forward_vqgan_clip_tpu_torch.io.checkpoint import save_model
    from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper

    mapper = build_mapper(make_config(**FLAGSHIP_CONFIG), vq_channels=256, device="cuda")
    mapper.init_random_(torch.Generator(device="cuda").manual_seed(seed))
    path = save_model(os.path.join(folder, "flagship_mixer.th"), mapper, FLAGSHIP_CONFIG)
    del mapper
    torch.cuda.empty_cache()
    return path


def serve_counters():
    """{kernel name: wrapper} of the kernels a flagship request can launch."""
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import mixer_block
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_stream import mixer_stream
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.vq_lookup import (
        nearest_codebook_indices_kernel as vq_kernel,
    )

    return {"vq_argmin": vq_kernel, "mixer_stream": mixer_stream, "mixer_block": mixer_block}


def serve_want(n):
    """The launches of a flagship request of n images: K1 once, K4 once at
    n <= 8, else K2 once a block."""
    from feed_forward_vqgan_clip_tpu_torch.models.mappers.fused import STREAM_MAX_BATCH

    return {"vq_argmin": 1, "mixer_stream": int(n <= STREAM_MAX_BATCH),
            "mixer_block": 0 if n <= STREAM_MAX_BATCH else STREAM_DEPTH}


def phase_serve(smi):
    """The serving Predictor at the flagship, from a `.th` checkpoint; -> K4's
    launches in the timed requests."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.serve import predictor as predictor_mod

    counters = serve_counters()
    record = []
    with tempfile.TemporaryDirectory() as tmp, bpe_table(tmp), \
            patched(predictor_mod, make_grid=recorded_images(record)):
        t0 = time.perf_counter()
        path = save_flagship(tmp, SEED)
        t1 = time.perf_counter()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        pred = predictor_mod.Predictor([path], device="cuda")
        pred.setup()
        name = "flagship_mixer.th"
        for grid in SERVE_GRIDS:  # warm-up, outside the counted run
            pred.predict(PROMPT, name, grid_size=grid, seed=SEED,
                         out_path=os.path.join(tmp, "warm.png"))
        torch.cuda.synchronize()
        log(f"[serve] checkpoint written ({os.path.getsize(path) / 2**30:.2f} GiB) in "
            f"{t1 - t0:.1f} s; Predictor set up and warmed in {time.perf_counter() - t1:.1f} s; "
            f"resident {(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB")
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        serve_timed(pred, name, SERVE_GRIDS, counters, serve_want, mixer_route, "[serve]", tmp,
                    SEED, smi, 16 * FLAGSHIP_CONFIG["vq_image_size"], record)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[serve] peak device memory in the requests {peak:.2f} GiB; launches in the timed "
            f"requests {dict((k, fn.launches) for k, fn in counters.items())}")
        launches = counters["mixer_stream"].launches
        del pred
    return launches


TINY_TRAIN = dict(clip_model="tiny", vqgan_arch=TINY_VQGAN, dim=64, depth=2, vq_image_size=4,
                  batch_size=3, cutn=2, compute_dtype="float32", noise_fac=0.0,
                  l2_coef=0.1, tv_coef=0.1, normalize_input=True, input_loss=True)


def phase_train_reference():
    """A tiny train step, float32, with the same weights on the card (Mixer train
    and warp kernels) and on the CPU (module path, plain warps); Af and Pe at
    draws pinned from a CPU generator, each with its application mask, and
    noise_fac 0, so no other random draw enters. Loss within 1e-4 relative;
    every mapper grad within 1e-3 of its max |CPU grad| plus 1e-3 of the largest
    grad of all (f32 sums in other orders through 2 blocks, the decoder and the
    image tower; the floor covers grads that are zero but for rounding, such as
    the token-FF output bias, whose per-token shift the next LayerNorms
    remove)."""
    import copy

    import torch

    from feed_forward_vqgan_clip_tpu_torch.config import make_config
    from feed_forward_vqgan_clip_tpu_torch.entry import example_tokens
    from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
    from feed_forward_vqgan_clip_tpu_torch.ops import augment
    from feed_forward_vqgan_clip_tpu_torch.ops.cutouts import MakeCutouts
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
        mixer_block_fwd_res,
        mixer_channel_bwd,
        mixer_token_bwd,
    )
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_adjoint import warp_adjoint
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_forward import warp_forward
    from feed_forward_vqgan_clip_tpu_torch.train.loop import (
        FrozenModels,
        build_frozen,
        make_train_step,
    )

    pin = torch.Generator().manual_seed(SEED + 2)
    n = TINY_TRAIN["cutn"] * TINY_TRAIN["batch_size"]
    af_draw = augment.af_sample(pin, n, 32, 32)
    pe_draw = augment.pe_sample(pin, n, 32, 32)
    af_on, pe_on = (torch.rand(n, generator=pin) < 0.7 for _ in range(2))

    def pinned_augs(dev):
        def af(gen, x):
            out = augment.af_apply(x, *(v.to(dev) for v in af_draw))
            return torch.where(af_on.to(dev)[:, None, None, None], out, x)

        def pe(gen, x):
            out = augment.pe_apply(x, *(v.to(dev) for v in pe_draw))
            return torch.where(pe_on.to(dev)[:, None, None, None], out, x)

        return [af, pe]

    cfg = make_config(**TINY_TRAIN)
    frozen = build_frozen(cfg, torch.float32, device="cpu", seed=SEED)
    mapper = build_mapper(dict(cfg), vq_channels=8, device="cpu")
    mapper.init_random_(torch.Generator().manual_seed(SEED + 1))
    tokens = example_tokens(3)
    tokens[1, 1], tokens[2, 1:4] = 1000, torch.tensor([2000, 3000, 49407])
    results = {}
    for dev in ("cpu", "cuda"):
        fz = frozen if dev == "cpu" else FrozenModels(
            frozen.perceptor._replace(module=copy.deepcopy(frozen.perceptor.module).cuda()),
            copy.deepcopy(frozen.vq).cuda())
        m = mapper if dev == "cpu" else copy.deepcopy(mapper).cuda()
        cutouts = MakeCutouts(cut_size=32, cutn=2, pool_size=32, noise_fac=0.0)
        cutouts.augs = pinned_augs(dev)
        _, loss_fn = make_train_step(cfg, m, fz, cutouts, inp_is_tokens=True,
                                     out_is_tokens=True)
        kernels = (mixer_block_fwd_res, mixer_channel_bwd, mixer_token_bwd, warp_forward,
                   warp_adjoint)
        counts = [k.launches for k in kernels]
        loss, _ = loss_fn({"inp": tokens.to(dev), "out": tokens.to(dev)},
                          torch.Generator(device=dev).manual_seed(0))
        loss.backward()
        launched = tuple(k.launches - c for k, c in zip(kernels, counts))
        if launched != ((2, 2, 2, 2, 2) if dev == "cuda" else (0, 0, 0, 0, 0)):
            raise AssertionError(f"train kernel launches on {dev}: {launched}")
        grads = {n: p.grad.detach().cpu() for n, p in m.named_parameters()}
        results[dev] = (loss.detach().item(), grads)
    (l_cpu, g_cpu), (l_card, g_card) = results["cpu"], results["cuda"]
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    top = max(g.abs().max().item() for g in g_cpu.values())
    grad_err, worst = max(
        ((g_card[n] - g).abs().max().item() / (g.abs().max().item() + 1e-3 * top), n)
        for n, g in g_cpu.items())
    log(f"[train-reference] tiny step f32 with Af and Pe at pinned draws ({int(af_on.sum())} and "
        f"{int(pe_on.sum())} of {n} crops warped), card vs CPU module path: loss {l_card:.6f} vs "
        f"{l_cpu:.6f} (rel err {loss_err:.3e}, limit 1e-4), worst mapper grad err / "
        f"(max|grad| + 1e-3 max over all grads) {grad_err:.3e} at {worst} (max|grad| "
        f"{g_cpu[worst].abs().max().item():.3e}, largest grad {top:.3e}) over {len(g_cpu)} "
        f"parameters (limit 1e-3)")
    # without the floor: which grad is zero but for rounding (no limit applies)
    bare, bare_at = max(
        ((g_card[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30), n)
        for n, g in g_cpu.items())
    log(f"[train-reference] without the floor, worst err / max|grad| {bare:.3e} at {bare_at} "
        f"(max|grad| {g_cpu[bare_at].abs().max().item():.3e}, card max|grad| "
        f"{g_card[bare_at].abs().max().item():.3e})")
    if not (loss_err <= 1e-4 and grad_err <= 1e-3):
        raise AssertionError("the card's train step disagrees with the CPU module path")


@contextlib.contextmanager
def fused_clip(on):
    """FFVC_FUSED_CLIP set to "1" (the image tower through K11) or "0" while the
    block runs, restored after it."""
    old = os.environ.get("FFVC_FUSED_CLIP")
    os.environ["FFVC_FUSED_CLIP"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("FFVC_FUSED_CLIP")
        else:
            os.environ["FFVC_FUSED_CLIP"] = old


def train_counters():
    """{kernel name: wrapper} of every kernel the train step can launch."""
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import (
        mixer_block_fwd_res,
        mixer_channel_bwd,
        mixer_token_bwd,
    )
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mlp_ln import mlp_ln, mlp_ln_bwd
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.vq_lookup import (
        nearest_codebook_indices_kernel as vq_kernel,
    )
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_adjoint import warp_adjoint
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_forward import warp_forward

    return {"vq_argmin": vq_kernel, "mixer_fwd_res": mixer_block_fwd_res,
            "mixer_channel_bwd": mixer_channel_bwd, "mixer_token_bwd": mixer_token_bwd,
            "warp_forward": warp_forward, "warp_adjoint": warp_adjoint, "mlp_ln": mlp_ln,
            "mlp_ln_bwd": mlp_ln_bwd}


def phase_train(smi):
    """The flagship train step through entry.train_entry, built twice side by
    side: the image tower as modules, and through the K11 sublayers
    (FFVC_FUSED_CLIP=1). A warm-up step each, then TRAIN_STEPS timed steps each,
    taken in turns (module, fused, fused, module, ...) so that both meet the same
    host: host clock around each step, ending in a synchronize, per-stage CUDA
    events. -> (the kernels' launches in the module tower's timed steps,
    {"module" / "fused": {"step", "image_tower", "backward"}: median ms})."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.entry import train_entry
    from feed_forward_vqgan_clip_tpu_torch.train.loop import STAGES

    counters = train_counters()
    runs = {}
    for name, fused in (("module", False), ("fused", True)):
        t0 = time.perf_counter()
        with fused_clip(fused):
            step_fn, state, batch = train_entry("cuda", batch=8, cutn=8, seed=SEED)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        step_fn(state, batch, gen)  # warm-up, outside the counted run
        torch.cuda.synchronize()
        log(f"[train] flagship train step, {name} tower, built and warmed in "
            f"{time.perf_counter() - t0:.1f} s ({sum(p.numel() for p in state.params) / 1e6:.1f} "
            "M mapper parameters)")
        # the warps: Af and Pe, one forward and one adjoint each; K11 once per ViT block
        per_step = {"vq_argmin": 1, "mixer_fwd_res": 32, "mixer_channel_bwd": 32,
                    "mixer_token_bwd": 32, "warp_forward": 2, "warp_adjoint": 2,
                    "mlp_ln": CLIP_BLOCKS * fused, "mlp_ln_bwd": CLIP_BLOCKS * fused}
        runs[name] = dict(step_fn=step_fn, state=state, batch=batch, gen=gen, per_step=per_step,
                          watch=[state.params[0], state.params[len(state.params) // 2],
                                 state.params[-1]],
                          step_ms=[], stage_ms={s: [] for s in STAGES}, losses=[],
                          launches={k: 0 for k in counters})
    torch.cuda.reset_peak_memory_stats()
    for i in range(2 * TRAIN_STEPS):
        name = "fused" if i % 4 in (1, 2) else "module"
        r = runs[name]
        before = {k: fn.launches for k, fn in counters.items()}
        snapshot = [p.detach().clone() for p in r["watch"]]
        events = [torch.cuda.Event(enable_timing=True)]
        marks = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            marks.append(stage)

        t = time.perf_counter()
        events[0].record()
        r["state"], metrics = r["step_fn"](r["state"], r["batch"], r["gen"], mark)
        torch.cuda.synchronize()
        r["step_ms"].append((time.perf_counter() - t) * 1e3)
        for j, stage in enumerate(marks):
            r["stage_ms"][stage].append(events[j].elapsed_time(events[j + 1]))
        loss = metrics["loss"].item()
        r["losses"].append(loss)
        launched = {k: fn.launches - before[k] for k, fn in counters.items()}
        for k, v in launched.items():
            r["launches"][k] += v
        if launched != r["per_step"]:
            raise AssertionError(f"train step ({name} tower) launches {launched}, need "
                                 f"{r['per_step']}")
        if not torch.isfinite(torch.tensor(loss)).item():
            raise AssertionError(f"train step loss {loss} is not finite")
        if all(torch.equal(a, p.detach()) for a, p in zip(snapshot, r["watch"])):
            raise AssertionError("train step left the watched parameters unchanged")
    summary = {}
    for name, r in runs.items():
        med = sorted(r["step_ms"])[len(r["step_ms"]) // 2]
        stage_med = {s: sorted(v)[len(v) // 2] for s, v in r["stage_ms"].items()}
        stages = ", ".join(f"{s} {v:.2f}" for s, v in stage_med.items())
        log(f"[train] {name} tower: losses {', '.join(f'{x:.6f}' for x in r['losses'])}; "
            f"avg_loss {r['state'].avg_loss.item():.6f}; step {r['state'].step}")
        log(f"[train] {name} tower, B=8 cutn=8: median step {med:.2f} ms of {TRAIN_STEPS} "
            f"({', '.join(f'{x:.2f}' for x in r['step_ms'])}), {8 / med * 1e3:.2f} img/s ({smi})")
        log(f"[train] {name} tower: median stage ms (CUDA events): {stages} ({smi})")
        log(f"[train] {name} tower: launches in the timed steps {r['launches']}")
        summary[name] = {"step": med, "image_tower": stage_med["image_tower"],
                         "backward": stage_med["backward"]}
    log(f"[train] peak device memory in the timed steps, both towers' models resident: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches = runs["module"]["launches"]
    del runs
    torch.cuda.empty_cache()
    return launches, summary


def trainer_config(folder, path, **kw):
    """The flagship geometry of entry.train_entry as a trainer config: CLIP
    ViT-B/32, Mixer 32x1024, VQGAN f16-16384, B=8, cutn=8, 224-px cutouts with the
    default augs, bf16, Adam with bf16 moments, EMA, clipping."""
    from feed_forward_vqgan_clip_tpu_torch.config import make_config

    cfg = dict(clip_model="ViT-B/32", model_type="mlp_mixer", dim=1024, depth=32, dropout=0,
               vq_image_size=16, vqgan_model="vqgan_imagenet_f16_16384", noise_dim=0,
               batch_size=8, cutn=8, compute_dtype="bfloat16", opt_dtype="bfloat16",
               lr=TRAINER_LR, use_ema=True, clip_grad_norm=1.0, epochs=1000, seed=SEED,
               path=path, folder=folder)
    cfg.update(kw)
    return make_config(**cfg)


def phase_trainer(smi):
    """`train(cfg, device="cuda")` at the flagship geometry on a 32-prompt token
    file, the image tower through K11 (FFVC_FUSED_CLIP=1), with EMA, the cosine
    schedule and clipping: 5 steps with log steps 0 and 4, then a resume to 7.
    Checks the run folder and the step count, and times each step (host clock,
    synchronized after it), the log steps' previews and checkpoints, and the
    checkpoint writes. Then, at depth 2 (smaller files), 4 uninterrupted steps
    against 2 + 2 resumed. -> the kernels' launches in the flagship runs."""
    import numpy as np
    import torch

    from feed_forward_vqgan_clip_tpu_torch.entry import EOT, SOT
    from feed_forward_vqgan_clip_tpu_torch.io import checkpoint as ckpt_io
    from feed_forward_vqgan_clip_tpu_torch.train import loop

    counters = train_counters()
    per_step = {"vq_argmin": 1, "mixer_fwd_res": 32, "mixer_channel_bwd": 32,
                "mixer_token_bwd": 32, "warp_forward": 2, "warp_adjoint": 2,
                "mlp_ln": CLIP_BLOCKS, "mlp_ln_bwd": CLIP_BLOCKS}
    real = (loop.make_train_step, loop._log_step_artifacts, loop._save_all,
            ckpt_io._atomic_save)
    times = {"step": {}, "log": {}, "save": [], "write": [], "bytes": {}}

    def make_train_step(*a, **k):
        step_fn, loss_fn = real[0](*a, **k)

        def timed(state, batch, gen, mark=None):
            before = {name: fn.launches for name, fn in counters.items()}
            step, t = state.step, time.perf_counter()
            out = step_fn(state, batch, gen, mark)
            torch.cuda.synchronize()
            times["step"][step] = (time.perf_counter() - t) * 1e3
            launched = {name: fn.launches - before[name] for name, fn in counters.items()}
            if launched != per_step:
                raise AssertionError(f"[trainer] step {step} launches {launched}, need "
                                     f"{per_step}")
            return out

        return timed, loss_fn

    def log_step_artifacts(*a, **k):
        t = time.perf_counter()
        real[1](*a, **k)
        times["log"][a[8]] = (time.perf_counter() - t) * 1e3  # a[8]: the step

    def save_all(*a, **k):
        t = time.perf_counter()
        real[2](*a, **k)
        times["save"].append((time.perf_counter() - t) * 1e3)

    def atomic_save(obj, path):
        t = time.perf_counter()
        real[3](obj, path)
        times["write"].append((time.perf_counter() - t) * 1e3)
        times["bytes"][os.path.basename(path)] = os.path.getsize(path)
        return path

    toks = np.zeros((32, 77), np.int32)
    toks[:, 0], toks[:, 1], toks[:, 2] = SOT, 320 + np.arange(32), EOT
    with tempfile.TemporaryDirectory() as tmp, bpe_table(tmp), fused_clip(True):
        path = os.path.join(tmp, "tokens.npz")
        np.savez(path, tokens=toks)
        run = os.path.join(tmp, "run")
        loop.make_train_step, loop._log_step_artifacts, loop._save_all = (
            make_train_step, log_step_artifacts, save_all)
        ckpt_io._atomic_save = atomic_save
        try:
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = loop.train(trainer_config(run, path, scheduler="cosine", max_steps=5,
                                              log_interval=4), device="cuda")
            t1 = time.perf_counter()
            files = sorted(os.listdir(run))
            need = ["checkpoint.th", "checkpoint_ema.th", "opt.th", "progress.png",
                    "fixed_batch_progress.png", "progress.txt", "fixed_batch.txt",
                    "progress_0000000004.png"]
            if state.step != 5 or any(f not in files for f in need):
                raise AssertionError(f"[trainer] step {state.step}, folder {files}")
            for name in ("progress.png", "fixed_batch_progress.png"):
                img = read_png(os.path.join(run, name))
                if img.shape != (260, 2066, 3) or float(np.std(img)) == 0.0:
                    raise AssertionError(f"[trainer] {name}: {img.shape}, need (260, 2066, 3)")
            del state
            state = loop.train(trainer_config(run, path, scheduler="cosine", max_steps=7,
                                              log_interval=4), device="cuda")
            t2 = time.perf_counter()
            stored = torch.load(os.path.join(run, "checkpoint.th"), map_location="cpu",
                                weights_only=False, mmap=True)["step"]
            if state.step != 7 or stored != 7:
                raise AssertionError(f"[trainer] resume reached step {state.step} (stored "
                                     f"{stored}), need 7")
            launches = {name: fn.launches for name, fn in counters.items()}
            if launches["mlp_ln"] != 7 * CLIP_BLOCKS or launches["mlp_ln_bwd"] != 7 * CLIP_BLOCKS:
                raise AssertionError(f"[trainer] K11 launches {launches}, need "
                                     f"{7 * CLIP_BLOCKS} each")
            steps = times["step"]
            plain_steps = sorted(v for s, v in steps.items() if s not in times["log"] and s > 0)
            med = plain_steps[len(plain_steps) // 2]
            log(f"[trainer] flagship train(), FFVC_FUSED_CLIP=1, EMA, cosine, clipping: 5 steps "
                f"in {t1 - t0:.1f} s, resumed to 7 in {t2 - t1:.1f} s (model builds included); "
                f"folder {files}")
            log(f"[trainer] step ms (host clock, synchronized after each): "
                f"{', '.join(f'{s}: {v:.2f}' for s, v in sorted(steps.items()))}; median "
                f"non-log step {med:.2f} ms of {len(plain_steps)} ({smi})")
            log(f"[trainer] log step 4: step {steps[4]:.2f} ms + previews and checkpoint "
                f"hand-off {times['log'][4]:.2f} ms (step 0: {times['log'][0]:.2f}); "
                f"_save_all (device->host copies, and the wait for the previous write) "
                f"{', '.join(f'{v:.1f}' for v in times['save'])} ms; file writes "
                f"{', '.join(f'{v:.1f}' for v in times['write'])} ms ({smi})")
            log(f"[trainer] checkpoint bytes {times['bytes']} (total "
                f"{sum(times['bytes'].values()) / 2**30:.2f} GiB per save); launches in the "
                f"runs {launches}; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            del state
        finally:
            (loop.make_train_step, loop._log_step_artifacts, loop._save_all,
             ckpt_io._atomic_save) = real
        shutil.rmtree(run)
        trainer_resume_check(tmp, path)
    return launches


def trainer_resume_check(tmp, path):
    """At the flagship widths with mapper depth 2, no schedule: 4 uninterrupted
    steps against 2 + 2 resumed, and against a second uninterrupted run. Every sum
    of the step runs in a fixed order (the kernels, the matmul pools, cuDNN held
    to its deterministic algorithms by train()), so the parameters, their EMA
    and Adam's moments must be bitwise equal."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.train import loop

    kw = dict(depth=2, log_interval=100)

    def run(name, steps):
        return loop.train(trainer_config(os.path.join(tmp, name), path, max_steps=steps, **kw),
                          device="cuda")

    a, again = run("a", 4), run("a2", 4)
    run("b", 2)
    b = run("b", 4)

    def tensors(state):
        return (list(state.params) + list(state.ema_params) + list(state.opt_state.mu)
                + list(state.opt_state.nu))

    for label, other in (("4 steps against 2 + 2 resumed", b),
                         ("two uninterrupted 4-step runs", again)):
        pairs = list(zip(tensors(a), tensors(other)))
        diff = max((x.float() - y.float()).abs().max().item() for x, y in pairs)
        equal = all(torch.equal(x, y) for x, y in pairs)
        log(f"[trainer] depth 2, {label}: params, EMA and Adam moments ({len(pairs)} tensors) "
            f"bitwise equal: {equal} (max |difference| {diff:.3e})")
        if not (equal and a.step == other.step == 4):
            raise AssertionError(f"[trainer] {label}: the runs differ")


def phase_cutouts():
    """MakeCutouts on the card (the kernels, the matmul pools) against the CPU (the
    plain versions), float32, noise 0, two 256-px renders, cutn 4, cut 224, at
    draws pinned from a CPU generator: `pool: false` + Re, `pool_size` 256 + Cc,
    `pool: false` + Cc + `interpolate` to 112, `fuse_geometric` (Af, Pe). Output
    and input gradient within 1e-4 of max |CPU| (sums in another order)."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.ops import augment
    from feed_forward_vqgan_clip_tpu_torch.ops.cutouts import MakeCutouts
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_adjoint import warp_adjoint
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_forward import warp_forward

    pin = torch.Generator().manual_seed(SEED + 4)
    n = 8
    re_box = augment.re_sample(pin, n, 256, 256, augment.RE_SCALE)
    fused = augment.fused_sample(pin, n, 224, 224)

    def pinned_re(gen, x):
        return augment._crop_resize(x, *(v.to(x.device) for v in re_box), 224)

    def pinned_fused(gen, x):
        m = augment.fused_matrices(*(v.to(x.device) for v in fused), 224, 224)
        return augment.warp_projective(x, m, "border")

    x = torch.rand(2, 256, 256, 3, generator=pin)
    configs = [("pool: false + Re", dict(pool=False, augs=["Re"]), [pinned_re]),
               ("pool_size 256 + Cc", dict(pool_size=256, augs=["Cc"]), None),
               ("pool: false + Cc + interpolate 112",
                dict(pool=False, augs=["Cc"], interpolate=True, interp_size=112), None),
               ("fuse_geometric Af, Pe", dict(augs=["Af", "Pe"], fuse_geometric=True),
                [pinned_fused])]
    for label, kw, augs in configs:
        results = []
        for dev in ("cpu", "cuda"):
            mc = MakeCutouts(cut_size=224, cutn=4, noise_fac=0.0, **kw)
            if augs is not None:
                mc.augs = augs
            xd = x.to(dev).requires_grad_()
            counts = (warp_forward.launches, warp_adjoint.launches)
            out = mc(torch.Generator(device=dev), xd)
            ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(1)).to(dev)
            (grad,) = torch.autograd.grad(out, xd, ct)
            launched = (warp_forward.launches - counts[0], warp_adjoint.launches - counts[1])
            if launched != ((1, 1) if dev == "cuda" else (0, 0)):
                raise AssertionError(f"[cutouts] {label} on {dev}: warp launches {launched}")
            results.append((out.detach().cpu(), grad.cpu()))
        (o_cpu, g_cpu), (o_card, g_card) = results
        errs = [(a - b).abs().max().item() / b.abs().max().item()
                for a, b in ((o_card, o_cpu), (g_card, g_cpu))]
        log(f"[cutouts] {label}: card vs CPU, output {tuple(o_card.shape)} err / max|CPU| "
            f"{errs[0]:.3e}, input grad {errs[1]:.3e} (limit 1e-4)")
        if not (o_card.shape == o_cpu.shape and max(errs) <= 1e-4):
            raise AssertionError(f"[cutouts] {label}: the card disagrees with the CPU")


CROPS = dict(pool=False, augs=["Re", "Af", "Pe", "Ji", "Er"], noise_fac=0.1)


def phase_trainer_crops(smi):
    """`train(cfg, device="cuda")` at the flagship geometry with the unpooled
    crops (CROPS), the module tower, no EMA, 4 steps (step 0 a log step). Each
    step: a finite loss, changed parameters, the kernels' launches (the warps 3
    forward and 3 adjoint, of which the wrappers count one forward and one
    adjoint from 256 to 224 px as rectangular), host ms and per-stage CUDA-event
    ms. Then two identical 2-step runs with the crops at depth 2, bitwise equal.
    -> (the kernels' launches in the flagship run, {warp: its rectangular
    launches in that run})."""
    import numpy as np
    import torch

    from feed_forward_vqgan_clip_tpu_torch.entry import EOT, SOT
    from feed_forward_vqgan_clip_tpu_torch.train import loop
    from feed_forward_vqgan_clip_tpu_torch.train.loop import STAGES

    counters = train_counters()
    warps = {name: counters[name] for name in ("warp_forward", "warp_adjoint")}
    per_step = {"vq_argmin": 1, "mixer_fwd_res": 32, "mixer_channel_bwd": 32,
                "mixer_token_bwd": 32, "warp_forward": 3, "warp_adjoint": 3, "mlp_ln": 0,
                "mlp_ln_bwd": 0}
    real = loop.make_train_step
    steps, losses = {}, []

    def make_train_step(*a, **k):
        step_fn, loss_fn = real(*a, **k)

        def checked(state, batch, gen, mark=None):
            before = {name: fn.launches for name, fn in counters.items()}
            rect_before = {name: fn.rect_launches for name, fn in warps.items()}
            watch = [state.params[0], state.params[len(state.params) // 2], state.params[-1]]
            snapshot = [p.detach().clone() for p in watch]
            events = [torch.cuda.Event(enable_timing=True)]

            def stage_mark(stage):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)

            step, t = state.step, time.perf_counter()
            events[0].record()
            out = step_fn(state, batch, gen, stage_mark)
            torch.cuda.synchronize()
            steps[step] = ((time.perf_counter() - t) * 1e3,
                           [events[j].elapsed_time(events[j + 1]) for j in range(len(STAGES))])
            loss = out[1]["loss"].item()
            losses.append(loss)
            launched = {name: fn.launches - before[name] for name, fn in counters.items()}
            rect = {name: fn.rect_launches - rect_before[name] for name, fn in warps.items()}
            if launched != per_step or set(rect.values()) != {1}:
                raise AssertionError(f"[trainer-crops] step {step}: launches {launched}, need "
                                     f"{per_step}; rectangular warp launches {rect}, need 1 each")
            if not np.isfinite(loss) or any(torch.equal(a, p.detach())
                                            for a, p in zip(snapshot, watch)):
                raise AssertionError(f"[trainer-crops] step {step}: loss {loss}, or a watched "
                                     "parameter did not change")
            return out

        return checked, loss_fn

    toks = np.zeros((32, 77), np.int32)
    toks[:, 0], toks[:, 1], toks[:, 2] = SOT, 320 + np.arange(32), EOT
    with tempfile.TemporaryDirectory() as tmp, bpe_table(tmp), fused_clip(False):
        path = os.path.join(tmp, "tokens.npz")
        np.savez(path, tokens=toks)
        loop.make_train_step = make_train_step
        try:
            for fn in counters.values():
                fn.launches = 0
            for fn in warps.values():
                fn.rect_launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = loop.train(trainer_config(os.path.join(tmp, "crops"), path, max_steps=4,
                                              log_interval=100, use_ema=False, **CROPS),
                               device="cuda")
            took = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counters.items()}
            rect = {name: fn.rect_launches for name, fn in warps.items()}
        finally:
            loop.make_train_step = real
        peak = torch.cuda.max_memory_allocated() / 2**30
        if state.step != 4 or set(rect.values()) != {4}:
            raise AssertionError(f"[trainer-crops] step {state.step}, rectangular warp launches "
                                 f"{rect}; need 4 and 4 each")
        del state
        plain = sorted(ms for s_, (ms, _) in steps.items() if s_ > 0)
        log(f"[trainer-crops] pool: false, augs Re Af Pe Ji Er, noise 0.1: 4 steps in {took:.1f} s "
            f"(model builds and two checkpoint saves included); "
            f"losses {', '.join(f'{v:.6f}' for v in losses)}; median non-log step "
            f"{plain[len(plain) // 2]:.2f} ms of {len(plain)}; peak device memory "
            f"{peak:.2f} GiB ({smi})")
        for s_, (ms, stage_ms) in sorted(steps.items()):
            log(f"[trainer-crops] step {s_}: {ms:.2f} ms (host clock, synchronized after it); "
                f"CUDA-event stages "
                f"{', '.join(f'{n} {v:.2f}' for n, v in zip(STAGES, stage_ms))} ({smi})")
        log(f"[trainer-crops] launches {launches}; from 256 to 224 px {rect}")
        states = []
        for name in ("d2a", "d2b"):
            st = loop.train(trainer_config(os.path.join(tmp, name), path, max_steps=2, depth=2,
                                           log_interval=100, **CROPS), device="cuda")
            states.append(list(st.params) + list(st.ema_params) + list(st.opt_state.mu)
                          + list(st.opt_state.nu))
        equal = all(torch.equal(a, b) for a, b in zip(*states))
        log(f"[trainer-crops] depth 2, two identical 2-step runs: params, EMA and Adam moments "
            f"({len(states[0])} tensors) bitwise equal: {equal}")
        if not equal:
            raise AssertionError("[trainer-crops] two identical runs differ")
    return launches, rect


def mapper_counters():
    """{kernel name: wrapper} of every kernel a request or a train step can launch."""
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_block import mixer_block
    from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mixer_stream import mixer_stream

    return {**train_counters(), "mixer_stream": mixer_stream, "mixer_block": mixer_block}


def recorded_images(record):
    """predictor.make_grid that first appends the request's float images to
    `record`, for serve_timed to check once the request's time is taken."""
    from feed_forward_vqgan_clip_tpu_torch.io.images import make_grid

    def grid(imgs, nrow):
        record.append(imgs)
        return make_grid(imgs, nrow)

    return grid


def mapper_model_run(label, cfg, grids, seed, smi):
    """One released mapper, random from `seed`: saved as a `.th`, served by the
    Predictor (a warm-up, then SERVE_REQUESTS timed requests at each grid, the
    kernels' launches of each request asserted: K1 once, and for a Mixer K4
    once at n <= 8, K2 32 times above), then one train step after a warm-up
    step (entry.train_entry with this mapper and perceptor: K1 once, K9 and K10
    twice, K6, K7, K8 32 times each for a Mixer, no Mixer kernel for the
    others; a finite loss, changed parameters). -> the kernels' launches in the
    timed requests and the timed step."""
    import numpy as np
    import torch

    from feed_forward_vqgan_clip_tpu_torch.config import make_config, vqgan_arch_config
    from feed_forward_vqgan_clip_tpu_torch.entry import train_entry
    from feed_forward_vqgan_clip_tpu_torch.io.checkpoint import save_model
    from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
    from feed_forward_vqgan_clip_tpu_torch.models.mappers.fused import STREAM_MAX_BATCH
    from feed_forward_vqgan_clip_tpu_torch.serve import predictor as predictor_mod
    from feed_forward_vqgan_clip_tpu_torch.train.loop import STAGES as TRAIN_STAGES

    cfg = dict(MAPPER_COMMON, **cfg)
    counters = mapper_counters()
    mixer = cfg["model_type"] == "mlp_mixer"
    depth = int(cfg["depth"])
    launches = {k: 0 for k in counters}
    side = 16 * int(cfg["vq_image_size"])
    record = []
    with tempfile.TemporaryDirectory() as tmp, bpe_table(tmp), \
            patched(predictor_mod, make_grid=recorded_images(record)):
        t0 = time.perf_counter()
        mapper = build_mapper(make_config(**cfg), device="cuda",
                              vq_channels=int(vqgan_arch_config(cfg)["z_channels"]))
        mapper.init_random_(torch.Generator(device="cuda").manual_seed(seed))
        params = sum(p.numel() for p in mapper.parameters())
        path = save_model(os.path.join(tmp, f"{label}.th"), mapper, cfg)
        del mapper
        t1 = time.perf_counter()
        pred = predictor_mod.Predictor([path], device="cuda")
        pred.setup()
        name = f"{label}.th"
        if list(pred.models) != [name] or (name in pred._stream_params) != mixer:
            raise AssertionError(f"[mappers] {label}: Predictor loaded {list(pred.models)}")
        for grid in grids:  # warm-up, outside the counted run
            pred.predict(PROMPT, name, grid_size=grid, seed=seed,
                         out_path=os.path.join(tmp, "warm.png"))
        torch.cuda.synchronize()
        log(f"[mappers] {label}: {params / 1e6:.1f} M parameters, `.th` "
            f"{os.path.getsize(path) / 2**30:.2f} GiB written in {t1 - t0:.1f} s; Predictor set "
            f"up and warmed in {time.perf_counter() - t1:.1f} s")
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0

        def want(n):
            need = {k: 0 for k in counters}
            need["vq_argmin"] = 1
            if mixer:
                need["mixer_stream" if n <= STREAM_MAX_BATCH else "mixer_block"] = (
                    1 if n <= STREAM_MAX_BATCH else depth)
            return need

        def route(n):
            return f"{side} px, mapper " + (
                mixer_route(n, depth) if mixer else "module path")

        serve_ms = serve_timed(pred, name, grids, counters, want, route, f"[mappers] {label}",
                               tmp, seed, smi, side, record)
        serve_peak = torch.cuda.max_memory_allocated() / 2**30
        for k, fn in counters.items():
            launches[k] += fn.launches
        del pred
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with fused_clip(False):
        step_fn, state, batch = train_entry("cuda", batch=8, cutn=8, seed=seed,
                                            mapper_config=cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    step_fn(state, batch, gen)  # warm-up, outside the counted run
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    watch = [state.params[0], state.params[len(state.params) // 2], state.params[-1]]
    snapshot = [p.detach().clone() for p in watch]
    events = [torch.cuda.Event(enable_timing=True)]

    def stage_mark(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    t = time.perf_counter()
    events[0].record()
    state, metrics = step_fn(state, batch, gen, stage_mark)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    loss = metrics["loss"].item()
    want = {k: 0 for k in counters}
    want.update(vq_argmin=1, warp_forward=2, warp_adjoint=2)
    if mixer:
        want.update(mixer_fwd_res=depth, mixer_channel_bwd=depth, mixer_token_bwd=depth)
    launched = {k: fn.launches for k, fn in counters.items()}
    if launched != want:
        raise AssertionError(f"[mappers] {label} train step: launches {launched}, need {want}")
    if not np.isfinite(loss) or any(torch.equal(a, p.detach()) for a, p in zip(snapshot, watch)):
        raise AssertionError(f"[mappers] {label} train step: loss {loss}, or a watched "
                             "parameter did not change")
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    stages = ", ".join(f"{st} {events[j].elapsed_time(events[j + 1]):.2f}"
                       for j, st in enumerate(TRAIN_STAGES))
    log(f"[mappers] {label} train step (B=8, cutn=8, 224-px cutouts Af/Pe/Ji/Er, bf16, Adam; "
        f"built and warmed in {built:.1f} s): loss {loss:.6f}, step {step_ms:.2f} ms (host "
        f"clock, synchronized), CUDA-event stages {stages}; peak device memory "
        f"{train_peak:.2f} GiB; launches {launched} ({smi})")
    for k, v in launched.items():
        launches[k] += v
    log(f"[mappers] {label}: serving median request ms "
        f"{', '.join(f'{g} {v:.2f}' for g, v in serve_ms.items())}, peak {serve_peak:.2f} GiB; "
        f"train step {step_ms:.2f} ms, peak {train_peak:.2f} GiB ({smi})")
    del state, step_fn, batch
    torch.cuda.empty_cache()
    return launches


def phase_mappers(smi):
    """[mappers]: every released mapper family the flagship is not, served and
    trained once through the entry points (`mapper_model_run` each). Draws only
    from generators of its own. -> the kernels' launches in the phase's timed
    requests and steps, summed over the models."""
    total = {}
    for i, (label, cfg, grids) in enumerate(MAPPER_MODELS):
        for k, v in mapper_model_run(label, cfg, grids, MAPPERS_SEED + i, smi).items():
            total[k] = total.get(k, 0) + v
    log(f"[mappers] launches in the phase: {total}")
    return total


def run_cli(argv):
    """The port's CLI on `argv`, as `python -m ... cli` runs it (its parser and
    command), without the logging set-up of cli.main."""
    from feed_forward_vqgan_clip_tpu_torch.cli import build_parser

    args = build_parser().parse_args(argv)
    args.fn(args)


def phase_prior(smi):
    """[prior]: the flagship `.th` served with a prior `.th` of the released
    prior's widths (PRIOR_MODEL), random from PRIOR_SEED: grids with prior=True
    and 1x1 without, the prior's stage timed; the mapper input with and without
    the prior; the card's reverse against the CPU's on a pinned z; `cli test
    --prior-path`. -> the kernels' launches in the timed requests."""
    import copy

    import numpy as np
    import torch

    from feed_forward_vqgan_clip_tpu_torch.models import flow
    from feed_forward_vqgan_clip_tpu_torch.serve import predictor as predictor_mod

    t_phase = time.perf_counter()
    counters = serve_counters()
    record = []
    name = "flagship_mixer.th"
    gen = torch.Generator(device="cuda").manual_seed(PRIOR_SEED)
    with tempfile.TemporaryDirectory() as tmp, bpe_table(tmp), \
            patched(predictor_mod, make_grid=recorded_images(record)):
        path = save_flagship(tmp, PRIOR_SEED)
        prior = flow.build_prior_model({"model": PRIOR_MODEL}, 512, 512, device="cuda")
        prior.init_random_(gen)
        with torch.no_grad():  # ActNorm off the identity, as a trained prior's
            for blk in prior.sub_layers:
                blk.norm_layer.loc.normal_(0.0, 0.1, generator=gen)
                blk.norm_layer.scale.uniform_(0.5, 1.5, generator=gen)
        n_params = sum(p.numel() for p in prior.parameters())
        prior_path = flow.save_prior(os.path.join(tmp, "prior_2x1024.th"), prior,
                                     {"model": PRIOR_MODEL})
        del prior
        t1 = time.perf_counter()
        pred = predictor_mod.Predictor([path], {name: prior_path}, device="cuda")
        pred.setup()
        if pred.model_prior != {name: prior_path}:
            raise AssertionError(f"[prior] the Predictor paired {pred.model_prior}")
        for grid in SERVE_GRIDS:  # warm-up, outside the counted run
            pred.predict(PROMPT, name, prior=True, grid_size=grid, seed=PRIOR_SEED,
                         out_path=os.path.join(tmp, "warm.png"))
        pred.predict(PROMPT, name, grid_size="1x1", seed=PRIOR_SEED,
                     out_path=os.path.join(tmp, "warm.png"))
        torch.cuda.synchronize()
        log(f"[prior] prior {n_params / 1e6:.2f} M parameters ({PRIOR_MODEL}, 512 -> 512), "
            f"`.th` {os.path.getsize(prior_path) / 2**20:.1f} MiB; Predictor with its prior set "
            f"up and warmed in {time.perf_counter() - t1:.1f} s ({smi})")
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        serve_timed(pred, name, SERVE_GRIDS, counters, serve_want, mixer_route,
                    "[prior] prior=True", tmp, PRIOR_SEED, smi, 256, record, prior=True)
        serve_timed(pred, name, ("1x1",), counters, serve_want, mixer_route,
                    "[prior] prior=False", tmp, PRIOR_SEED, smi, 256, record)
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = {k: fn.launches for k, fn in counters.items()}
        log(f"[prior] peak device memory in the requests {peak:.2f} GiB; launches {launches} "
            f"({smi})")

        inputs = []
        stream = predictor_mod.streamed_mixer_forward
        with patched(predictor_mod, streamed_mixer_forward=lambda m, p, x: (
                inputs.append(x.float().cpu()) or stream(m, p, x))):
            for flag in (True, False):
                pred.predict(PROMPT, name, prior=flag, grid_size="1x1", seed=PRIOR_SEED,
                             out_path=os.path.join(tmp, "flag.png"))
        moved = (inputs[0] - inputs[1]).abs().max().item()
        if moved == 0.0:
            raise AssertionError("[prior] prior=True left the mapper input unchanged")

        card_flow = pred.priors[prior_path].flow
        cpu_flow = copy.deepcopy(card_flow).cpu()
        cg = torch.Generator().manual_seed(PRIOR_SEED)
        z, cond = torch.randn(16, 512, generator=cg), torch.randn(16, 512, generator=cg)
        with torch.no_grad():
            want = cpu_flow.reverse(z, cond)
            got = card_flow.reverse(z.cuda(), cond.cuda()).cpu()
        err = (got - want).abs().max().item()
        limit = 1e-4 * max(1.0, want.abs().max().item())
        log(f"[prior] prior=True moves the 1x1 mapper input by up to {moved:.4f} against "
            f"prior=False (same seed); reverse on a pinned z (16 x 512), card against the CPU, "
            f"f32: max abs err {err:.3e} (limit {limit:.3e}) ({smi})")
        if not err <= limit:
            raise AssertionError("[prior] the card's reverse disagrees with the CPU's")
        del pred, card_flow
        torch.cuda.empty_cache()

        out = os.path.join(tmp, "cli_test.png")
        t = time.perf_counter()
        run_cli(["test", path, f"{PROMPT}|hello", "--prior-path", prior_path, "--nb-repeats",
                 "2", "--out-path", out, "--seed", "1"])
        img = read_png(out)
        if img.shape != (2 + 2 * 258, 2 + 2 * 258, 3) or float(np.std(img)) == 0.0:
            raise AssertionError(f"[prior] cli test --prior-path wrote {img.shape}")
        log(f"[prior] `cli test --prior-path` (2 prompts x 2 repeats): PNG {img.shape} in "
            f"{time.perf_counter() - t:.1f} s (load and generate); phase "
            f"{time.perf_counter() - t_phase:.1f} s ({smi})")
    torch.cuda.empty_cache()
    return launches


def phase_prior_train(smi):
    """[prior-train]: `train_prior` (PRIOR_MODEL) on PRIOR_TRAIN_PAIRS seeded pairs
    of 512-d (y a fixed random linear map of x plus noise): 300 steps, a rerun to
    400 (the resume), against 400 steps at once, bitwise; step ms (CUDA events)
    and the loss at steps 0, 100 and 300."""
    import numpy as np
    import torch

    from feed_forward_vqgan_clip_tpu_torch.config import make_config
    from feed_forward_vqgan_clip_tpu_torch.io import checkpoint as ckpt_io
    from feed_forward_vqgan_clip_tpu_torch.train import prior as prior_mod

    t_phase = time.perf_counter()
    rng = np.random.default_rng(PRIOR_SEED)
    x = rng.standard_normal((PRIOR_TRAIN_PAIRS, 512), dtype=np.float32)
    w = rng.standard_normal((512, 512), dtype=np.float32) / np.sqrt(512.0)
    y = x @ w + 0.1 * rng.standard_normal((PRIOR_TRAIN_PAIRS, 512), dtype=np.float32)
    runs = {}
    make_step = prior_mod.make_prior_step

    def timed_step(flow, state):
        step = make_step(flow, state)
        run = runs[current[0]]

        def timed(xb, yb):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step(xb, yb)
            end.record()
            run.append((state.step - 1, start, end, metrics["loss"]))
            return metrics

        return timed

    with tempfile.TemporaryDirectory() as tmp, patched(prior_mod, make_prior_step=timed_step):
        data = os.path.join(tmp, "pairs.npz")
        np.savez(data, x=x, y=y)
        current = [None]
        walls = {}
        for label, folder, steps in (("first", "split", 300), ("resume", "split", 400),
                                     ("whole", "whole", 400)):
            current[0] = label
            runs[label] = []
            cfg = make_config(folder=os.path.join(tmp, folder), seed=PRIOR_SEED,
                              data={"path": data, "batch_size": 128}, model=PRIOR_MODEL,
                              optim={"lr": 1e-4, "epochs": 100},
                              logging={"log_interval": 1000}, max_steps=steps)
            t = time.perf_counter()
            prior_mod.train_prior(cfg, device="cuda")
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t
        step_ms = sorted(s.elapsed_time(e) for _, s, e, _ in runs["first"] + runs["resume"])
        loss = {i: v.item() for i, _, _, v in runs["first"] + runs["resume"]}
        if [i for i, *_ in runs["resume"]] != list(range(300, 400)):
            raise AssertionError("[prior-train] the resume did not continue at step 300")
        ckpts = [torch.load(prior_mod.checkpoint_path(os.path.join(tmp, f)), weights_only=False)
                 for f in ("split", "whole")]
        opts = [ckpt_io.load_optimizer(os.path.join(tmp, f)) for f in ("split", "whole")]
        same = all(torch.equal(v, ckpts[1]["model"][k]) for k, v in ckpts[0]["model"].items())
        same_opt = opts[0]["count"] == opts[1]["count"] == 400 and all(
            torch.equal(opts[0][m][n], opts[1][m][n]) for m in ("mu", "nu") for n in opts[0][m])
        log(f"[prior-train] {PRIOR_TRAIN_PAIRS} pairs of 512-d, batch 128, lr 1e-4, "
            f"{PRIOR_MODEL}: median step {step_ms[len(step_ms) // 2]:.3f} ms (CUDA events, "
            f"{len(step_ms)} steps, {PRIOR_TRAIN_PAIRS // 128} an epoch); "
            f"loss step 0 {loss[0]:.4f}, step 100 {loss[100]:.4f}, step 300 {loss[300]:.4f}; "
            f"wall s: 300 steps {walls['first']:.1f}, resume to 400 {walls['resume']:.1f}, "
            f"400 at once {walls['whole']:.1f}; resumed parameters bitwise equal to the "
            f"uninterrupted run's: {same}, Adam moments: {same_opt}; phase "
            f"{time.perf_counter() - t_phase:.1f} s ({smi})")
        if not (loss[100] < loss[0] and loss[300] < loss[0]):
            raise AssertionError(f"[prior-train] the loss did not fall: {loss[0]}, {loss[100]}, "
                                 f"{loss[300]}")
        if not (same and same_opt):
            raise AssertionError("[prior-train] the resumed run differs from the uninterrupted one")


def phase_diversity(smi):
    """[diversity]: the flagship train step (entry.train_entry) with 4 prompts x
    repeat 2, noise_dim 128, the diversity term (coefficient 1, between the
    repeats of each prompt, random VGG16 from the seed) against the same step
    with coefficient 0: a warm-up step each (their grads compared), then
    TRAIN_STEPS timed steps each; the VGG16 forward in bf16 on the card against
    the CPU's float32. -> the kernels' launches in the timed steps."""
    import numpy as np
    import torch

    from feed_forward_vqgan_clip_tpu_torch.entry import train_entry
    from feed_forward_vqgan_clip_tpu_torch.models.vgg import VGG16Features
    from feed_forward_vqgan_clip_tpu_torch.train.loop import STAGES as TRAIN_STAGES

    t_phase = time.perf_counter()
    counters = train_counters()
    want = {k: 0 for k in counters}
    want.update(vq_argmin=1, warp_forward=2, warp_adjoint=2, mixer_fwd_res=STREAM_DEPTH,
                mixer_channel_bwd=STREAM_DEPTH, mixer_token_bwd=STREAM_DEPTH)
    launches = {k: 0 for k in counters}
    grads, rows = {}, {}
    for coef in (0.0, 1.0):
        with fused_clip(False):
            step_fn, state, batch = train_entry(
                "cuda", batch=4, cutn=8, seed=DIVERSITY_SEED, mapper_config=dict(
                    repeat=2, noise_dim=128, diversity_coef=coef,
                    diversity_mode="between_same_prompts"))
        batch["inp"][:, 1] = 320 + torch.arange(4, device="cuda")  # 4 prompts ("out" is "inp")
        watch = [state.params[0], state.params[len(state.params) // 2], state.params[-1]]
        state, metrics = step_fn(state, batch, torch.Generator(device="cuda").manual_seed(
            DIVERSITY_SEED))
        grads[coef] = [p.grad.detach().clone() for p in watch]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for i in range(TRAIN_STEPS):
            for fn in counters.values():
                fn.launches = 0
            events = [torch.cuda.Event(enable_timing=True)]

            def mark(stage):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)

            t = time.perf_counter()
            events[0].record()
            state, metrics = step_fn(state, batch, torch.Generator(device="cuda").manual_seed(
                DIVERSITY_SEED + 1 + i), mark)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            launched = {k: fn.launches for k, fn in counters.items()}
            if launched != want:
                raise AssertionError(f"[diversity] coef {coef}: launches {launched}, need {want}")
            for k, v in launched.items():
                launches[k] += v
            loss, div = metrics["loss"].item(), metrics["diversity"].item()
            if not (np.isfinite(loss) and np.isfinite(div) and (div > 0) == (coef > 0)):
                raise AssertionError(f"[diversity] coef {coef}: loss {loss}, diversity {div}")
            steps.append([ms] + [events[j].elapsed_time(events[j + 1])
                                 for j in range(len(TRAIN_STAGES))])
        med = np.median(np.array(steps), axis=0)
        rows[coef] = med
        log(f"[diversity] coef {coef:g} (B=4 prompts x repeat 2, noise_dim 128, cutn 8, 224-px "
            f"cutouts Af/Pe/Ji/Er, bf16): steps {', '.join(f'{r[0]:.2f}' for r in steps)} ms "
            f"(host clock, synchronized); median {med[0]:.2f} ms; median CUDA-event stages "
            f"{', '.join(f'{n} {v:.2f}' for n, v in zip(TRAIN_STAGES, med[1:]))}; last loss "
            f"{loss:.6f}, diversity {div:.6f}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
        del step_fn, state, batch, watch
        torch.cuda.empty_cache()
    moved = max((a - b).abs().max().item() for a, b in zip(grads[0.0], grads[1.0]))
    if moved == 0.0:
        raise AssertionError("[diversity] the diversity term left the mapper's grads unchanged")

    cpu = VGG16Features().init_random_(torch.Generator().manual_seed(DIVERSITY_SEED))
    card = VGG16Features(dtype=torch.bfloat16, device="cuda")
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 256, 256, 3, generator=torch.Generator().manual_seed(DIVERSITY_SEED))
    with torch.no_grad():
        errs = [(g.float().cpu() - w).abs().max().item() / w.abs().max().item()
                for g, w in zip(card(x.cuda()), cpu(x))]
    stage = TRAIN_STAGES.index("diversity") + 1
    log(f"[diversity] step with the term against without: median {rows[1.0][0]:.2f} / "
        f"{rows[0.0][0]:.2f} ms, diversity stage {rows[1.0][stage]:.2f} / "
        f"{rows[0.0][stage]:.2f} ms (CUDA events); the term moves the first step's watched "
        f"grads by up to {moved:.3e}; VGG16 bf16 on the card against the CPU's float32 "
        f"(2 x 256 px), max abs err / max |CPU| per slice "
        f"{', '.join(f'{e:.2e}' for e in errs)} (limit 2e-2); phase "
        f"{time.perf_counter() - t_phase:.1f} s ({smi})")
    if not max(errs) <= 2e-2:
        raise AssertionError("[diversity] the card's VGG16 disagrees with the CPU's")
    return launches


def phase_eval(smi):
    """[eval]: `cli evaluate` on the flagship `.th` over EVAL_PROMPTS prompts of
    the synthetic BPE table, batch EVAL_BATCH, eval perceptor ViT-B/32 at random,
    FID through a random InceptionV3 against seeded "real" features: prompts/s,
    the Inception's CUDA-event ms per batch, the FID's host time, the artifacts.
    -> the kernels' launches in the run."""
    import numpy as np
    import torch

    from feed_forward_vqgan_clip_tpu_torch.data.datasets import save_tokens
    from feed_forward_vqgan_clip_tpu_torch.eval import evaluate as evaluate_mod
    from feed_forward_vqgan_clip_tpu_torch.tokenizer import bpe

    t_phase = time.perf_counter()
    counters = serve_counters()
    inception_events, fid_s, records = [], [], {}
    make_inception = evaluate_mod.make_inception_fn
    fid = evaluate_mod.frechet_distance

    def timed_inception(*a, **k):
        fn = make_inception(*a, **k)

        def run(x):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(x)
            end.record()
            inception_events.append((start, end))
            return out

        return run

    def timed_fid(a, b):
        t = time.perf_counter()
        out = fid(a, b)
        fid_s.append(time.perf_counter() - t)
        return out

    class Stamps(logging.Handler):
        """evaluate's own log: the times of "Evaluate on ..." (before the prompt
        loop) and "FID: ..." (after the loop and the FID)."""

        def emit(self, record):
            records[record.getMessage().split()[0]] = record.created

    stamps, level = Stamps(), evaluate_mod.log.level
    evaluate_mod.log.addHandler(stamps)
    evaluate_mod.log.setLevel(logging.INFO)
    with tempfile.TemporaryDirectory() as tmp, bpe_table(tmp), \
            patched(evaluate_mod, make_inception_fn=timed_inception, frechet_distance=timed_fid):
        path = save_flagship(tmp, EVAL_SEED)
        toks = os.path.join(tmp, "prompts.npz")
        save_tokens(bpe.get_tokenizer().tokenize([f"hello world {i}" for i in range(EVAL_PROMPTS)],
                                                 truncate=True), toks)
        real = os.path.join(tmp, "real_features.npy")
        np.save(real, np.random.default_rng(EVAL_SEED).standard_normal((512, 2048),
                                                                       dtype=np.float32))
        out = os.path.join(tmp, "eval")
        for fn in counters.values():
            fn.launches = 0
        t = time.perf_counter()
        run_cli(["evaluate", path, toks, "--batch-size", str(EVAL_BATCH), "--compute-fid",
                 "--inception-features-real-path", real, "--out-folder", out])
        torch.cuda.synchronize()
        end = time.perf_counter()
        launches = {k: fn.launches for k, fn in counters.items()}
        batches = -(-EVAL_PROMPTS // EVAL_BATCH)
        need = {"vq_argmin": batches, "mixer_stream": 0, "mixer_block": batches * STREAM_DEPTH}
        if launches != need:
            raise AssertionError(f"[eval] launches {launches}, need {need}")
        with open(os.path.join(out, "eval_prompts.npz_ViT-B_32.json")) as fd:
            dump = json.load(fd)
        artifacts = sorted(os.listdir(out))
        inception_ms = sorted(s.elapsed_time(e) for s, e in inception_events)
        evaluate_mod.log.removeHandler(stamps)
        evaluate_mod.log.setLevel(level)
        loop_s = records["FID:"] - records["Evaluate"] - sum(fid_s)
        log(f"[eval] `cli evaluate` on the flagship `.th`, {EVAL_PROMPTS} prompts, batch "
            f"{EVAL_BATCH}, eval perceptor ViT-B/32 (random), --compute-fid: command "
            f"{end - t:.1f} s, of it the prompt loop {loop_s:.2f} s = "
            f"{EVAL_PROMPTS / loop_s:.1f} prompts/s and the FID's host math {sum(fid_s):.2f} s; "
            f"InceptionV3 ms per batch of {EVAL_BATCH} (CUDA events) "
            f"{', '.join(f'{v:.2f}' for v in inception_ms)}; artifacts {artifacts}; json "
            f"{dump}; launches {launches}; phase {time.perf_counter() - t_phase:.1f} s ({smi})")
        keys = {"clip_score_mean", "clip_score_std", "clip_score_atleast_25",
                "fid_real_features.npy"}
        if set(dump) != keys or not all(np.isfinite(v) for v in dump.values()):
            raise AssertionError(f"[eval] the JSON holds {dump}, need finite {sorted(keys)}")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- [perceptors], [native-ckpt], [encode]


def haiku_payload(sd, cfg):
    """The port's CrowsonCLOOB state dict as the released haiku pickle's
    {"params": (image_tree, text_tree)} of numpy arrays (models/cloob.py
    `haiku_state_dict` inverted: Linear weights transposed to haiku's (in, out),
    the patch kernel OIHW -> HWIO, LayerNorm biases as `offset`)."""
    a = {k: v.detach().float().cpu().numpy() for k, v in sd.items()}
    lin = (("query", "self_attention/multi_head_attention/query"),
           ("key", "self_attention/multi_head_attention/key"),
           ("value", "self_attention/multi_head_attention/value"),
           ("out", "self_attention/multi_head_attention/linear"),
           ("linear_0", "feed_forward/linear_0"), ("linear_1", "feed_forward/linear_1"))

    def tower(prefix, base, n):
        tree = {f"{base}/pos_embed": {"w": a[f"{prefix}.pos_embed"]},
                f"{base}/proj": {"w": a[f"{prefix}.proj.weight"].T.copy(),
                                 "b": a[f"{prefix}.proj.bias"]}}
        for i in range(n):
            p, h = f"{prefix}.layers.{i}", f"{base}/layer_{i}"
            for port, hk in (("attn_norm", "self_attention/layer_norm"),
                             ("ff_norm", "feed_forward/layer_norm")):
                tree[f"{h}/{hk}"] = {"scale": a[f"{p}.{port}.weight"],
                                     "offset": a[f"{p}.{port}.bias"]}
            for port, hk in lin:
                tree[f"{h}/{hk}"] = {"w": a[f"{p}.{port}.weight"].T.copy(),
                                     "b": a[f"{p}.{port}.bias"]}
        return tree

    ib, tb = "vi_t_image_encoder", "text_encoder"
    img = tower("image_encoder", ib, cfg["image_layers"])
    img[ib] = {"class_embed": a["image_encoder.class_embed"]}
    img[f"{ib}/embed"] = {"w": a["image_encoder.embed.weight"].transpose(2, 3, 1, 0).copy()}
    txt = tower("text_encoder", tb, cfg["text_layers"])
    txt[f"{tb}/embed"] = {"embeddings": a["text_encoder.embed.weight"]}
    return {"params": (img, txt)}


def perceptor_card_vs_cpu(label, name, path, size, smi):
    """`load_perceptor(name, path)` in float32 on the card and on the CPU: two rows
    of encode_text and encode_image within 1e-4 of max(1, max |CPU|); then in
    bf16 on the card, encode_text and encode_image of 8 rows timed (CUDA events)
    with the load's peak memory. -> {check: error}."""
    import numpy as np
    import torch

    from feed_forward_vqgan_clip_tpu_torch.entry import example_tokens
    from feed_forward_vqgan_clip_tpu_torch.models.perceptor import load_perceptor

    toks = example_tokens(2)
    x = torch.from_numpy(np.random.default_rng(PERCEPTORS_SEED).normal(
        size=(2, size, size, 3)).astype(np.float32))
    errs = {}
    cpu = load_perceptor(name, path, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        want = (cpu.encode_text(toks), cpu.encode_image(x))
    del cpu
    card = load_perceptor(name, path, dtype=torch.float32, device="cuda")
    with torch.no_grad():
        got = (card.encode_text(toks.cuda()).cpu(), card.encode_image(x.cuda()).cpu())
    del card
    for check, g, w in zip(("encode_text", "encode_image"), got, want):
        err = (g - w).abs().max().item()
        limit = 1e-4 * max(1.0, w.abs().max().item())
        errs[check] = err
        if not (np.isfinite(err) and err <= limit):
            raise AssertionError(f"[perceptors] {label} {check}: card vs CPU {err:.3e} > "
                                 f"{limit:.3e}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    p = load_perceptor(name, path, dtype=torch.bfloat16, device="cuda")
    load_s = time.perf_counter() - t
    toks8 = example_tokens(8, "cuda")
    x8 = torch.randn(8, size, size, 3, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(PERCEPTORS_SEED))
    with torch.no_grad():
        text_ms = cuda_ms(lambda: p.encode_text(toks8), iters=5, warmup=2)
        image_ms = cuda_ms(lambda: p.encode_image(x8), iters=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[perceptors] {label}: card vs CPU (float32, 2 rows) encode_text "
        f"{errs['encode_text']:.3e}, encode_image {errs['encode_image']:.3e}; bf16 on the card: "
        f"loaded in {load_s:.1f} s, encode_text 8 rows {text_ms:.2f} ms, encode_image 8 x "
        f"{size} px {image_ms:.2f} ms (CUDA events), peak {peak:.2f} GiB ({smi})")
    del p
    torch.cuda.empty_cache()
    return errs


def phase_perceptors(smi):
    """[perceptors]: crowsonkb's CLOOB ViT-B/16 at full width, random from
    PERCEPTORS_SEED, written as a haiku pickle and loaded by name and path: card
    vs CPU, stage ms; the flagship Mixer served with it (1x1, 2x2: K1, K4) and
    trained one step (K1, K6-K8 x 32, K9 x 2, K10 x 2) through `mapper_model_run`.
    Then OpenCLIP ViT-B-16-plus-240 at its published widths, random, as fp16
    OpenCLIP state dicts (one with the text tower under `text.`): the config
    sniffed from each equal to those widths, card vs CPU, stage ms. -> the
    kernels' launches."""
    import pickle

    import torch

    from feed_forward_vqgan_clip_tpu_torch.io.clip_arch import sniff_clip_arch
    from feed_forward_vqgan_clip_tpu_torch.models import cloob
    from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip_from_config

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = cloob.CROWSON_CONFIGS[CLOOB_NAME]
        t = time.perf_counter()
        src = cloob.CrowsonCLOOB(cfg).init_random_(torch.Generator().manual_seed(PERCEPTORS_SEED))
        path = os.path.join(tmp, f"{CLOOB_NAME}.pkl")
        with open(path, "wb") as fd:
            pickle.dump(haiku_payload(src.state_dict(), cfg), fd, protocol=4)
        n_params = sum(p.numel() for p in src.parameters())
        back = cloob.haiku_state_dict(cloob.read_haiku_pickle(path), cfg)
        if any(not torch.equal(back[k], v) for k, v in src.state_dict().items()):
            raise AssertionError("[perceptors] the haiku pickle does not read back bitwise")
        log(f"[perceptors] {CLOOB_NAME}: {n_params / 1e6:.1f} M parameters (image 12 x 768 "
            f"at 224 px, patch 16; text 12 x 512), haiku pickle "
            f"{os.path.getsize(path) / 2**20:.1f} MiB written and read back bitwise in "
            f"{time.perf_counter() - t:.1f} s ({smi})")
        del src, back
        perceptor_card_vs_cpu(CLOOB_NAME, CLOOB_NAME, path, 224, smi)
        launches = mapper_model_run(
            "mlp_mixer_32x1024_cloob_vit_b16",
            dict(clip_model=CLOOB_NAME, clip_model_path=path, model_type="mlp_mixer", dim=1024,
                 depth=32, vq_image_size=16), ("1x1", "2x2"), PERCEPTORS_SEED, smi)

        width = OPENCLIP_PLUS_240
        src = make_clip_from_config(width, act="gelu", image=True)
        src.init_random_(torch.Generator().manual_seed(PERCEPTORS_SEED + 1))
        sd = {k: v.half() for k, v in src.state_dict().items()}
        del src
        text_keys = ("token_embedding.weight", "positional_embedding", "ln_final.weight",
                     "ln_final.bias", "text_projection")
        layouts = {"openclip": sd, "text_nested": {
            (f"text.{k}" if k.startswith("transformer.") or k in text_keys else k): v
            for k, v in sd.items()}}
        for layout, state in layouts.items():
            path = os.path.join(tmp, f"open_clip_{layout}.pt")
            torch.save(state, path)
            family, got = sniff_clip_arch(torch.load(path, weights_only=True))
            if family != "vit" or got != {k: width[k] for k in got}:
                raise AssertionError(f"[perceptors] {OPENCLIP_NAME} ({layout}): sniffed "
                                     f"{family} {got}, need {width}")
            log(f"[perceptors] {OPENCLIP_NAME} ({layout} layout, fp16, "
                f"{os.path.getsize(path) / 2**20:.1f} MiB): sniffed {family} {got}")
            perceptor_card_vs_cpu(f"{OPENCLIP_NAME} ({layout})", OPENCLIP_NAME, path,
                                  width["image_size"], smi)
    log(f"[perceptors] launches {launches}; phase {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


class _StandInModule:
    """A stand-in for the reference's `mlp_mixer_pytorch` module while a mapper is
    pickled whole (a legacy checkpoint), unregistered after."""

    def __init__(self, mapper):
        import types

        self.mod = types.ModuleType(LEGACY_MODULE)
        cls = type("MLPMixer", (type(mapper),), {"__module__": LEGACY_MODULE})
        cls.__qualname__ = "MLPMixer"
        self.mod.MLPMixer = cls
        self.mapper = mapper

    def save(self, path, cfg, noise):
        import torch

        sys.modules[LEGACY_MODULE] = self.mod
        try:
            self.mapper.__class__ = self.mod.MLPMixer
            self.mapper.config, self.mapper.NOISE = dict(cfg), noise
            torch.save(self.mapper, path)
        finally:
            del sys.modules[LEGACY_MODULE]


def phase_native_ckpt(smi):
    """[native-ckpt]: the flagship Mixer at noise_dim 128 (as [diversity]) with a
    noise bank, random from NATIVE_CKPT_SEED, written as a `.th` and as a JAX
    checkpoint directory (params.msgpack by io/from_jax.mixer_tree and the port's
    msgpack writer, meta.json, noise.npy); one Predictor serves both: the 1x1 and
    2x2 images and PNGs of the two bitwise equal (K1, K4). The directory's bytes
    and read seconds. A legacy whole-module pickle of a stand-in mapper (a small
    Mixer pickled as the reference's class) loads and gives the mapper's outputs
    bitwise. -> the kernels' launches."""
    import numpy as np
    import torch

    from feed_forward_vqgan_clip_tpu_torch.config import make_config
    from feed_forward_vqgan_clip_tpu_torch.io import checkpoint as ckpt_io
    from feed_forward_vqgan_clip_tpu_torch.io.from_jax import mixer_tree
    from feed_forward_vqgan_clip_tpu_torch.models.mappers import build_mapper
    from feed_forward_vqgan_clip_tpu_torch.serve import predictor as predictor_mod

    t_phase = time.perf_counter()
    counters = serve_counters()
    cfg = dict(FLAGSHIP_CONFIG, noise_dim=128)
    bank = np.random.default_rng(NATIVE_CKPT_SEED).standard_normal((16, 128), dtype=np.float32)
    record = []
    with tempfile.TemporaryDirectory() as tmp, bpe_table(tmp), \
            patched(predictor_mod, make_grid=recorded_images(record)):
        mapper = build_mapper(make_config(**cfg), vq_channels=256, device="cuda")
        mapper.init_random_(torch.Generator(device="cuda").manual_seed(NATIVE_CKPT_SEED))
        n_params = sum(p.numel() for p in mapper.parameters())
        th = ckpt_io.save_model(os.path.join(tmp, "flagship.th"), mapper, cfg, noise=bank)
        t = time.perf_counter()
        tree = mixer_tree(mapper.state_dict())
        jdir = ckpt_io.save_checkpoint_dir(tmp, "flagship_jax", tree, cfg, step=1000, epoch=3,
                                           noise=bank)
        write_s = time.perf_counter() - t
        del mapper, tree
        torch.cuda.empty_cache()
        msg = os.path.join(jdir, "params.msgpack")
        t = time.perf_counter()
        ckpt_io.load_pytree(msg)
        read_s = time.perf_counter() - t
        t = time.perf_counter()
        got_tree, got_cfg, step, epoch, noise = ckpt_io.load_checkpoint(jdir)
        dir_s = time.perf_counter() - t
        if (step, epoch) != (1000, 3) or not np.array_equal(noise.numpy(), bank):
            raise AssertionError(f"[native-ckpt] meta or noise wrong: {step}, {epoch}")
        del got_tree
        log(f"[native-ckpt] the flagship Mixer at noise_dim 128 ({n_params / 1e6:.1f} M f32 "
            f"parameters): params.msgpack {os.path.getsize(msg)} bytes "
            f"({os.path.getsize(msg) / 2**30:.3f} GiB) written (mixer_tree + the msgpack writer)"
            f" in {write_s:.2f} s; read by load_pytree in {read_s:.2f} s "
            f"({os.path.getsize(msg) / 2**30 / read_s:.2f} GiB/s), the whole directory "
            f"(meta.json, noise.npy) in {dir_s:.2f} s; `.th` {os.path.getsize(th)} bytes ({smi})")
        t = time.perf_counter()
        pred = predictor_mod.Predictor([th, jdir], device="cuda")
        pred.setup()
        setup_s = time.perf_counter() - t
        if sorted(pred.models) != ["flagship.th", "flagship_jax"]:
            raise AssertionError(f"[native-ckpt] Predictor loaded {sorted(pred.models)}")
        for fn in counters.values():
            fn.launches = 0
        for grid in ("1x1", "2x2"):
            imgs, pngs = [], []
            for name in ("flagship.th", "flagship_jax"):
                record.clear()
                out = pred.predict(PROMPT, name, grid_size=grid, seed=NATIVE_CKPT_SEED,
                                   out_path=os.path.join(tmp, f"{name}_{grid}.png"))
                (img,) = record
                imgs.append(img)
                with open(out, "rb") as fd:
                    pngs.append(fd.read())
            if not (np.array_equal(imgs[0], imgs[1]) and pngs[0] == pngs[1]):
                raise AssertionError(f"[native-ckpt] {grid}: the directory's images differ from "
                                     "the .th's")
        launches = {k: fn.launches for k, fn in counters.items()}
        need = {"vq_argmin": 4, "mixer_stream": 4, "mixer_block": 0}
        if launches != need:
            raise AssertionError(f"[native-ckpt] launches {launches}, need {need}")
        log(f"[native-ckpt] Predictor.setup() on the `.th` and the directory {setup_s:.1f} s; "
            f"1x1 and 2x2 images and PNGs bitwise equal between the two; launches {launches} "
            f"({smi})")
        del pred
        torch.cuda.empty_cache()

        small = dict(FLAGSHIP_CONFIG, dim=128, depth=2, compute_dtype="float32", noise_dim=8)
        mapper = build_mapper(make_config(**small), vq_channels=256, device="cuda")
        mapper.init_random_(torch.Generator(device="cuda").manual_seed(NATIVE_CKPT_SEED + 1))
        x = torch.randn(3, 520, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(NATIVE_CKPT_SEED))
        with torch.no_grad():
            want = mapper(x)
        legacy = os.path.join(tmp, "legacy.th")
        _StandInModule(mapper).save(legacy, small, torch.from_numpy(bank[:4, :8]))
        got, got_cfg, got_noise = ckpt_io.load_model(legacy, device="cuda")
        same = all(torch.equal(got.state_dict()[k], v) for k, v in mapper.state_dict().items())
        with torch.no_grad():
            err = (got(x) - want).abs().max().item() / want.abs().max().item()
        if not (same and err <= 1e-6 and got_cfg["dim"] == 128
                and torch.equal(got_noise, torch.from_numpy(bank[:4, :8]))):
            raise AssertionError(f"[native-ckpt] the legacy pickle does not load as pickled: "
                                 f"parameters equal {same}, outputs {err:.3e}")
        log(f"[native-ckpt] legacy whole-module pickle ({LEGACY_MODULE}.MLPMixer, not "
            f"importable): loaded, parameters bitwise equal to the pickled mapper's, outputs "
            f"{err:.3e} of max apart, config and NOISE back; phase "
            f"{time.perf_counter() - t_phase:.1f} s ({smi})")
    torch.cuda.empty_cache()
    return launches


def jpeg_pairs(folder, n, shards, seed):
    """n seeded 256 x 256 JPEG / caption pairs in `shards` webdataset tars (sample 1
    corrupt: its image bytes are no JPEG) -> the tars' glob pattern."""
    import io
    import tarfile

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:256, 0:256]
    words = ["a", "red", "blue", "cat", "dog", "on", "the", "hello", "world", "painting",
             "of", "city", "at", "night"]
    per = n // shards
    for s in range(shards):
        with tarfile.open(os.path.join(folder, f"shard-{s:03d}.tar"), "w") as tf:
            for i in range(s * per, (s + 1) * per):
                a, b, c = rng.integers(1, 7, size=3)
                img = np.stack([(xx * a + yy * b) % 256, (xx * c + 40 * (i % 7)) % 256,
                                (yy * a + xx * c) % 256], -1).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, "JPEG", quality=90)
                data = b"\xff\xd8 not a jpeg" if i == 1 else buf.getvalue()
                text = " ".join(rng.choice(words, size=int(rng.integers(3, 9))))
                for name, payload in ((f"{i:06d}.input.jpg", data),
                                      (f"{i:06d}.output.txt", text.encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(payload)
                    tf.addfile(info, io.BytesIO(payload))
    return os.path.join(folder, "shard-*.tar")


@contextlib.contextmanager
def merge_counts():
    """The words ClipTokenizer._merge_new is given, and the new ones it merges
    through the native core, counted while the block runs."""
    from feed_forward_vqgan_clip_tpu_torch.tokenizer import bpe

    counts = {"words": 0, "core": 0}
    merge_new = bpe.ClipTokenizer._merge_new

    def counted(self, words):
        before = len(self._id_cache)
        merge_new(self, words)
        counts["words"] += len(words)
        if self.native is not None:
            counts["core"] += len(self._id_cache) - before

    with patched(bpe.ClipTokenizer, _merge_new=counted):
        yield counts


def tokenize_native_vs_python(tmp, label, lines):
    """`cli tokenize` on `lines` with the native core and with pure Python, on
    the table in force: equal tokens asserted; (seconds, words merged) of each."""
    from feed_forward_vqgan_clip_tpu_torch import native
    from feed_forward_vqgan_clip_tpu_torch.tokenizer import bpe

    import numpy as np

    prompts = os.path.join(tmp, f"prompts_{label}.txt")
    with open(prompts, "w") as fd:
        fd.write("\n".join(lines) + "\n")
    secs, toks, counts = {}, {}, {}
    for path, lib in (("native", native.get_lib()), ("python", None)):
        bpe.get_tokenizer.cache_clear()
        out = os.path.join(tmp, f"tok_{label}_{path}.npz")
        with patched(native, _LIB=lib, _TRIED=True), merge_counts() as counts[path]:
            t = time.perf_counter()
            run_cli(["tokenize", prompts, "--out", out])
            secs[path] = time.perf_counter() - t
            if (bpe.get_tokenizer().native is None) != (lib is None):
                raise AssertionError(f"[encode] tokenize {label} {path}: the wrong path ran")
        with np.load(out) as z:
            toks[path] = z["tokens"]
    bpe.get_tokenizer.cache_clear()
    if not np.array_equal(toks["native"], toks["python"]):
        raise AssertionError(f"[encode] tokenize {label}: the native core's tokens differ")
    return secs, counts["native"], int((toks["native"] > 0).sum())


def letter_merges(seed, trigrams=2000):
    """A synthetic merge table: the 26 x 26 letter bigrams, the same at a word's
    end, and `trigrams` merges of a bigram and a letter (each also at a word's
    end), in a seeded order; a word of random letters takes several merges, as
    words do under the released table (which is not in the repository)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = "abcdefghijklmnopqrstuvwxyz"
    pairs = [a + b for a in letters for b in letters]
    merges = [f"{p[0]} {p[1]}" for p in rng.permutation(pairs)]
    merges += [f"{p[0]} {p[1]}</w>" for p in rng.permutation(pairs)]
    for t in rng.choice(len(pairs) * 26, size=trigrams, replace=False):
        ab, c = pairs[t // 26], letters[t % 26]
        merges += [f"{ab} {c}", f"{ab} {c}</w>"]
    return merges


def irv2_nima_file(path, seed):
    """A NIMA on the IRv2 trunk, random from `seed`, saved in Cadene's key names
    under pyiqa's `base_model.` with the head as `classifier.2` -> `path`."""
    import torch

    from feed_forward_vqgan_clip_tpu_torch.models import nima

    model = nima.NIMA("inception_resnet_v2").init_random_(torch.Generator().manual_seed(seed))
    sd = {(f"base_model.{k[len('backbone.'):]}" if k.startswith("backbone.")
           else k.replace("classifier.", "classifier.2.")): v
          for k, v in model.state_dict().items()}
    torch.save(sd, path)
    return path


def phase_encode(smi):
    """[encode]: ENCODE_PAIRS seeded 256-px JPEG / caption pairs in 4 tars (one
    corrupt) through `cli encode-text-and-images-webdataset` with ViT-B/32
    (random from ENCODE_SEED, a torch file) at the JAX default batch of 512 and
    the NIMA filter on the IRv2
    trunk (random, Cadene keys), its threshold the median MOS of a first scoring
    pass over the first batch's images: pairs/s, CUDA-event ms per batch of the
    text tower, the image tower and NIMA, the host's share of the loop, the
    rows dropped. Checks: the card's features against the CPU's on 8 samples
    (float32); on one tar, spill (spill_rows 1000) and no prefetch each equal to
    the default run, bitwise; `cli merge-features` of two outputs equal to their
    concatenation, read by `train/prior.py` for a few steps with a finite loss;
    `cli tokenize` on 10000 lines, native BPE core against pure Python, equal."""
    import io
    import tarfile
    import types

    import numpy as np
    import torch
    from PIL import Image

    from feed_forward_vqgan_clip_tpu_torch.config import make_config
    from feed_forward_vqgan_clip_tpu_torch.data import encode as encode_mod
    from feed_forward_vqgan_clip_tpu_torch.models import nima as nima_mod
    from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import make_clip
    from feed_forward_vqgan_clip_tpu_torch.tokenizer import bpe
    from feed_forward_vqgan_clip_tpu_torch.train import prior as prior_mod

    t_phase = time.perf_counter()
    events = {"text": [], "image": [], "nima": []}

    def timed(stage, fn):
        def run(*a):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a)
            end.record()
            events[stage].append((start, end))
            return out

        return run

    load_perceptor, make_nima_fn = encode_mod.load_perceptor, nima_mod.make_nima_fn

    def timed_perceptor(*a, **k):
        p = load_perceptor(*a, **k)
        return p._replace(module=types.SimpleNamespace(
            encode_text=timed("text", p.module.encode_text),
            encode_image=timed("image", p.module.encode_image)))

    def timed_nima(*a, **k):
        return timed("nima", make_nima_fn(*a, **k))

    with tempfile.TemporaryDirectory() as tmp, bpe_table(tmp):
        t = time.perf_counter()
        pattern = jpeg_pairs(tmp, ENCODE_PAIRS, 4, ENCODE_SEED)
        made_s = time.perf_counter() - t
        if bpe.get_tokenizer().native is None:
            raise AssertionError("[encode] the native BPE core did not build on this machine")
        weights = irv2_nima_file(os.path.join(tmp, "nima_irv2.pth"), ENCODE_SEED)
        clip = make_clip("ViT-B/32", image=True).init_random_(
            torch.Generator().manual_seed(ENCODE_SEED))
        clip_path = os.path.join(tmp, "vit_b32.pt")
        torch.save(clip.state_dict(), clip_path)
        del clip
        first = sorted(p for p in os.listdir(tmp) if p.endswith(".tar"))[0]
        with tarfile.open(os.path.join(tmp, first)) as tf:
            imgs = []
            for m in tf.getmembers():
                if m.name.endswith(".jpg") and len(imgs) < ENCODE_BATCH:
                    try:
                        imgs.append(encode_mod.preprocess_image(
                            Image.open(io.BytesIO(tf.extractfile(m).read()))))
                    except Exception:  # the corrupt sample, skipped as the encoder skips it
                        pass
        x01 = np.stack(imgs) * np.asarray(encode_mod.CLIP_STD, np.float32) + np.asarray(
            encode_mod.CLIP_MEAN, np.float32)
        with torch.no_grad():
            scores = make_nima_fn(weights, device="cuda")(torch.from_numpy(x01).cuda()).cpu()
        threshold = float(scores.median())
        log(f"[encode] {ENCODE_PAIRS} pairs (256 x 256 JPEG) in 4 tars made in {made_s:.1f} s; "
            f"NIMA (IRv2, random, Cadene keys) first scoring pass over {len(imgs)} images: MOS "
            f"{scores.min().item():.5f} .. {scores.max().item():.5f}, threshold (median) "
            f"{threshold:.6f}")
        out = os.path.join(tmp, "features.npz")
        torch.cuda.synchronize()
        with patched(encode_mod, load_perceptor=timed_perceptor), \
                patched(nima_mod, make_nima_fn=timed_nima), merge_counts() as merged_words:
            t = time.perf_counter()
            run_cli(["encode-text-and-images-webdataset", pattern, "--clip-path", clip_path,
                     "--batch-size", str(ENCODE_BATCH), "--out", out,
                     "--image-quality-threshold", repr(threshold), "--nima-weights-path",
                     weights])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        x, y = encode_mod._load_pairs(out)
        batches = -(-(ENCODE_PAIRS - 1) // ENCODE_BATCH)
        ms = {k: [s.elapsed_time(e) for s, e in v] for k, v in events.items()}
        if len(ms["nima"]) != batches or not (0 < len(x) < ENCODE_PAIRS - 1):
            raise AssertionError(f"[encode] {len(ms['nima'])} NIMA batches, {len(x)} rows kept")
        if x.shape[1:] != (512,) or y.shape != x.shape or not (np.isfinite(x).all()
                                                                and np.isfinite(y).all()):
            raise AssertionError(f"[encode] features {x.shape} {y.shape}, not finite (N, 512)")
        device_s = sum(sum(v) for v in ms.values()) / 1e3
        dropped = ENCODE_PAIRS - 1 - len(x)

        def med(v):
            return sorted(v)[len(v) // 2]

        log(f"[encode] `cli encode-text-and-images-webdataset`, ViT-B/32 (random, bf16), batch "
            f"{ENCODE_BATCH}, NIMA filter: {ENCODE_PAIRS - 1} valid pairs in {wall:.2f} s = "
            f"{(ENCODE_PAIRS - 1) / wall:.1f} pairs/s; kept {len(x)}, dropped {dropped}, the "
            f"corrupt one skipped; median ms per batch (CUDA events): text tower "
            f"{med(ms['text']):.2f}, image tower {med(ms['image']):.2f}, NIMA "
            f"{med(ms['nima']):.2f}; device stages {device_s:.2f} s of the loop's {wall:.2f} s: "
            f"host share {1 - device_s / wall:.3f}; the captions' {merged_words['words']} words "
            f"took the native BPE core {merged_words['core']} times, the id cache the rest "
            f"({smi})")

        # the card against the CPU on 8 samples, float32
        small = os.path.join(tmp, "small")
        os.makedirs(small)
        with tarfile.open(os.path.join(tmp, first)) as src, \
                tarfile.open(os.path.join(small, "s-000.tar"), "w") as dst:
            members = [m for m in src.getmembers() if int(m.name[:6]) in range(2, 10)]
            for m in members:
                dst.addfile(m, io.BytesIO(src.extractfile(m).read()))
        feats = {}
        f32 = lambda *a, **k: load_perceptor(*a, **{**k, "dtype": torch.float32})  # noqa: E731
        with patched(encode_mod, load_perceptor=f32):
            for dev in ("cpu", "cuda"):
                feats[dev] = encode_mod._load_pairs(encode_mod.encode_text_and_images_webdataset(
                    os.path.join(small, "s-*.tar"), clip_path=clip_path, batch_size=8,
                    device=dev, out=os.path.join(small, f"f_{dev}.npz")))
        errs = []
        for got, want in zip(feats["cuda"], feats["cpu"]):
            err = float(np.abs(got - want).max())
            errs.append(err)
            if got.shape != (8, 512) or not err <= 1e-4 * max(1.0, float(np.abs(want).max())):
                raise AssertionError(f"[encode] card vs CPU {got.shape} {err:.3e}")

        # spill and no prefetch against the default run, one tar
        one = os.path.join(tmp, first)
        runs = {}
        for label, kw in (("default", {}), ("spill", dict(spill_rows=1000)),
                          ("sequential", dict(prefetch=False))):
            t = time.perf_counter()
            runs[label] = encode_mod._load_pairs(encode_mod.encode_text_and_images_webdataset(
                one, clip_path=clip_path, batch_size=ENCODE_BATCH,
                out=os.path.join(tmp, f"one_{label}.npz"), **kw))
            runs[label] += (time.perf_counter() - t,)
        for label in ("spill", "sequential"):
            if not all(np.array_equal(a, b) for a, b in zip(runs[label][:2], runs["default"][:2])):
                raise AssertionError(f"[encode] {label} differs from the default run")
        merged = os.path.join(tmp, "merged.npz")
        run_cli(["merge-features", os.path.join(tmp, "one_default.npz"), out, "--out", merged])
        mx, my = encode_mod._load_pairs(merged)
        if not (np.array_equal(mx, np.concatenate([runs["default"][0], x]))
                and np.array_equal(my, np.concatenate([runs["default"][1], y]))):
            raise AssertionError("[encode] merge-features is not the concatenation")
        losses = []
        step = prior_mod.make_prior_step

        def kept_loss(flow, state):
            fn = step(flow, state)

            def run(xb, yb):
                metrics = fn(xb, yb)
                losses.append(metrics["loss"].item())
                return metrics

            return run

        with patched(prior_mod, make_prior_step=kept_loss):
            prior_mod.train_prior(make_config(
                folder=os.path.join(tmp, "prior"), seed=ENCODE_SEED,
                data={"path": merged, "batch_size": 128}, model=PRIOR_MODEL,
                optim={"lr": 1e-4, "epochs": 1}, logging={"log_interval": 1000}, max_steps=5),
                device="cuda")
        if len(losses) != 5 or not np.isfinite(losses).all():
            raise AssertionError(f"[encode] the prior trainer on the merged file: {losses}")
        log(f"[encode] card vs CPU (8 samples, float32): text {errs[0]:.3e}, image "
            f"{errs[1]:.3e}; one tar ({len(runs['default'][0])} pairs): default "
            f"{runs['default'][2]:.2f} s, spill_rows 1000 {runs['spill'][2]:.2f} s, no prefetch "
            f"{runs['sequential'][2]:.2f} s, both bitwise equal to the default; merge-features "
            f"of two outputs ({len(mx)} rows) equal to their concatenation; train_prior on it, "
            f"5 steps, loss {losses[0]:.4f} .. {losses[-1]:.4f} ({smi})")

        # cli tokenize: the native core against pure Python, on a synthetic table of
        # letter merges (the released table is not in the repository), over random
        # letter words and over prompt-like English
        rng = np.random.default_rng(ENCODE_SEED)
        letters = list("abcdefghijklmnopqrstuvwxyz")
        texts = {
            "letters": [" ".join("".join(rng.choice(letters, size=int(rng.integers(2, 9))))
                                 for _ in range(int(rng.integers(3, 12))))
                        for _ in range(TOKENIZE_LINES)],
            "english": [" ".join(rng.choice(PROMPT_WORDS, size=int(rng.integers(3, 12))))
                        for _ in range(TOKENIZE_LINES)],
        }
        merges = letter_merges(ENCODE_SEED)
        with bpe_table(tmp, merges):
            for label, lines in texts.items():
                secs, core, ids = tokenize_native_vs_python(tmp, label, lines)
                log(f"[encode] `cli tokenize` on {TOKENIZE_LINES} lines of {label} words "
                    f"({len(merges)} synthetic letter merges, {ids} ids; {core['words']} words, "
                    f"{core['core']} of them through the native core): native BPE core "
                    f"{secs['native']:.2f} s, pure Python {secs['python']:.2f} s "
                    f"({secs['python'] / secs['native']:.2f}x), tokens equal ({smi})")
        log(f"[encode] phase {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()


def torch_pools():
    """The cutouts' pools as torch's F.adaptive_{avg,max}_pool2d (atomic CUDA
    backwards: the port's pools before the matmul formulation) while the block
    runs, restored after it."""
    import torch.nn.functional as F

    from feed_forward_vqgan_clip_tpu_torch.ops import cutouts

    nchw = lambda pool: lambda x, size: pool(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)  # noqa: E731
    return patched(cutouts, adaptive_avg_pool=nchw(F.adaptive_avg_pool2d),
                   adaptive_max_pool=nchw(F.adaptive_max_pool2d))


@contextlib.contextmanager
def patched(module, **attrs):
    """`module`'s attributes replaced by `attrs` while the block runs."""
    old = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in old.items():
            setattr(module, name, value)


def step_ab():
    """`python3 chip_smoke.py --step-ab`: what the trainer's two determinism
    repairs cost the flagship train step (entry.train_entry, module tower), in
    one process: the step as train() runs it (the matmul pools, cuDNN held to
    its deterministic algorithms), without the cuDNN guard, and with torch's
    pools inside the guard. A warm-up each, then AB_ROUNDS rounds with the
    three in rotated order; median host ms (synchronized after each step) and
    median per-stage CUDA-event ms of each. Then [trainer]'s depth-2 resume check
    without the guard. The card's line is printed last."""
    import numpy as np
    import torch

    from feed_forward_vqgan_clip_tpu_torch.entry import EOT, SOT, train_entry
    from feed_forward_vqgan_clip_tpu_torch.train import loop
    from feed_forward_vqgan_clip_tpu_torch.train.loop import STAGES

    smi = phase_device()
    phase_build()
    labels = ("as train() runs it", "without the cuDNN guard", "torch's pools, in the guard")

    def in_variant(label):
        stack = contextlib.ExitStack()
        if label != "without the cuDNN guard":
            stack.enter_context(loop.deterministic_convolutions())
        if label == "torch's pools, in the guard":
            stack.enter_context(torch_pools())
        return stack

    step_fn, state, batch = train_entry("cuda", batch=8, cutn=8, seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    order = list(labels) + [labels[(r + i) % 3] for r in range(AB_ROUNDS) for i in range(3)]
    rows = {label: [] for label in labels}
    for i, label in enumerate(order):
        events = [torch.cuda.Event(enable_timing=True)]

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        with in_variant(label):
            t = time.perf_counter()
            events[0].record()
            state, metrics = step_fn(state, batch, gen, mark)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        if not np.isfinite(metrics["loss"].item()):
            raise AssertionError(f"[step-ab] {label}: loss {metrics['loss'].item()}")
        if i >= len(labels):  # past the warm-ups
            rows[label].append([ms] + [events[j].elapsed_time(events[j + 1])
                                       for j in range(len(STAGES))])
    for label, got in rows.items():
        med = np.median(np.array(got), axis=0)
        log(f"[step-ab] {label}: steps {', '.join(f'{r[0]:.2f}' for r in got)}; median "
            f"{med[0]:.2f} ms; median stages "
            f"{', '.join(f'{n} {v:.2f}' for n, v in zip(STAGES, med[1:]))} ({smi})")
    del step_fn, state, batch
    torch.cuda.empty_cache()
    toks = np.zeros((32, 77), np.int32)
    toks[:, 0], toks[:, 1], toks[:, 2] = SOT, 320 + np.arange(32), EOT
    with tempfile.TemporaryDirectory() as tmp, bpe_table(tmp), fused_clip(True), \
            patched(loop, deterministic_convolutions=contextlib.nullcontext):
        path = os.path.join(tmp, "tokens.npz")
        np.savez(path, tokens=toks)
        log("[step-ab] [trainer]'s depth-2 resume check without the cuDNN guard:")
        try:
            trainer_resume_check(tmp, path)
        except AssertionError as e:  # a finding of this measurement, not a failed check
            log(f"[step-ab] not bitwise without the guard: {e}")
    print(smi, flush=True)
    return 0


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU",
              file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--step-ab"]:
        return step_ab()
    if sys.argv[1:2] == ["--warp-against"] and len(sys.argv) == 3:
        return warp_against(sys.argv[2])
    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    vq_err = phase_vq(gen)
    mixer_err = phase_mixer(gen)
    errs = phase_mixer_train(gen)
    errs.update(phase_warp(gen))
    errs.update(phase_stream(gen))
    errs.update(phase_mlp_ln(gen))
    phase_c3(gen)
    times = phase_timing(gen, smi)
    phase_reference()
    phase_serve_reference()
    phase_train_reference()
    launches = phase_slice(smi)
    launches["mixer_stream"] = phase_serve(smi)
    train_launches, steps = phase_train(smi)
    module, fused = steps["module"], steps["fused"]
    log(f"[train] module tower against fused tower (K11), median ms: step {module['step']:.2f} / "
        f"{fused['step']:.2f}, image_tower {module['image_tower']:.2f} / "
        f"{fused['image_tower']:.2f}, backward {module['backward']:.2f} / "
        f"{fused['backward']:.2f} ({smi})")
    launches.update({k: v for k, v in train_launches.items() if not k.startswith("mlp_ln")})
    trainer = phase_trainer(smi)
    launches.update(mlp_ln=trainer["mlp_ln"], mlp_ln_bwd=trainer["mlp_ln_bwd"])
    phase_cutouts()
    crops, rect = phase_trainer_crops(smi)
    for name in ("warp_forward", "warp_adjoint"):
        launches[name] += crops[name]
        times[name]["rect"].update(launches=rect[name], max_abs_err=errs["rect"][name])
    mappers = phase_mappers(smi)
    prior = phase_prior(smi)
    phase_prior_train(smi)
    diversity = phase_diversity(smi)
    evals = phase_eval(smi)
    perceptors = phase_perceptors(smi)
    native_ckpt = phase_native_ckpt(smi)
    phase_encode(smi)
    for phase in (mappers, prior, diversity, evals, perceptors, native_ckpt):
        for name, n in phase.items():
            if not name.startswith("mlp_ln"):  # K11's row: [trainer]'s launches
                launches["vq" if name == "vq_argmin" else name] += n
    pallas = "feed_forward_vqgan_clip_tpu/ops/pallas/"
    csrc = "feed_forward_vqgan_clip_tpu_torch/csrc/"
    rows = [  # name, source, TPU kernel replaced, launches (the path's run), max abs err
        ("vq_argmin", "vq_lookup.cu", "vq_lookup.py:33", launches["vq"], vq_err),
        ("mixer_block", "mixer_block.cu", "mixer_block.py:225", launches["mixer_block"],
         mixer_err),
        ("mixer_stream", "mixer_stream_wgmma.cu", "mixer_block.py:530", launches["mixer_stream"],
         errs["mixer_stream"]),
        ("mixer_block_stacked", "mixer_block.cu", "mixer_block.py:614",
         launches["mixer_block_stacked"], errs["mixer_block_stacked"]),
        ("mixer_fwd_res", "mixer_block.cu", "mixer_block.py:726", launches["mixer_fwd_res"],
         errs["mixer_fwd_res"]),
        ("mixer_channel_bwd", "mixer_train.cu", "mixer_block.py:853",
         launches["mixer_channel_bwd"], errs["mixer_channel_bwd"]),
        ("mixer_token_bwd", "mixer_train.cu", "mixer_block.py:970",
         launches["mixer_token_bwd"], errs["mixer_token_bwd"]),
        ("warp_forward", "warp.cu", "warp_forward.py:96", launches["warp_forward"],
         errs["warp_forward"]),
        ("warp_adjoint", "warp.cu", "warp_adjoint.py:172", launches["warp_adjoint"],
         errs["warp_adjoint"]),
        ("mlp_ln", "mlp_ln.cu", "mlp_ln.py:59", launches["mlp_ln"], errs["mlp_ln"]),
        ("mlp_ln_bwd", "mlp_ln.cu", "mlp_ln.py:81", launches["mlp_ln_bwd"],
         errs["mlp_ln_bwd"]),
    ]
    # library_ms: the warps' rows carry grid_sample's forward and input-gradient
    # times from [time] (time_warp_pair), their "rect" rows too; no single PyTorch
    # call computes the other functions (K1 is a matmul and an argmin; K11's rows
    # carry the eager module sublayer's time as eager_ms instead). The warps'
    # launches are [train]'s, [trainer-crops]'s and [mappers]'; their "rect" rows,
    # the 256 -> 224 px warps of [trainer-crops]
    kernels = [{"name": name, "route": "cuda", "source": csrc + src, "replaces": pallas + tpu,
                "launches": n, "max_abs_err": err, **times[name],
                "library_ms": times[name].get("library_ms")}
               for name, src, tpu, n, err in rows]
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

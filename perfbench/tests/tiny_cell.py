"""A tiny configuration of each model family, for the CPU tests: the same
code paths as the cells (the port's module paths and the kernels' plain
versions on the CPU), at widths a test run can hold."""

import time

import torch

from perfbench.harness import cell as C

CLIP = {"image_size": 32, "patch_size": 8, "vision_width": 64, "vision_layers": 2,
        "vision_heads": 2, "embed_dim": 32, "text_width": 32, "text_layers": 2, "text_heads": 2,
        "vocab_size": 49408, "context_length": 77}
VQGAN = {"n_embed": 64, "embed_dim": 8, "z_channels": 8, "resolution": 16, "in_channels": 3,
         "out_ch": 3, "ch": 8, "ch_mult": [1, 2], "num_res_blocks": 1, "attn_resolutions": [8],
         "dropout": 0.0}
MAPPERS = {
    "mlp_mixer": {"model_type": "mlp_mixer", "dim": 16, "depth": 2, "vq_image_size": 8,
                  "expansion": 4, "noise_dim": 0},
    "vitgan": {"model_type": "vitgan", "dim": 16, "depth": 2, "vq_image_size": 8,
               "num_heads": 2, "noise_dim": 0},
}
MIXES = {
    "batch": {"generator": "batch", "batch": 8, "pool": 2, "token_ids": [300, 40000]},
    "train": {"generator": "train", "batch": 2, "cutn": 2, "lr": 0.001, "opt_dtype": "bfloat16",
              "pool": 4, "token_ids": [300, 40000]},
    "serve_closed": {"generator": "serve_closed", "clients": 1, "grid": "1x1", "requests": 64,
                     "corpora": ["MIT_states_train", "coco_birds", "made_of"],
                     "merge_table_seed": 0},
}
SAMPLE = {"batches": 2, "of_first_batches": 2, "rows": 8, "requests": 3, "of_first_requests": 4}
# limits for these widths: a sound tiny run reads about a third of each or less
LIMITS = {"text_err": 0.03, "mapper_err": 0.03, "vq_gap": 1e-3, "decode_err": 0.07,
          "link_err": 0.0, "out_err": 0.0, "grad_err": 0.2, "update_err": 0.5, "image_err": 0.07}


def config(model_type="mlp_mixer"):
    return {"name": "tiny", "compute_dtype": "bfloat16", "clip_model": "tiny", "clip": dict(CLIP),
            "mapper": dict(MAPPERS[model_type]), "vqgan": dict(VQGAN)}


def run(generator, model_type="mlp_mixer", seed=2**31 + 7, seconds=1.0, control=False):
    """(ctx, outcome) of a tiny cell run through traffic generator `generator` on the CPU."""
    mix = MIXES[generator]
    limits = {k: v for k, v in LIMITS.items()}
    cell = C.Cell(name="tiny", chips=1, config=config(model_type), mix=mix, limits=limits,
                  sample=dict(SAMPLE), end_to_end=[], per_layer=[])
    ctx = C.Ctx(cell=cell, seed=seed, seconds=seconds, trace=False, device=torch.device("cpu"),
                t_start=time.perf_counter(), control=control)
    module = C.load_module(C.BENCH / "traffic" / f"{mix['generator']}.py")
    return ctx, module.run(ctx)

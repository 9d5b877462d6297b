"""Checkpoint verification: probe a mapper checkpoint deterministically and diff
the probes against goldens.

The counterpart of feed_forward_vqgan_clip_tpu/verify_weights.py: the same
probes, `.npz` golden keys, comparison and JSON report (within `atol`; the
sha256 entries are informative). Goldens written on one device verify there;
across devices or packages they hold at float32 only: in bfloat16 (the default
of a file that names no compute_dtype) each device's roundings flip the VQ's
near ties, and the prompt's image moves by far more than `atol`.
`verify_weights` walks the released zoo (registry.MODEL_URLS) or the given
paths, loads each through the port's `infer.Generator` on `device`, and runs:

  text_embed      CLIP text embeddings of 2 fixed prompts             (2, clip_dim)
  fixed_z_thumb   VQGAN decode of JAX's uniform draw of PRNGKey(1234)
                  in [z_lo, z_hi] (ops/jax_random.py, bitwise JAX's)  32x32 thumb
  prompt_thumb    prompt -> image at seed 0, without the prior        32x32 thumb
  prior_sample    with the zoo's prior: the flow's reverse of JAX's normal
                  draw of PRNGKey(1234), and its render               (2, dim), thumb

Thumbnails are 32x32 bilinear resizes (ops/augment.resize_bilinear, equal to
jax.image.resize's antialiased bilinear); the sha256 of the full uint8 image
rides along. The first run (or `update_goldens`) writes the goldens; later
runs compare. Files not present are reported "absent". With noise_dim > 0 and
no noise bank longer than the batch, the prompt's noise rows come from torch's
generator, not JAX's, and those probes do not carry across packages.

    python -m feed_forward_vqgan_clip_tpu_torch.cli verify-weights --models m.th \\
        --goldens-dir goldens [--update-goldens] [--device cpu]
"""

import hashlib
import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from feed_forward_vqgan_clip_tpu_torch.registry import MODEL_URLS, PRIOR_MODELS

log = logging.getLogger(__name__)

PROMPTS = (
    "a photo of a sunset over the ocean",
    "an oil painting of a red fox in the snow",
)
THUMB = 32
Z_SEED = 1234


def _thumb(img) -> np.ndarray:
    from feed_forward_vqgan_clip_tpu_torch.ops.augment import resize_bilinear

    x = torch.as_tensor(np.asarray(img, np.float32))
    return resize_bilinear(x, THUMB).numpy().astype(np.float32)


def _sha(img: np.ndarray) -> str:
    u8 = np.clip(np.asarray(img, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return hashlib.sha256(u8.tobytes()).hexdigest()


@torch.no_grad()
def probe_model(model_path: str, prior_path: Optional[str] = None,
                device="cuda") -> Dict[str, np.ndarray]:
    """The probe set (module docstring) of one mapper checkpoint on `device`."""
    from feed_forward_vqgan_clip_tpu_torch.config import vqgan_arch_config
    from feed_forward_vqgan_clip_tpu_torch.infer import Generator
    from feed_forward_vqgan_clip_tpu_torch.models.vqgan import latent_bounds, synth
    from feed_forward_vqgan_clip_tpu_torch.ops import jax_random

    # prior-less: the prior has probes of its own, so the others do not depend
    # on whether it is there
    gen = Generator.from_checkpoint(model_path, device=device)
    out: Dict[str, np.ndarray] = {}
    h = gen.encode_prompts(list(PROMPTS))
    out["text_embed"] = h.float().cpu().numpy()

    # the codebook and decoder alone
    s = int(gen.cfg.get("vq_image_size") or 16)
    zc = int(vqgan_arch_config(gen.cfg)["z_channels"])
    z_lo, z_hi = latent_bounds(gen.vq)
    u = torch.from_numpy(jax_random.uniform(Z_SEED, (1, s, s, zc))).to(z_lo.device)
    img_z = synth(gen.vq, z_lo + u * (z_hi - z_lo)).float().cpu().numpy()
    out["fixed_z_thumb"] = _thumb(img_z)
    out["fixed_z_sha"] = np.asarray(_sha(img_z))

    imgs = gen.generate(h, seed=0).float().cpu().numpy()
    out["prompt_thumb"] = _thumb(imgs)
    out["prompt_sha"] = np.asarray(_sha(imgs))

    if prior_path:
        from feed_forward_vqgan_clip_tpu_torch.models.flow import load_prior_model

        prior = load_prior_model(prior_path, device=device)
        z = torch.from_numpy(jax_random.normal(Z_SEED, (len(h), prior.flow.in_channels)))
        hp = prior.reverse(z.to(h.device), h).float()
        out["prior_sample"] = hp.cpu().numpy()
        imgs_p = gen.generate(hp, seed=0).float().cpu().numpy()
        out["prior_thumb"] = _thumb(imgs_p)
        out["prior_sha"] = np.asarray(_sha(imgs_p))
    return out


def _compare(probes: Dict[str, np.ndarray], golden: Dict[str, np.ndarray], atol: float):
    result = {}
    ok = True
    for k, v in probes.items():
        if k not in golden:
            result[k] = {"status": "missing_golden"}
            ok = False
            continue
        g = golden[k]
        if v.dtype.kind == "U" or g.dtype.kind == "U":  # sha strings
            # a differing hash alone is informative, not fatal (another backend's rounding)
            result[k] = {"status": "match" if str(v) == str(g) else "hash_differs"}
            continue
        if v.shape != g.shape:
            result[k] = {"status": "shape_mismatch", "got": list(v.shape), "want": list(g.shape)}
            ok = False
            continue
        diff = float(np.max(np.abs(v - g)))
        good = diff <= atol
        result[k] = {"status": "match" if good else "mismatch", "max_abs_diff": diff}
        ok = ok and good
    return ok, result


def verify_weights(weights_dir: Optional[str] = None, *, goldens_dir: str = "goldens",
                   models: Optional[List[str]] = None, download: bool = False,
                   update_goldens: bool = False, atol: float = 2e-2,
                   out: str = "verify_weights_report.json", device="cuda"):
    """Probe every given (default: every released) mapper checkpoint found and
    diff against the goldens; -> the report, also written to `out` as JSON.
    Checkpoints not in `weights_dir` ($FFVC_WEIGHTS_DIR, else ./weights) are
    "absent", not failures."""
    weights_dir = weights_dir or os.environ.get("FFVC_WEIGHTS_DIR", "weights")
    if download:
        from feed_forward_vqgan_clip_tpu_torch.download_weights import download as fetch

        os.makedirs(weights_dir, exist_ok=True)
        for name, url in MODEL_URLS.items():
            try:
                fetch(url, os.path.join(weights_dir, name))
            except Exception as e:  # pragma: no cover - network
                log.warning("download failed for %s: %s", name, e)

    names = models or [n for n in MODEL_URLS if not n.startswith("prior_")]
    report: Dict[str, dict] = {}
    for name in names:
        path = name if os.path.exists(name) else os.path.join(weights_dir, name)
        base = os.path.basename(path.rstrip(os.sep))
        if not os.path.exists(path):
            report[base] = {"status": "absent", "path": path}
            continue
        prior_name = PRIOR_MODELS.get(base)
        prior_path = (os.path.join(weights_dir, prior_name)
                      if prior_name and os.path.exists(os.path.join(weights_dir, prior_name))
                      else None)
        try:
            probes = probe_model(path, prior_path=prior_path, device=device)
        except Exception as e:
            log.exception("probe failed for %s", base)
            report[base] = {"status": "error", "error": f"{type(e).__name__}: {e}"}
            continue
        gpath = os.path.join(goldens_dir, base + ".npz")
        if update_goldens or not os.path.exists(gpath):
            os.makedirs(goldens_dir, exist_ok=True)
            np.savez_compressed(gpath, **probes)
            report[base] = {"status": "golden_written", "golden": gpath}
            log.info("wrote golden %s", gpath)
        else:
            golden = dict(np.load(gpath, allow_pickle=False))
            ok, detail = _compare(probes, golden, atol)
            report[base] = {"status": "ok" if ok else "FAIL", "probes": detail}

    summary = {
        "ok": sum(1 for r in report.values() if r["status"] in ("ok", "golden_written")),
        "fail": sum(1 for r in report.values() if r["status"] in ("FAIL", "error")),
        "absent": sum(1 for r in report.values() if r["status"] == "absent"),
        "atol": atol,
    }
    full = {"summary": summary, "models": report}
    with open(out, "w") as fd:
        json.dump(full, fd, indent=2)
    for name, r in report.items():
        log.info("%-70s %s", name, r["status"])
    log.info("verify-weights: %d ok / %d fail / %d absent -> %s", summary["ok"],
             summary["fail"], summary["absent"], out)
    return full

"""Kernel dispatch for the CLIP ViT image encoder of the train loss.

Port of feed_forward_vqgan_clip_tpu/models/clip_fused.py:
`make_clip_image_apply(module)` returns `images -> embeddings` computing the same
function as `module.encode_image` (models/clip_vit.py), but with every
transformer block's MLP sublayer `ln_2 -> c_fc -> act -> c_proj` (+ residual)
through the sublayer kernel K11 (ops/kernels/mlp_ln.MlpLn) on the block's rows
(B*T, D). Patchify, class token, positions, ln_pre, the attention sublayers,
ln_post and the projection are the module's own submodules.

Off by default, as in the JAX package, where the fused tower measured slower
than the module path at the train shapes (its module docstring). Here K11's
sublayer beats the eager one (0.137 against 0.189 ms forward, 0.135 against
0.407 ms backward to x at 3200 x 768 x 3072 bf16, chip_smoke.py `[time]` on an
NVIDIA H100 80GB HBM3 at 700 W), but the flagship train step is host-bound:
the fused and module steps were level within the host's noise there (209.02
against 212.82 ms, medians of 3, `[train]`), so the default stays the JAX
package's.
FFVC_FUSED_CLIP=1 turns it on for CUDA tensors, FFVC_FUSED_CLIP=0 off whatever
the caller asks; `fused=True` runs it on any device (a CPU tensor then takes the
kernel's plain version). Shapes outside the JAX kernel's gate
(`mlp_ln_supported`) and towers other than CLIP's ViT take the module path, so
that both packages route the same shapes the same way.
"""

import os

from feed_forward_vqgan_clip_tpu_torch.models.clip_vit import CLIP
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.mlp_ln import MlpLn, mlp_ln_supported


def encode_image_fused(module: CLIP, x):
    """The image tower with K11 sublayers: x (B, H, W, 3) CLIP-normalised NHWC ->
    (B, embed_dim) float32, like `module.encode_image`; differentiable in x and
    in the tower's parameters (their grads only where they require grad)."""
    visual = module.visual
    h = visual.embed(x)
    b, t, d = h.shape
    for block in visual.transformer.resblocks:
        h = h + block.attn(block.ln_1(h))
        mlp = block.mlp
        h = MlpLn.apply(h.reshape(b * t, d), mlp.act, visual.dtype, block.ln_2.weight,
                        block.ln_2.bias, mlp.c_fc.weight, mlp.c_fc.bias, mlp.c_proj.weight,
                        mlp.c_proj.bias).reshape(b, t, d)
    return visual.head(h)


def clip_fused_supported(module, b: int, hh: int) -> bool:
    """The JAX dispatcher's gate: a CLIP ViT, and the sublayer's rows (b images of
    hh px) and widths inside `mlp_ln_supported`."""
    if not isinstance(module, CLIP):
        return False
    visual = module.visual
    t = (hh // visual.patch_size) ** 2 + 1
    return mlp_ln_supported(b * t, visual.width, visual.width * 4)


def make_clip_image_apply(module, *, fused=None):
    """images -> embeddings for the train loss, resolved once here as the JAX
    dispatcher resolves it: FFVC_FUSED_CLIP=0 (or false) off; =1 (or true) the
    fused tower for CUDA tensors; else `fused` (None: off)."""
    env = os.environ.get("FFVC_FUSED_CLIP", "")
    if env in ("0", "false"):
        route = "off"
    elif env in ("1", "true"):
        route = "cuda"
    else:
        route = "any" if fused else "off"

    def apply(x):
        on = route == "any" or (route == "cuda" and x.device.type == "cuda")
        if on and clip_fused_supported(module, x.shape[0], x.shape[1]):
            return encode_image_fused(module, x)
        return module.encode_image(x)

    return apply

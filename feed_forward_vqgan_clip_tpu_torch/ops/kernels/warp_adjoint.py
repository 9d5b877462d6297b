"""The exact image gradient of the warp on the card: the CUDA kernel K10 in
csrc/warp.cu.

Replaces feed_forward_vqgan_clip_tpu/ops/pallas/warp_adjoint.py (`_kernel`,
reached through `warp_adjoint`): grad[p] = sum_q w(s(q), p) g[q], the transpose
of the warp forward, computed as a gather over the output pixels q that can
reach each input pixel p. The input frame `in_hw` is g's size unless given
(the crops' gradients go back to the larger or smaller frame they were cut
from). It uses no float atomics, so two runs give bitwise-equal gradients, and
it covers every draw: there is no planner and no fallback. See the .cu file for
the design and what bounds it on an H100.
"""

import torch

from feed_forward_vqgan_clip_tpu_torch.ops.augment import inverse_coords
from feed_forward_vqgan_clip_tpu_torch.ops.kernels import build
from feed_forward_vqgan_clip_tpu_torch.ops.kernels.warp_forward import (
    _DTYPE_CODE,
    check_warp_args,
)


def warp_adjoint_plain(g, m, padding_mode, in_hw=None):
    """The transpose of `warp_perspective_inverse`'s 4-tap gather: g (B, Ho, Wo,
    C) -> the image gradient (B, H, W, C) in g's dtype, (H, W) = in_hw or (Ho,
    Wo). The same taps and weights as the forward, summed with `index_add_` in
    float32 (float64 for a float64 g) and rounded once."""
    b, ho, wo, c = g.shape
    h, w = (ho, wo) if in_hw is None else in_hw
    sx, sy = inverse_coords(m, ho, wo)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    acc = torch.promote_types(g.dtype, torch.float32)
    gf = g.to(acc)
    # grid_sample's out = top (1 - wy) + bot wy, top = v00 (1 - wx) + v01 wx, ...
    ct_top, ct_bot = gf * (1 - wy), gf * wy
    frame = (torch.arange(b, device=g.device) * (h * w))[:, None, None]
    grad = torch.zeros(b * h * w, c, dtype=acc, device=g.device)
    for xi, yi, ct in ((x0, y0, ct_top * (1 - wx)), (x0 + 1, y0, ct_top * wx),
                       (x0, y0 + 1, ct_bot * (1 - wx)), (x0 + 1, y0 + 1, ct_bot * wx)):
        if padding_mode == "zeros":
            inside = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1))[..., None]
            ct = torch.where(inside, ct, torch.zeros((), device=g.device))
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long() + frame
        grad.index_add_(0, idx.reshape(-1), ct.reshape(-1, c))
    return grad.reshape(b, h, w, c).to(g.dtype)


def warp_adjoint(g, m, padding_mode, in_hw=None):
    """g (B, Ho, Wo, C) f32 or bf16, the gradient of the warp's output, m (B, 3,
    3) f32 -> the gradient of its input image (B, H, W, C) in g's dtype, (H, W) =
    in_hw or (Ho, Wo).

    A CUDA tensor launches the kernel, whatever the frames; a CPU tensor runs the
    plain version. Each launch adds one to `warp_adjoint.launches`, and one to
    `warp_adjoint.rect_launches` where (H, W) != (Ho, Wo)."""
    if g.device.type == "cpu":
        return warp_adjoint_plain(g, m, padding_mode, in_hw)
    b, ho, wo, c = g.shape
    h, w = (ho, wo) if in_hw is None else (int(in_hw[0]), int(in_hw[1]))
    check_warp_args("warp_adjoint", g, m, padding_mode, (h, w))
    g, m = g.contiguous(), m.contiguous()
    grad = g.new_empty(b, h, w, c)
    if grad.numel() == 0:
        return grad
    lib = build.load_library()
    with torch.cuda.device(g.device):
        err = lib.ffvc_warp_adjoint(g.data_ptr(), m.data_ptr(), grad.data_ptr(), b, h, w, ho, wo,
                                    c, int(padding_mode == "border"), _DTYPE_CODE[g.dtype],
                                    build.stream_handle(g.device))
    build.check(err, "ffvc_warp_adjoint")
    warp_adjoint.launches += 1
    warp_adjoint.rect_launches += (h, w) != (ho, wo)
    return grad


warp_adjoint.launches = 0
warp_adjoint.rect_launches = 0  # the launches whose input frame is not g's

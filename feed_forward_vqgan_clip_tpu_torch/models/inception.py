"""InceptionV3 pool3 features for FID.

Port of feed_forward_vqgan_clip_tpu/models/inception.py: torchvision's
inception_v3 topology up to the 2048-d global average pool, each BasicConv2d a
convolution without bias, a frozen BatchNorm (eps 1e-3) and a ReLU. Attribute
names are torchvision's (`<block>.conv.weight`, `<block>.bn.{weight, bias,
running_mean, running_var}`); a file's `fc`, `AuxLogits` and
`num_batches_tracked` entries are dropped. Each BatchNorm is folded into its
convolution's weight and a bias once, in float32, when the weights are loaded
(`fold_`); the forward runs the folded convolutions in `dtype`. Images are
NHWC in [0, 1] at the entry, resized to 299 px with `jax.image.resize`'s
bilinear contraction (ops/augment.resize_bilinear) and scaled to [-1, 1], NCHW
inside; cuDNN convolutions and pools.
"""

import logging
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.ops.augment import resize_bilinear

log = logging.getLogger(__name__)

BN_EPS = 1e-3
SIZE = 299


class FrozenBatchNorm(nn.Module):
    """BatchNorm2d's parameters and running statistics, never updated; only
    BasicConv2d's fold reads them."""

    def __init__(self, features, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))


class BasicConv2d(nn.Module):
    def __init__(self, cin, cout, kernel, stride=1, padding=0, *, device=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False,
                              device=device)
        self.bn = FrozenBatchNorm(cout, device=device)
        self.register_buffer("w_fold", None, persistent=False)
        self.register_buffer("b_fold", None, persistent=False)

    @torch.no_grad()
    def fold_(self):
        inv = self.bn.weight / torch.sqrt(self.bn.running_var + BN_EPS)
        self.w_fold = self.conv.weight * inv[:, None, None, None]
        self.b_fold = self.bn.bias - self.bn.running_mean * inv

    def forward(self, x):
        return F.relu(F.conv2d(x, self.w_fold.to(x.dtype), self.b_fold.to(x.dtype),
                               stride=self.conv.stride, padding=self.conv.padding))


def _avgpool3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1)


def _maxpool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features, device=None):
        super().__init__()
        kw = dict(device=device)
        self.branch1x1 = BasicConv2d(cin, 64, 1, **kw)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1, **kw)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2, **kw)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, **kw)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1, **kw)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1, **kw)
        self.branch_pool = BasicConv2d(cin, pool_features, 1, **kw)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, bd, self.branch_pool(_avgpool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin, device=None):
        super().__init__()
        kw = dict(device=device)
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2, **kw)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1, **kw)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1, **kw)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2, **kw)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxpool3s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin, c7, device=None):
        super().__init__()
        kw = dict(device=device)
        row, col = dict(padding=(0, 3), **kw), dict(padding=(3, 0), **kw)
        self.branch1x1 = BasicConv2d(cin, 192, 1, **kw)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1, **kw)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), **row)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), **col)
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1, **kw)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), **col)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), **row)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), **col)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), **row)
        self.branch_pool = BasicConv2d(cin, 192, 1, **kw)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                      self.branch7x7dbl_5):
            bd = layer(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avgpool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin, device=None):
        super().__init__()
        kw = dict(device=device)
        self.branch3x3_1 = BasicConv2d(cin, 192, 1, **kw)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2, **kw)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1, **kw)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3), **kw)
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0), **kw)
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2, **kw)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, _maxpool3s2(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin, device=None):
        super().__init__()
        kw = dict(device=device)
        row, col = dict(padding=(0, 1), **kw), dict(padding=(1, 0), **kw)
        self.branch1x1 = BasicConv2d(cin, 320, 1, **kw)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1, **kw)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), **row)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), **col)
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1, **kw)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1, **kw)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), **row)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), **col)
        self.branch_pool = BasicConv2d(cin, 192, 1, **kw)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avgpool3(x))], 1)


class InceptionV3Features(nn.Module):
    """x (B, H, W, 3) in [0, 1] -> (B, 2048) float32 pool3 features."""

    def __init__(self, *, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2, **kw)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, **kw)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1, **kw)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, **kw)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, **kw)
        self.Mixed_5b = InceptionA(192, 32, **kw)
        self.Mixed_5c = InceptionA(256, 64, **kw)
        self.Mixed_5d = InceptionA(288, 64, **kw)
        self.Mixed_6a = InceptionB(288, **kw)
        self.Mixed_6b = InceptionC(768, 128, **kw)
        self.Mixed_6c = InceptionC(768, 160, **kw)
        self.Mixed_6d = InceptionC(768, 160, **kw)
        self.Mixed_6e = InceptionC(768, 192, **kw)
        self.Mixed_7a = InceptionD(768, **kw)
        self.Mixed_7b = InceptionE(1280, **kw)
        self.Mixed_7c = InceptionE(2048, **kw)

    def fold_(self):
        """Fold every BatchNorm into its convolution (after a change of weights)."""
        for m in self.modules():
            if isinstance(m, BasicConv2d):
                m.fold_()
        return self

    def load_state_dict(self, state_dict, strict=True, assign=False):
        out = super().load_state_dict(state_dict, strict=strict, assign=assign)
        self.fold_()
        return out

    def forward(self, x):
        x = resize_bilinear(x.float(), SIZE)
        h = (x * 2.0 - 1.0).permute(0, 3, 1, 2).to(self.dtype)
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(h)))
        h = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_maxpool3s2(h)))
        h = _maxpool3s2(h)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            h = getattr(self, name)(h)
        return h.float().mean(dim=(2, 3))

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """The JAX module's init: lecun-normal kernels (N(0, 1/fan_in)), BatchNorm at
        scale 1, bias 0, mean 0, variance 1; then folded."""
        for m in self.modules():
            if isinstance(m, BasicConv2d):
                w = m.conv.weight
                w.copy_(torch.randn(w.shape, generator=generator, device=generator.device)
                        * w[0].numel() ** -0.5)
        return self.fold_()


def make_inception_fn(weights_path: Optional[str] = None, *, dtype=torch.bfloat16,
                      device="cuda", seed: int = 0) -> InceptionV3Features:
    """The frozen feature extractor, a callable images (B, H, W, 3) in [0, 1] ->
    (B, 2048) float32: torchvision / FID-port weights from `weights_path` (fc,
    AuxLogits and num_batches_tracked dropped), else random from `seed` with the
    JAX package's warning (FID values then meaningless)."""
    model = InceptionV3Features(dtype=dtype, device=device)
    if weights_path:
        obj = torch.load(weights_path, map_location="cpu", weights_only=False)
        if "state_dict" in obj and isinstance(obj["state_dict"], dict):
            obj = obj["state_dict"]
        keys = set(model.state_dict())
        model.load_state_dict({k: v.float() for k, v in obj.items() if k in keys})
    else:
        log.warning("No InceptionV3 weights — random init; FID values are meaningless "
                    "(pass weights_path with torchvision/FID-port weights).")
        model.init_random_(torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)

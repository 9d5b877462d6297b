"""InceptionResNetV2 feature trunk: the backbone of pyiqa's stock `nima` metric.

Port of feed_forward_vqgan_clip_tpu/models/inception_resnet.py, in the
Cadene / timm module layout and key names, so pyiqa's NIMA file loads with
`load_state_dict` once its prefix and head are taken off (models/nima.py):
stem conv2d_1a .. conv2d_4a with two 3x3 stride-2 max pools; mixed_5b; 10 x
block35 (scale 0.17) under `repeat`; mixed_6a; 20 x block17 (0.10) under
`repeat_1`; mixed_7a; 9 x block8 (0.20) under `repeat_2`; a last `block8`
(scale 1, no ReLU); conv2d_7b; global average pool -> 1536 features. Branches
of several layers are nn.Sequential (`branch1.0`, `branch1.1`, ...); the
residual blocks' up-projection is a biased 1x1 `conv2d`. Each BasicConv2d is
models/inception.py's: a convolution without bias and a frozen BatchNorm (eps
1e-3) folded into it once when the weights are loaded. mixed_5b's pool is
torch's AvgPool2d(3, 1, 1, count_include_pad=False), which the JAX module
emulates. Input NHWC, already normalised; NCHW inside; cuDNN convolutions.
"""

import torch
import torch.nn.functional as F
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.models.inception import BasicConv2d, _maxpool3s2

FEATURES = 1536


def _up(conv, x):
    """A residual block's biased 1x1 projection in the input's dtype."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))


def _seq(*convs):
    return nn.Sequential(*(BasicConv2d(*c[:3], **c[3]) if len(c) > 3 else BasicConv2d(*c)
                           for c in convs))


class Mixed5b(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(192, 96, 1)
        self.branch1 = _seq((192, 48, 1), (48, 64, 5, dict(padding=2)))
        self.branch2 = _seq((192, 64, 1), (64, 96, 3, dict(padding=1)),
                            (96, 96, 3, dict(padding=1)))
        self.branch3 = nn.Sequential(nn.AvgPool2d(3, stride=1, padding=1,
                                                  count_include_pad=False),
                                     BasicConv2d(192, 64, 1))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), self.branch3(x)],
                         1)


class Block35(nn.Module):
    def __init__(self, scale=0.17):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(320, 32, 1)
        self.branch1 = _seq((320, 32, 1), (32, 32, 3, dict(padding=1)))
        self.branch2 = _seq((320, 32, 1), (32, 48, 3, dict(padding=1)),
                            (48, 64, 3, dict(padding=1)))
        self.conv2d = nn.Conv2d(128, 320, 1)

    def forward(self, x):
        h = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], 1)
        return F.relu(x + self.scale * _up(self.conv2d, h))


class Mixed6a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(320, 384, 3, stride=2)
        self.branch1 = _seq((320, 256, 1), (256, 256, 3, dict(padding=1)),
                            (256, 384, 3, dict(stride=2)))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), _maxpool3s2(x)], 1)


class Block17(nn.Module):
    def __init__(self, scale=0.10):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(1088, 192, 1)
        self.branch1 = _seq((1088, 128, 1), (128, 160, (1, 7), dict(padding=(0, 3))),
                            (160, 192, (7, 1), dict(padding=(3, 0))))
        self.conv2d = nn.Conv2d(384, 1088, 1)

    def forward(self, x):
        up = _up(self.conv2d, torch.cat([self.branch0(x), self.branch1(x)], 1))
        return F.relu(x + self.scale * up)


class Mixed7a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = _seq((1088, 256, 1), (256, 384, 3, dict(stride=2)))
        self.branch1 = _seq((1088, 256, 1), (256, 288, 3, dict(stride=2)))
        self.branch2 = _seq((1088, 256, 1), (256, 288, 3, dict(padding=1)),
                            (288, 320, 3, dict(stride=2)))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), _maxpool3s2(x)],
                         1)


class Block8(nn.Module):
    def __init__(self, scale=0.20, no_relu=False):
        super().__init__()
        self.scale, self.no_relu = scale, no_relu
        self.branch0 = BasicConv2d(2080, 192, 1)
        self.branch1 = _seq((2080, 192, 1), (192, 224, (1, 3), dict(padding=(0, 1))),
                            (224, 256, (3, 1), dict(padding=(1, 0))))
        self.conv2d = nn.Conv2d(448, 2080, 1)

    def forward(self, x):
        up = _up(self.conv2d, torch.cat([self.branch0(x), self.branch1(x)], 1))
        out = x + self.scale * up
        return out if self.no_relu else F.relu(out)


class InceptionResNetV2Features(nn.Module):
    """x (B, H, W, 3), normalised -> (B, 1536) float32 global-average-pooled
    features. No resize: the trunk is fully convolutional."""

    def __init__(self, *, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv2d_1a = BasicConv2d(3, 32, 3, stride=2)
        self.conv2d_2a = BasicConv2d(32, 32, 3)
        self.conv2d_2b = BasicConv2d(32, 64, 3, padding=1)
        self.conv2d_3b = BasicConv2d(64, 80, 1)
        self.conv2d_4a = BasicConv2d(80, 192, 3)
        self.mixed_5b = Mixed5b()
        self.repeat = nn.Sequential(*(Block35() for _ in range(10)))
        self.mixed_6a = Mixed6a()
        self.repeat_1 = nn.Sequential(*(Block17() for _ in range(20)))
        self.mixed_7a = Mixed7a()
        self.repeat_2 = nn.Sequential(*(Block8() for _ in range(9)))
        self.block8 = Block8(scale=1.0, no_relu=True)
        self.conv2d_7b = BasicConv2d(2080, FEATURES, 1)
        if device is not None:
            self.to(device)

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
        dt = self.dtype
        h = x.permute(0, 3, 1, 2).to(dt)
        h = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(h)))
        h = self.conv2d_4a(self.conv2d_3b(_maxpool3s2(h)))
        h = self.mixed_5b(_maxpool3s2(h))
        h = self.mixed_6a(self.repeat(h))
        h = self.mixed_7a(self.repeat_1(h))
        h = self.conv2d_7b(self.block8(self.repeat_2(h)))
        return h.float().mean(dim=(2, 3))

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """The JAX module's init: lecun-normal kernels (N(0, 1/fan_in)), zero conv
        biases, BatchNorm at scale 1, bias 0, mean 0, variance 1; then folded."""
        for m in self.modules():
            w = m.conv.weight if isinstance(m, BasicConv2d) else (
                m.weight if isinstance(m, nn.Conv2d) and m.bias is not None else None)
            if w is not None:
                w.copy_(torch.randn(w.shape, generator=generator, device=generator.device)
                        * w[0].numel() ** -0.5)
            if isinstance(m, nn.Conv2d) and m.bias is not None:
                m.bias.zero_()
        return self.fold_()

"""VGG16 conv features for the diversity loss.

Port of feed_forward_vqgan_clip_tpu/models/vgg.py: the reference's diversity
term runs `lpips.net(x)`, the raw VGG16 feature slices relu1_2, relu2_2,
relu3_3, relu4_3 and relu5_3 (not the LPIPS distance). Attribute names are
torchvision's `features.N` (the ReLUs and max pools hold no parameters);
`load_vgg16` also reads taming-LPIPS files (`net.sliceK.N` / `sliceK.N`, which
keep torchvision's layer indices N), as the JAX package's `convert_vgg16` does.
NCHW inside, cuDNN convolutions; float32 parameters, the forward in `dtype`.
"""

import logging
import os
from typing import Optional

import torch
from torch import nn

log = logging.getLogger(__name__)

# torchvision vgg16.features conv indices, grouped by LPIPS slice
VGG16_SLICES = (
    (0, 2),  # -> relu1_2
    (5, 7),  # -> relu2_2
    (10, 12, 14),  # -> relu3_3
    (17, 19, 21),  # -> relu4_3
    (24, 26, 28),  # -> relu5_3
)
VGG16_CHANNELS = {
    0: 64, 2: 64, 5: 128, 7: 128, 10: 256, 12: 256, 14: 256,
    17: 512, 19: 512, 21: 512, 24: 512, 26: 512, 28: 512,
}


class VGG16Features(nn.Module):
    def __init__(self, *, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        layers, cin = [], 3
        for i in range(max(VGG16_CHANNELS) + 2):  # torchvision's indices through relu5_3
            if i in VGG16_CHANNELS:
                layers.append(nn.Conv2d(cin, VGG16_CHANNELS[i], 3, padding=1, device=device))
                cin = VGG16_CHANNELS[i]
            elif i - 1 in VGG16_CHANNELS:
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2))
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        """x (B, H, W, 3) -> the 5 slices' feature maps, NCHW in `dtype`."""
        h = x.permute(0, 3, 1, 2).to(self.dtype)
        outs, start = [], 0
        for conv_ids in VGG16_SLICES:
            end = conv_ids[-1] + 2  # through the slice's last ReLU
            with torch.autocast(h.device.type, dtype=self.dtype,
                                enabled=self.dtype != torch.float32):
                h = self.features[start:end](h)
            outs.append(h)
            start = end
        return outs

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """The JAX module's init: lecun-normal kernels (N(0, 1/fan_in)), zero biases."""
        for i in VGG16_CHANNELS:
            conv = self.features[i]
            w = torch.randn(conv.weight.shape, generator=generator, device=generator.device)
            conv.weight.copy_(w * conv.weight[0].numel() ** -0.5)
            conv.bias.zero_()
        return self


def vgg16_state_dict(sd: dict) -> dict:
    """A torchvision vgg16 (`features.N.*`) or taming-LPIPS (`net.sliceK.N.*`,
    `sliceK.N.*`) state dict -> VGG16Features' (`features.N.*`), float32; other
    entries (classifier, LPIPS heads) dropped."""
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        nums = [p for p in parts if p.isdigit()]
        if nums and parts[-1] in ("weight", "bias") and int(nums[-1]) in VGG16_CHANNELS:
            out[f"features.{int(nums[-1])}.{parts[-1]}"] = v.float()
    missing = sorted({f"features.{i}.{p}" for i in VGG16_CHANNELS for p in ("weight", "bias")}
                     - set(out))
    if missing:
        raise KeyError(f"VGG16 conv layers missing from state dict: {missing}")
    return out


def load_vgg16(path: Optional[str] = None, *, dtype=torch.float32, device="cuda",
               seed: int = 1) -> VGG16Features:
    """The frozen VGG16 features: the torch file at `path` when it exists, else
    random from `seed` with the JAX package's warning; no grad, eval mode."""
    vgg = VGG16Features(dtype=dtype, device=device)
    if path and os.path.isdir(path):
        # the JAX package reads VGG16 weights from a torch file only, too
        raise NotImplementedError(f"{path} is a directory; VGG16 weights are read from a "
                                  "torch file")
    if path and os.path.exists(path):
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if "state_dict" in obj and isinstance(obj["state_dict"], dict):
            obj = obj["state_dict"]
        vgg.load_state_dict(vgg16_state_dict(obj))
    else:
        log.warning("No VGG16 weights — random init (diversity loss untrained).")
        vgg.init_random_(torch.Generator(device=device).manual_seed(seed))
    return vgg.eval().requires_grad_(False)

"""NIMA (Neural IMage Assessment): the webdataset encoder's quality filter.

Port of feed_forward_vqgan_clip_tpu/models/nima.py. A feature trunk, a
float32 10-way head, a softmax, and the mean opinion score sum_i i * p_i over
the bins 1..10, against which the encoder gates samples. Two trunks:

  * "inception_resnet_v2", pyiqa's stock `nima` backbone
    (models/inception_resnet.py), normalised with mean = std = 0.5;
  * "inception_v3", the FID trunk (models/inception.py, which resizes to
    299 px and scales to [-1, 1] itself), normalised with ImageNet's mean and
    std first.

Input is [0, 1] RGB NHWC; the normalisation happens inside, as pyiqa's does
(the encoder de-normalises its CLIP batches before scoring). A checkpoint is
read in torch key space as the JAX package's `convert_nima` reads it
(`convert_nima` here): the prefixes `module.`, `base_model.`, `backbone.`,
`features.`, `model.` stripped; `AuxLogits.*` dropped; the head matched by
name (a `classifier`, `head`, `fc` or `last_linear` segment) first, else the
one (10, F) matrix by shape; more than one candidate raises; the trunk told
apart by its stem's key (`conv2d_1a.` for IRv2, else InceptionV3).
"""

import logging
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from feed_forward_vqgan_clip_tpu_torch.models.inception import InceptionV3Features
from feed_forward_vqgan_clip_tpu_torch.models.inception_resnet import InceptionResNetV2Features

log = logging.getLogger(__name__)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INCEPTION_MEAN = (0.5, 0.5, 0.5)
INCEPTION_STD = (0.5, 0.5, 0.5)
TRUNKS = {  # backbone -> (trunk, features, mean, std)
    "inception_resnet_v2": (InceptionResNetV2Features, 1536, INCEPTION_MEAN, INCEPTION_STD),
    "inception_v3": (InceptionV3Features, 2048, IMAGENET_MEAN, IMAGENET_STD),
}
PREFIXES = ("module.", "base_model.", "backbone.", "features.", "model.")
HEAD_NAMES = ("classifier", "head", "fc", "last_linear")


class NIMA(nn.Module):
    """x (B, H, W, 3) in [0, 1] -> (B,) float32 mean opinion score."""

    def __init__(self, backbone: str = "inception_resnet_v2", *, dtype=torch.float32,
                 device=None):
        super().__init__()
        if backbone not in TRUNKS:
            raise ValueError(f"unknown NIMA backbone {backbone!r}")
        trunk, features, mean, std = TRUNKS[backbone]
        self.backbone_name = backbone
        self.backbone = trunk(dtype=dtype, device=device)
        self.classifier = nn.Linear(features, 10, device=device)
        self.register_buffer("mean", torch.tensor(mean, device=device), persistent=False)
        self.register_buffer("std", torch.tensor(std, device=device), persistent=False)
        self.register_buffer("bins", torch.arange(1, 11, dtype=torch.float32, device=device),
                             persistent=False)

    def load_state_dict(self, state_dict, strict=True, assign=False):
        out = super().load_state_dict(state_dict, strict=strict, assign=assign)
        self.backbone.fold_()
        return out

    def forward(self, x):
        h = (x.float() - self.mean) / self.std
        feats = self.backbone(h)
        p = torch.softmax(F.linear(feats.float(), self.classifier.weight, self.classifier.bias),
                          dim=-1)
        return (p * self.bins).sum(-1)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """The trunk's init, then a lecun-normal head with a zero bias."""
        self.backbone.init_random_(generator)
        w = self.classifier.weight
        w.copy_(torch.randn(w.shape, generator=generator, device=generator.device)
                * w.shape[1] ** -0.5)
        self.classifier.bias.zero_()
        return self


def _strip(key: str) -> str:
    for prefix in PREFIXES:
        if key.startswith(prefix):
            key = key[len(prefix):]
    return key


def detect_nima_backbone(sd) -> str:
    """The trunk of a torch NIMA state dict from its stem's key names."""
    for k in sd:
        base = _strip(k)
        if base.startswith("conv2d_1a."):
            return "inception_resnet_v2"
        if base.startswith("Conv2d_1a_3x3."):
            return "inception_v3"
    return "inception_resnet_v2"


def convert_nima(sd: Dict[str, torch.Tensor]) -> Tuple[str, Dict[str, torch.Tensor]]:
    """A torch NIMA state dict -> (backbone, this module's state dict): the trunk's
    entries under `backbone.` (those the trunk has), the head as `classifier`."""
    trunk: Dict[str, torch.Tensor] = {}
    heads: Dict[str, torch.Tensor] = {}  # path without .weight -> (10, F) weight
    biases: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        base = _strip(k)
        if base.startswith("AuxLogits."):  # the train-time aux head
            continue
        if v.ndim == 2 and v.shape[0] == 10 and base.endswith(".weight"):
            heads[base[: -len(".weight")]] = v
        elif v.ndim == 1 and tuple(v.shape) == (10,) and base.endswith(".bias"):
            biases[base[: -len(".bias")]] = v
        else:
            trunk[base] = v
    named = {p: w for p, w in heads.items()
             if any(s in HEAD_NAMES for s in p.lower().split("."))}
    pick = named or heads
    if len(pick) > 1:
        raise KeyError(f"ambiguous NIMA head candidates {sorted(pick)}; expected exactly one "
                       "10-way classifier (name it classifier/head/fc, or drop the extras)")
    if not pick:
        raise KeyError("no 10-way NIMA head (weight (10, F) + bias (10,)) in state dict")
    ((head, weight),) = pick.items()
    bias = biases.pop(head, None)
    if bias is None:
        raise KeyError(f"no bias matching NIMA head '{head}'")
    trunk.update({f"{p}.bias": b for p, b in biases.items()})
    backbone = ("inception_resnet_v2" if any(k.startswith("conv2d_1a.") for k in trunk)
                else "inception_v3")
    out = {f"backbone.{k}": v.float() for k, v in trunk.items()}
    out.update({"classifier.weight": weight.float(), "classifier.bias": bias.float()})
    return backbone, out


def make_nima_fn(weights_path: Optional[str] = None, *, dtype=torch.float32, device="cuda",
                 backbone: Optional[str] = None, seed: int = 0) -> NIMA:
    """The frozen scorer, images (B, H, W, 3) in [0, 1] -> (B,) MOS: the torch file
    at `weights_path` (its trunk detected), else random from `seed`."""
    if weights_path:
        obj = torch.load(weights_path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
            obj = obj["state_dict"]
        found, sd = convert_nima(obj)
        model = NIMA(backbone or found, dtype=dtype, device=device)
        keys = set(model.state_dict())
        model.load_state_dict({k: v for k, v in sd.items() if k in keys})
    else:
        model = NIMA(backbone or "inception_resnet_v2", dtype=dtype, device=device)
        model.init_random_(torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)

"""VGG feature stacks (NHWC in public): the five stage outputs.

Counterpart of the JAX package's `models/backbones/vgg.py` (torchvision
``vgg16().features`` / ``vgg19().features``, taps after relu1_2 … relu5_3).
Convs are named ``conv0 …`` in order with HWIO kernels, as the flax tree
names them, and run through `device.conv2d` (full fp32 on the card).
`convert_vgg16_state` / `convert_vgg19_state` read torchvision's weights;
``bn=True`` is torchvision's ``vgg*_bn`` layout (conv, batch norm ``bn{i}``,
ReLU), and `make_vgg` builds any `VGG_FAMILIES` name with its converter.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.image import max_pool2d
from .common import BatchNorm, Conv2d, bn_from_torch, conv_w, put

N_CHANNELS = (64, 128, 256, 512, 512)
_STAGES = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))
_STAGES19 = ((64, 64), (128, 128), (256,) * 4, (512,) * 4, (512,) * 4)
_STAGES11 = ((64,), (128,), (256, 256), (512, 512), (512, 512))
_STAGES13 = ((64, 64), (128, 128), (256, 256), (512, 512), (512, 512))


class VGGFeatures(nn.Module):
    """NHWC input → the list of 5 feature maps at the end of each conv
    stage; a 2×2 max pool opens every stage but the first. With ``bn``
    each conv (which keeps its bias, as in torchvision) is followed by a
    batch norm in inference mode."""

    def __init__(self, stages: Sequence[Sequence[int]] = _STAGES, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None, bn: bool = False):
        super().__init__()
        self.stages, self.bn = tuple(tuple(s) for s in stages), bn
        idx = 0
        for widths in self.stages:
            for width in widths:
                self.add_module(f"conv{idx}", Conv2d(in_channels, width, 3, 1, 1,
                                                     generator=generator))
                if bn:
                    self.add_module(f"bn{idx}", BatchNorm(width))
                in_channels, idx = width, idx + 1

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats, idx = [], 0
        for stage_i, widths in enumerate(self.stages):
            if stage_i > 0:
                x = max_pool2d(x, 2, 2)
            for _ in widths:
                x = getattr(self, f"conv{idx}")(x)
                if self.bn:
                    x = getattr(self, f"bn{idx}")(x)
                x = F.relu(x)
                idx += 1
            feats.append(x)
        return feats


def VGG16Features(**kw) -> VGGFeatures:
    return VGGFeatures(stages=_STAGES, **kw)


def VGG19Features(**kw) -> VGGFeatures:
    return VGGFeatures(stages=_STAGES19, **kw)


def _convert_vgg_state(state: Mapping, stages, bn: bool = False) -> dict:
    """torchvision vggN state dict (``features.N.*``) → ``{"params": tree}``
    (and ``"batch_stats"`` with ``bn``): the convs sit at consecutive
    ``features`` indices, each followed by its batch norm (``bn``) and its
    ReLU, with a max pool between stages."""
    params: dict = {}
    stats: dict = {}
    ours = theirs = 0
    for stage_i, widths in enumerate(stages):
        if stage_i > 0:
            theirs += 1  # the MaxPool2d entry
        for _ in widths:
            put(params, f"conv{ours}/kernel", conv_w(state[f"features.{theirs}.weight"]))
            put(params, f"conv{ours}/bias", state[f"features.{theirs}.bias"])
            if bn:
                bn_from_torch(params, stats, f"bn{ours}", state, f"features.{theirs + 1}")
            ours, theirs = ours + 1, theirs + (3 if bn else 2)  # Conv2d [+ BatchNorm2d] + ReLU
    return {"params": params, "batch_stats": stats} if bn else {"params": params}


def convert_vgg16_state(state: Mapping) -> dict:
    """torchvision vgg16 state dict (``features.N.*``) → params."""
    return _convert_vgg_state(state, _STAGES)


def convert_vgg19_state(state: Mapping) -> dict:
    """torchvision vgg19 state dict (``features.N.*``) → params."""
    return _convert_vgg_state(state, _STAGES19)


# name → (stage widths, batch norm) for the torchvision families the
# projected discriminator's registry slices.
VGG_FAMILIES = {
    "vgg11_bn": (_STAGES11, True),
    "vgg13_bn": (_STAGES13, True),
    "vgg16": (_STAGES, False),
    "vgg16_bn": (_STAGES, True),
    "vgg19": (_STAGES19, False),
    "vgg19_bn": (_STAGES19, True),
}


def make_vgg(name: str):
    """``'vggNN[_bn]'`` → (5-stage module factory, converter)."""
    stages, bn = VGG_FAMILIES[name]

    def make(**kw) -> VGGFeatures:
        return VGGFeatures(stages=stages, bn=bn, **kw)

    def convert(state: Mapping) -> dict:
        return _convert_vgg_state(state, stages, bn=bn)

    return make, convert

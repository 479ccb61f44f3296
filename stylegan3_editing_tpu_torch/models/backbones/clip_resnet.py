"""CLIP's ModifiedResNet-50 visual trunk (NHWC in public) for the projected discriminator.

Counterpart of the JAX package's `models/backbones/clip_resnet.py`: OpenAI
CLIP RN50's ``visual`` tower as the reference's ``_make_resnet_clip``
slices it: stage 0 is the stem and ``layer1`` (/4, 256 channels), stages
1–3 are ``layer2/3/4`` (512, 1024, 2048 at /8, /16, /32). Unlike
torchvision's ResNet, the stem is three 3×3 convs and a 2×2 average pool,
and striding is anti-aliased: every conv runs at stride 1, a 2×2 average
pool follows ``conv2`` and another comes before the downsample projection.
The attention-pool head is not part of the stages.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.image import avg_pool2d
from .common import BatchNorm, Conv2d, bn_from_torch, conv_w, put

_RN50_LAYERS = (3, 4, 6, 3)
_WIDTH = 64


class CLIPBottleneck(nn.Module):
    """CLIP's bottleneck: 1×1 → 3×3 → [2×2 average pool] → 1×1 (×4), BN and
    ReLU; the input, or an average pool, 1×1 conv and BN of it, is added."""

    def __init__(self, in_channels: int, planes: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        out_c = planes * 4
        self.stride = stride
        self.conv1 = Conv2d(in_channels, planes, 1, generator=generator, use_bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, generator=generator, use_bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, out_c, 1, generator=generator, use_bias=False)
        self.bn3 = BatchNorm(out_c)
        self.downsample = stride > 1 or in_channels != out_c
        if self.downsample:
            self.down_conv = Conv2d(in_channels, out_c, 1, generator=generator, use_bias=False)
            self.down_bn = BatchNorm(out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        if self.stride > 1:
            y = avg_pool2d(y, self.stride, self.stride)
        y = self.bn3(self.conv3(y))
        identity = x
        if self.downsample:
            if self.stride > 1:
                identity = avg_pool2d(identity, self.stride, self.stride)
            identity = self.down_bn(self.down_conv(identity))
        return F.relu(y + identity)


class CLIPResNet50Stages(nn.Module):
    """NHWC input → 4 feature maps (/4 256 channels, /8 512, /16 1024, /32 2048)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = 3
        for i, width in enumerate((_WIDTH // 2, _WIDTH // 2, _WIDTH), start=1):
            self.add_module(f"stem_conv{i}", Conv2d(c, width, 3, 2 if i == 1 else 1, 1,
                                                    generator=generator, use_bias=False))
            self.add_module(f"stem_bn{i}", BatchNorm(width))
            c = width
        self.stages = []
        for li, n in enumerate(_RN50_LAYERS, start=1):
            planes, names = _WIDTH * 2 ** (li - 1), []
            for bi in range(n):
                name = f"layer{li}_{bi}"
                self.add_module(name, CLIPBottleneck(c, planes, 2 if bi == 0 and li > 1 else 1,
                                                     generator))
                names.append(name)
                c = planes * 4
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"stem_bn{i}")(getattr(self, f"stem_conv{i}")(x)))
        x = avg_pool2d(x, 2, 2)
        outs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return outs


def convert_clip_resnet_state(state: Mapping[str, np.ndarray]) -> dict:
    """CLIP RN50 state dict (``visual.``-prefixed or bare) → ``{'params',
    'batch_stats'}``."""
    state = {(k[len("visual."):] if k.startswith("visual.") else k): v for k, v in state.items()}
    params: Dict = {}
    stats: Dict = {}
    for i in (1, 2, 3):
        put(params, f"stem_conv{i}/kernel", conv_w(state[f"conv{i}.weight"]))
        bn_from_torch(params, stats, f"stem_bn{i}", state, f"bn{i}")
    for li, n in enumerate(_RN50_LAYERS, start=1):
        for bi in range(n):
            src, dst = f"layer{li}.{bi}", f"layer{li}_{bi}"
            for ci in (1, 2, 3):
                put(params, f"{dst}/conv{ci}/kernel", conv_w(state[f"{src}.conv{ci}.weight"]))
                bn_from_torch(params, stats, f"{dst}/bn{ci}", state, f"{src}.bn{ci}")
            if f"{src}.downsample.0.weight" in state:
                put(params, f"{dst}/down_conv/kernel",
                    conv_w(state[f"{src}.downsample.0.weight"]))
                bn_from_torch(params, stats, f"{dst}/down_bn", state, f"{src}.downsample.1")
    return {"params": params, "batch_stats": stats}

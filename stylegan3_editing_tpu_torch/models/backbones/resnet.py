"""ResNet-34 body (NHWC in public) for the ReStyle ResNet encoder trunks.

Counterpart of the ResNet-34 part of the JAX package's
`models/backbones/resnet.py` (torchvision ``resnet34`` layer1–4, as
restyle_psp_encoders.ResNetBackboneEncoder uses it): `BasicBlock`,
`ResNet34Body` and the converter from torchvision's ``layerN.M.*`` naming.
Parameter and buffer names follow the flax tree (``layer2_0.down_conv.kernel``,
``layer2_0.bn1.mean``). The ResNet-50 features and the bottleneck stages go
with the MoCo loss (ROADMAP Queue 1 #7).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm, Conv2d, bn_from_torch, conv_w, put

RESNET34_LAYERS = ((3, 64), (4, 128), (6, 256), (3, 512))


class BasicBlock(nn.Module):
    """3×3 conv (stride) → BN → ReLU → 3×3 conv → BN, plus the input, or a
    strided 1×1 conv and BN of it (``downsample``); then ReLU."""

    def __init__(self, in_channels: int, channels: int, stride: int, downsample: bool,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv2d(in_channels, channels, 3, stride, 1, generator=generator,
                            use_bias=False)
        self.bn1 = BatchNorm(channels)
        self.conv2 = Conv2d(channels, channels, 3, 1, 1, generator=generator, use_bias=False)
        self.bn2 = BatchNorm(channels)
        self.downsample = downsample
        if downsample:
            self.down_conv = Conv2d(in_channels, channels, 1, stride, generator=generator,
                                    use_bias=False)
            self.down_bn = BatchNorm(channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train=train))
        y = self.bn2(self.conv2(y), train=train)
        identity = self.down_bn(self.down_conv(x), train=train) if self.downsample else x
        return F.relu(y + identity)


class ResNet34Body(nn.Module):
    """torchvision resnet34's layer1–4 (no stem): blocks ``layer{stage}_{block}``.
    Stride 2 and the downsample fall on the first block of stages 2–4."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.names = []
        in_channels = 64
        for stage_i, (blocks, channels) in enumerate(RESNET34_LAYERS, start=1):
            for block_i in range(blocks):
                first = block_i == 0 and stage_i > 1
                name = f"layer{stage_i}_{block_i}"
                self.add_module(name, BasicBlock(in_channels, channels, 2 if first else 1,
                                                 first, generator))
                self.names.append(name)
                in_channels = channels

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x, train=train)
        return x


def convert_resnet34_body_state(state: Mapping[str, np.ndarray]) -> dict:
    """torchvision resnet34 state dict (``layerN.M.*``) → ``{'params',
    'batch_stats'}`` named as `ResNet34Body`."""
    params: dict = {}
    stats: dict = {}
    for stage_i, (blocks, _) in enumerate(RESNET34_LAYERS, start=1):
        for block_i in range(blocks):
            t, o = f"layer{stage_i}.{block_i}", f"layer{stage_i}_{block_i}"
            for ci in (1, 2):
                put(params, f"{o}/conv{ci}/kernel", conv_w(state[f"{t}.conv{ci}.weight"]))
                bn_from_torch(params, stats, f"{o}/bn{ci}", state, f"{t}.bn{ci}")
            if f"{t}.downsample.0.weight" in state:
                put(params, f"{o}/down_conv/kernel", conv_w(state[f"{t}.downsample.0.weight"]))
                bn_from_torch(params, stats, f"{o}/down_bn", state, f"{t}.downsample.1")
    return {"params": params, "batch_stats": stats}

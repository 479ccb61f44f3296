"""ResNet bodies (NHWC in public): ResNet-34 for the ReStyle ResNet encoder
trunks, ResNet-50 for the pose and attribute scorers and the MoCo loss.

Counterpart of two parts of the JAX package's `models/backbones/resnet.py`:
torchvision ``resnet34`` layer1–4 (as restyle_psp_encoders.ResNetBackboneEncoder
uses it: `BasicBlock`, `ResNet34Body` and the converter from torchvision's
``layerN.M.*`` naming) and torchvision ``resnet50`` without its fc head
(`Bottleneck`, `ResNet50Features`: the plain bottleneck only, with its
converter `convert_resnet50_state` for the MoCo loss). Parameter and
buffer names follow the flax tree (``layer2_0.down_conv.kernel``,
``layer2_0.bn1.mean``). The bottleneck's ``se`` and ``avg_down`` variants
and the staged feature contracts go with the backbone registry (ROADMAP
Queue 1 #9).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.image import max_pool2d
from .common import BatchNorm, Conv2d, bn_from_torch, conv_w, put

RESNET34_LAYERS = ((3, 64), (4, 128), (6, 256), (3, 512))
# Per stage: (blocks, bottleneck width, out channels, stride).
RESNET50_STAGES = ((3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2), (3, 512, 2048, 2))


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


class Bottleneck(nn.Module):
    """1×1 conv → BN → ReLU → 3×3 conv (stride) → BN → ReLU → 1×1 conv → BN,
    plus the input, or a strided 1×1 conv and BN of it (``downsample``);
    then ReLU (torchvision's bottleneck, stride on the 3×3)."""

    def __init__(self, in_channels: int, width: int, out_channels: int, stride: int,
                 downsample: bool, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv2d(in_channels, width, 1, generator=generator, use_bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = Conv2d(width, width, 3, stride, 1, generator=generator, use_bias=False)
        self.bn2 = BatchNorm(width)
        self.conv3 = Conv2d(width, out_channels, 1, generator=generator, use_bias=False)
        self.bn3 = BatchNorm(out_channels)
        self.downsample = downsample
        if downsample:
            self.down_conv = Conv2d(in_channels, out_channels, 1, stride, generator=generator,
                                    use_bias=False)
            self.down_bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train=train))
        y = F.relu(self.bn2(self.conv2(y), train=train))
        y = self.bn3(self.conv3(y), train=train)
        identity = self.down_bn(self.down_conv(x), train=train) if self.downsample else x
        return F.relu(y + identity)


class ResNet50Features(nn.Module):
    """torchvision resnet50 without its fc head: NHWC input → ``[N, 2048]``
    globally average-pooled features. The stem is a 7×7 stride-2 conv, BN,
    ReLU and a 3×3 stride-2 max pool padded by 1; blocks ``layer{stage}_{block}``."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, generator=generator, use_bias=False)
        self.bn1 = BatchNorm(64)
        self.names = []
        in_channels = 64
        for stage_i, (blocks, width, out_c, stride) in enumerate(RESNET50_STAGES, start=1):
            for block_i in range(blocks):
                name = f"layer{stage_i}_{block_i}"
                self.add_module(name, Bottleneck(in_channels, width, out_c,
                                                 stride if block_i == 0 else 1, block_i == 0,
                                                 generator))
                self.names.append(name)
                in_channels = out_c

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x), train=train))
        x = max_pool2d(x, 3, 2, padding=1)
        for name in self.names:
            x = getattr(self, name)(x, train=train)
        return x.mean(dim=(1, 2))


def convert_bottleneck_stages_state(state: Mapping[str, np.ndarray],
                                    stages=RESNET50_STAGES) -> dict:
    """torchvision bottleneck-ResNet state dict (the plain stem ``conv1``,
    ``bn1``; ``layerN.M.*``) → ``{'params', 'batch_stats'}`` named as
    `ResNet50Features`. timm's SE and ``avg_down`` layouts go with the
    backbone registry."""
    params: dict = {}
    stats: dict = {}
    put(params, "conv1/kernel", conv_w(state["conv1.weight"]))
    bn_from_torch(params, stats, "bn1", state, "bn1")
    for stage_i, (blocks, _, _, _) in enumerate(stages, start=1):
        for block_i in range(blocks):
            t, o = f"layer{stage_i}.{block_i}", f"layer{stage_i}_{block_i}"
            for ci in (1, 2, 3):
                put(params, f"{o}/conv{ci}/kernel", conv_w(state[f"{t}.conv{ci}.weight"]))
                bn_from_torch(params, stats, f"{o}/bn{ci}", state, f"{t}.bn{ci}")
            if f"{t}.downsample.0.weight" in state:
                put(params, f"{o}/down_conv/kernel", conv_w(state[f"{t}.downsample.0.weight"]))
                bn_from_torch(params, stats, f"{o}/down_bn", state, f"{t}.downsample.1")
    return {"params": params, "batch_stats": stats}


def convert_resnet50_state(state: Mapping[str, np.ndarray]) -> dict:
    """torchvision resnet50 state dict (or a MoCo one with its
    ``module.encoder_q.`` prefix stripped) → ``{'params', 'batch_stats'}``."""
    return convert_bottleneck_stages_state(state, RESNET50_STAGES)

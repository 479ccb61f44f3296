"""ResNet bodies (NHWC in public): ResNet-34 for the ReStyle ResNet encoder
trunks, ResNet-50 for the pose and attribute scorers and the MoCo loss, and
the 4-stage feature contracts of the backbone registry.

Counterpart of the JAX package's `models/backbones/resnet.py`: torchvision
``resnet34`` layer1–4 (as restyle_psp_encoders.ResNetBackboneEncoder uses
it: `BasicBlock`, `ResNet34Body` and the converter from torchvision's
``layerN.M.*`` naming), torchvision ``resnet50`` without its fc head
(`Bottleneck`, `ResNet50Features`), and the staged extractors the
projected discriminator slices (/4, /8, /16, /32): `ResNetBasicStages`
(ResNet-18/34 with their stem) and `ResNetBottleneckStages` (the
`BOTTLENECK_STAGES` depths and widths, timm's SE blocks, and the ``-d``
variants' deep stem and average-pool downsample). Parameter and buffer
names follow the flax tree (``layer2_0.down_conv.kernel``,
``layer2_0.bn1.mean``), so the converters fit every family.
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.image import avg_pool2d, max_pool2d
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


def _convert_body_blocks(state: Mapping[str, np.ndarray], layers) -> dict:
    params: dict = {}
    stats: dict = {}
    for stage_i, (blocks, _) in enumerate(layers, start=1):
        for block_i in range(blocks):
            t, o = f"layer{stage_i}.{block_i}", f"layer{stage_i}_{block_i}"
            for ci in (1, 2):
                put(params, f"{o}/conv{ci}/kernel", conv_w(state[f"{t}.conv{ci}.weight"]))
                bn_from_torch(params, stats, f"{o}/bn{ci}", state, f"{t}.bn{ci}")
            if f"{t}.downsample.0.weight" in state:
                put(params, f"{o}/down_conv/kernel", conv_w(state[f"{t}.downsample.0.weight"]))
                bn_from_torch(params, stats, f"{o}/down_bn", state, f"{t}.downsample.1")
    return {"params": params, "batch_stats": stats}


def convert_resnet34_body_state(state: Mapping[str, np.ndarray]) -> dict:
    """torchvision resnet34 state dict (``layerN.M.*``) → ``{'params',
    'batch_stats'}`` named as `ResNet34Body`."""
    return _convert_body_blocks(state, RESNET34_LAYERS)


class Bottleneck(nn.Module):
    """1×1 conv → BN → ReLU → 3×3 conv (stride) → BN → ReLU → 1×1 conv → BN,
    plus the input, or a strided 1×1 conv and BN of it (``downsample``);
    then ReLU (torchvision's bottleneck, stride on the 3×3). ``se``: timm's
    squeeze-excite (reduction 16) gates the branch before the add;
    ``avg_down``: the ``-d`` variants' downsample, a 2×2 average pool of
    the stride, then a 1×1 conv of stride 1."""

    def __init__(self, in_channels: int, width: int, out_channels: int, stride: int,
                 downsample: bool, generator: Optional[torch.Generator] = None,
                 se: bool = False, avg_down: bool = False):
        super().__init__()
        self.stride, self.se, self.avg_down = stride, se, avg_down
        self.conv1 = Conv2d(in_channels, width, 1, generator=generator, use_bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = Conv2d(width, width, 3, stride, 1, generator=generator, use_bias=False)
        self.bn2 = BatchNorm(width)
        self.conv3 = Conv2d(width, out_channels, 1, generator=generator, use_bias=False)
        self.bn3 = BatchNorm(out_channels)
        if se:
            self.se_fc1 = Conv2d(out_channels, out_channels // 16, 1, generator=generator)
            self.se_fc2 = Conv2d(out_channels // 16, out_channels, 1, generator=generator)
        self.downsample = downsample
        if downsample:
            self.down_conv = Conv2d(in_channels, out_channels, 1, 1 if avg_down else stride,
                                    generator=generator, use_bias=False)
            self.down_bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train=train))
        y = F.relu(self.bn2(self.conv2(y), train=train))
        y = self.bn3(self.conv3(y), train=train)
        if self.se:
            s = F.relu(self.se_fc1(y.mean(dim=(1, 2), keepdim=True)))
            y = y * torch.sigmoid(self.se_fc2(s))
        identity = x
        if self.downsample:
            if self.avg_down and self.stride > 1:
                identity = avg_pool2d(identity, 2, self.stride)
            identity = self.down_bn(self.down_conv(identity), train=train)
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
                                    stages=RESNET50_STAGES, se: bool = False) -> dict:
    """torchvision/timm bottleneck-ResNet state dict → ``{'params',
    'batch_stats'}`` for any `BOTTLENECK_STAGES` family: the plain stem
    (``conv1``, ``bn1``) or timm's deep one (``conv1.{0,3,6}`` with its
    batch norms at ``conv1.{1,4}`` and ``bn1``), ``layerN.M.*``, timm's SE
    convs under ``layerN.M.se.fc{1,2}`` (``se``), and the downsample at
    ``downsample.{0,1}`` or, after the ``-d`` variants' average pool, at
    ``downsample.{1,2}``."""
    params: dict = {}
    stats: dict = {}
    if "conv1.0.weight" in state:  # the deep stem (timm resnet26d/50d)
        for i, src in enumerate((0, 3)):
            put(params, f"conv1_{i}/kernel", conv_w(state[f"conv1.{src}.weight"]))
            bn_from_torch(params, stats, f"bn1_{i}", state, f"conv1.{src + 1}")
        put(params, "conv1_2/kernel", conv_w(state["conv1.6.weight"]))
    else:
        put(params, "conv1/kernel", conv_w(state["conv1.weight"]))
    bn_from_torch(params, stats, "bn1", state, "bn1")
    for stage_i, (blocks, _, _, _) in enumerate(stages, start=1):
        for block_i in range(blocks):
            t, o = f"layer{stage_i}.{block_i}", f"layer{stage_i}_{block_i}"
            for ci in (1, 2, 3):
                put(params, f"{o}/conv{ci}/kernel", conv_w(state[f"{t}.conv{ci}.weight"]))
                bn_from_torch(params, stats, f"{o}/bn{ci}", state, f"{t}.bn{ci}")
            if se:
                for fc in (1, 2):
                    put(params, f"{o}/se_fc{fc}/kernel", conv_w(state[f"{t}.se.fc{fc}.weight"]))
                    put(params, f"{o}/se_fc{fc}/bias", state[f"{t}.se.fc{fc}.bias"])
            for conv, bn in ((0, 1), (1, 2)):  # plain, then the avg_down layout
                if f"{t}.downsample.{conv}.weight" in state:
                    put(params, f"{o}/down_conv/kernel",
                        conv_w(state[f"{t}.downsample.{conv}.weight"]))
                    bn_from_torch(params, stats, f"{o}/down_bn", state, f"{t}.downsample.{bn}")
                    break
    return {"params": params, "batch_stats": stats}


def convert_resnet50_state(state: Mapping[str, np.ndarray]) -> dict:
    """torchvision resnet50 state dict (or a MoCo one with its
    ``module.encoder_q.`` prefix stripped) → ``{'params', 'batch_stats'}``."""
    return convert_bottleneck_stages_state(state, RESNET50_STAGES)


# Per-stage (blocks, bottleneck width, out channels, stride). The depth
# variants share torchvision's bottleneck; wide_* doubles the 3×3 width.
BOTTLENECK_STAGES = {
    "resnet50": RESNET50_STAGES,
    "resnet101": ((3, 64, 256, 1), (4, 128, 512, 2), (23, 256, 1024, 2), (3, 512, 2048, 2)),
    "resnet152": ((3, 64, 256, 1), (8, 128, 512, 2), (36, 256, 1024, 2), (3, 512, 2048, 2)),
    "wide_resnet50_2": ((3, 128, 256, 1), (4, 256, 512, 2), (6, 512, 1024, 2),
                        (3, 1024, 2048, 2)),
    "wide_resnet101_2": ((3, 128, 256, 1), (4, 256, 512, 2), (23, 512, 1024, 2),
                         (3, 1024, 2048, 2)),
    "seresnet50": RESNET50_STAGES,
    "resnet26": ((2, 64, 256, 1), (2, 128, 512, 2), (2, 256, 1024, 2), (2, 512, 2048, 2)),
}


class ResNetBottleneckStages(nn.Module):
    """A bottleneck ResNet sliced into the 4-stage feature contract (/4, /8,
    /16, /32; out channels 256·(1, 2, 4, 8)): the stem (a 7×7 stride-2
    conv, or with ``deep_stem`` timm's 3×3 triplet of 32, 32, 64 channels),
    BN, ReLU, a 3×3 stride-2 max pool padded by 1, then each stage's
    output. Named as `ResNet50Features`, so the converters fit."""

    def __init__(self, stages=RESNET50_STAGES, se: bool = False, deep_stem: bool = False,
                 avg_down: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.deep_stem = deep_stem
        if deep_stem:
            in_c = 3
            for i, w in enumerate((32, 32, 64)):
                self.add_module(f"conv1_{i}", Conv2d(in_c, w, 3, 2 if i == 0 else 1, 1,
                                                     generator=generator, use_bias=False))
                if i < 2:
                    self.add_module(f"bn1_{i}", BatchNorm(w))
                in_c = w
        else:
            self.conv1 = Conv2d(3, 64, 7, 2, 3, generator=generator, use_bias=False)
        self.bn1 = BatchNorm(64)
        self.stages = []
        in_channels = 64
        for stage_i, (blocks, width, out_c, stride) in enumerate(stages, start=1):
            names = []
            for block_i in range(blocks):
                name = f"layer{stage_i}_{block_i}"
                self.add_module(name, Bottleneck(in_channels, width, out_c,
                                                 stride if block_i == 0 else 1, block_i == 0,
                                                 generator, se=se, avg_down=avg_down))
                names.append(name)
                in_channels = out_c
            self.stages.append(names)

    def forward(self, x: torch.Tensor, train: bool = False) -> List[torch.Tensor]:
        if self.deep_stem:
            for i in range(3):
                x = getattr(self, f"conv1_{i}")(x)
                if i < 2:
                    x = F.relu(getattr(self, f"bn1_{i}")(x, train=train))
        else:
            x = self.conv1(x)
        x = max_pool2d(F.relu(self.bn1(x, train=train)), 3, 2, padding=1)
        outs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x, train=train)
            outs.append(x)
        return outs


def ResNet50Stages(**kw) -> ResNetBottleneckStages:
    return ResNetBottleneckStages(stages=RESNET50_STAGES, **kw)


RESNET18_LAYERS = ((2, 64), (2, 128), (2, 256), (2, 512))


class ResNetBasicStages(nn.Module):
    """torchvision resnet18/34 with its stem, sliced into 4 stages (/4 64,
    /8 128, /16 256, /32 512 channels); ``layers`` selects the depth."""

    def __init__(self, layers=RESNET34_LAYERS, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, generator=generator, use_bias=False)
        self.bn1 = BatchNorm(64)
        self.stages = []
        in_channels = 64
        for stage_i, (blocks, channels) in enumerate(layers, start=1):
            names = []
            for block_i in range(blocks):
                first = block_i == 0 and stage_i > 1
                name = f"layer{stage_i}_{block_i}"
                self.add_module(name, BasicBlock(in_channels, channels, 2 if first else 1,
                                                 first, generator))
                names.append(name)
                in_channels = channels
            self.stages.append(names)

    def forward(self, x: torch.Tensor, train: bool = False) -> List[torch.Tensor]:
        x = max_pool2d(F.relu(self.bn1(self.conv1(x), train=train)), 3, 2, padding=1)
        outs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x, train=train)
            outs.append(x)
        return outs


def ResNet34Stages(**kw) -> ResNetBasicStages:
    return ResNetBasicStages(layers=RESNET34_LAYERS, **kw)


def ResNet18Stages(**kw) -> ResNetBasicStages:
    return ResNetBasicStages(layers=RESNET18_LAYERS, **kw)


def _convert_basic_stages_state(state: Mapping[str, np.ndarray], layers) -> dict:
    """torchvision resnet18/34 state dict (with the stem) → ``{'params',
    'batch_stats'}`` named as `ResNetBasicStages`."""
    params: dict = {}
    stats: dict = {}
    put(params, "conv1/kernel", conv_w(state["conv1.weight"]))
    bn_from_torch(params, stats, "bn1", state, "bn1")
    body = _convert_body_blocks(state, layers)
    for coll, tree in (("params", params), ("batch_stats", stats)):
        tree.update(body[coll])
    return {"params": params, "batch_stats": stats}


def convert_resnet34_state(state: Mapping[str, np.ndarray]) -> dict:
    """torchvision resnet34 state dict (with the stem) → `ResNet34Stages`' variables."""
    return _convert_basic_stages_state(state, RESNET34_LAYERS)


def convert_resnet18_state(state: Mapping[str, np.ndarray]) -> dict:
    """torchvision resnet18 state dict (with the stem) → `ResNet18Stages`' variables."""
    return _convert_basic_stages_state(state, RESNET18_LAYERS)

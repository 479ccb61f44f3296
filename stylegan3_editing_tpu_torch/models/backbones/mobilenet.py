"""MobileNetV2 and MNASNet feature stages (NHWC in public) for the projected discriminator.

Counterpart of the JAX package's `models/backbones/mobilenet.py`:
torchvision ``mobilenet_v2`` split as the reference's ``_feature_splitter``
splits it at feature indices [4, 7, 14, 18] (24, 32, 96, 320 channels at
/4, /8, /16, /32), and ``mnasnet0_5`` / ``mnasnet1_0`` split at layer
indices [9, 10, 12, 14]. ReLU6 is ``min(relu(x), 6)``; the depthwise convs
go through `Conv2d(groups=…)`. Both converters read torchvision's state
dicts.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm, Conv2d, bn_from_torch, conv_w, put


def _relu6(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(F.relu(v), max=6.0)


# torchvision mobilenet_v2 features[1:18]: (expansion t, out, stride).
MBV2_BLOCKS = (
    (1, 16, 1),
    (6, 24, 2), (6, 24, 1),
    (6, 32, 2), (6, 32, 1), (6, 32, 1),
    (6, 64, 2), (6, 64, 1), (6, 64, 1), (6, 64, 1),
    (6, 96, 1), (6, 96, 1), (6, 96, 1),
    (6, 160, 2), (6, 160, 1), (6, 160, 1),
    (6, 320, 1),
)
# The split indices [4, 7, 14, 18] → the last block of each stage.
_MBV2_STAGE_ENDS = (3, 6, 13, 17)


class MBV2Block(nn.Module):
    """torchvision ``InvertedResidual``: [1×1 expansion →] depthwise 3×3 →
    1×1 projection, BN after each, ReLU6 after the first two; the input is
    added where the stride is 1 and the width stays."""

    def __init__(self, in_channels: int, expand: int, out: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.expand, self.residual = expand, stride == 1 and in_channels == out
        mid = in_channels * expand
        if expand != 1:
            self.conv_pw = Conv2d(in_channels, mid, 1, generator=generator, use_bias=False)
            self.bn1 = BatchNorm(mid)
        self.conv_dw = Conv2d(mid, mid, 3, stride, 1, generator=generator, use_bias=False,
                              groups=mid)
        self.bn2 = BatchNorm(mid)
        self.conv_pwl = Conv2d(mid, out, 1, generator=generator, use_bias=False)
        self.bn3 = BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _relu6(self.bn1(self.conv_pw(x))) if self.expand != 1 else x
        y = _relu6(self.bn2(self.conv_dw(y)))
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.residual else y


class MobileNetV2Stages(nn.Module):
    """NHWC input → 4 feature maps (/4 24 channels, /8 32, /16 96, /32 320)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_stem = Conv2d(3, 32, 3, 2, 1, generator=generator, use_bias=False)
        self.bn_stem = BatchNorm(32)
        c = 32
        for bi, (t, out, s) in enumerate(MBV2_BLOCKS, start=1):
            self.add_module(f"block{bi}", MBV2Block(c, t, out, s, generator))
            c = out

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = _relu6(self.bn_stem(self.conv_stem(x)))
        outs = []
        for bi in range(1, len(MBV2_BLOCKS) + 1):
            x = getattr(self, f"block{bi}")(x)
            if bi in _MBV2_STAGE_ENDS:
                outs.append(x)
        return outs


def convert_mobilenet_v2_state(state: Mapping[str, np.ndarray]) -> dict:
    """torchvision mobilenet_v2 state dict → ``{'params', 'batch_stats'}``."""
    params: Dict = {}
    stats: Dict = {}
    put(params, "conv_stem/kernel", conv_w(state["features.0.0.weight"]))
    bn_from_torch(params, stats, "bn_stem", state, "features.0.1")
    for bi, (t, _, _) in enumerate(MBV2_BLOCKS, start=1):
        src, dst = f"features.{bi}.conv", f"block{bi}"
        if t == 1:  # a depthwise ConvBNReLU, the projection conv, its BN
            layers = (("conv_dw", "bn2", "0.0", "0.1"), ("conv_pwl", "bn3", "1", "2"))
        else:
            layers = (("conv_pw", "bn1", "0.0", "0.1"), ("conv_dw", "bn2", "1.0", "1.1"),
                      ("conv_pwl", "bn3", "2", "3"))
        for conv, bn, tconv, tbn in layers:
            put(params, f"{dst}/{conv}/kernel", conv_w(state[f"{src}.{tconv}.weight"]))
            bn_from_torch(params, stats, f"{dst}/{bn}", state, f"{src}.{tbn}")
    return {"params": params, "batch_stats": stats}


# ------------------------------------------------------------------ MNASNet

def _round8(val: float) -> int:
    """torchvision mnasnet's ``_round_to_multiple_of(val, 8)``."""
    new_val = max(8, int(val + 4) // 8 * 8)
    if new_val < 0.9 * val:
        new_val += 8
    return new_val


# torchvision mnasnet layers[8:14] at α = 1: (kernel, stride, expansion, out, repeats).
MNASNET_STACKS = (
    (3, 2, 3, 24, 3),
    (5, 2, 3, 40, 3),
    (5, 2, 6, 80, 3),
    (3, 1, 6, 96, 2),
    (5, 2, 6, 192, 4),
    (3, 1, 6, 320, 1),
)
# The split indices [9, 10, 12, 14] → the last stack of each stage.
_MNAS_STAGE_ENDS = (0, 1, 3, 5)


def mnasnet_channels(alpha: float):
    """(the stem's two widths, each stack's out channels) of torchvision's
    ``mnasnet(alpha)``."""
    stem = (_round8(32 * alpha), _round8(16 * alpha))
    outs = tuple(_round8(c * alpha) for (_, _, _, c, _) in MNASNET_STACKS)
    return stem, outs


class MnasBlock(nn.Module):
    """torchvision mnasnet ``_InvertedResidual``: 1×1 expansion → depthwise
    k×k → 1×1 projection, BN after each, ReLU after the first two; the input
    is added where the stride is 1 and the width stays."""

    def __init__(self, in_channels: int, out: int, kernel: int, stride: int, expand: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mid = in_channels * expand
        self.residual = stride == 1 and in_channels == out
        self.conv_pw = Conv2d(in_channels, mid, 1, generator=generator, use_bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv_dw = Conv2d(mid, mid, kernel, stride, kernel // 2, generator=generator,
                              use_bias=False, groups=mid)
        self.bn2 = BatchNorm(mid)
        self.conv_pwl = Conv2d(mid, out, 1, generator=generator, use_bias=False)
        self.bn3 = BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv_pw(x)))
        y = F.relu(self.bn2(self.conv_dw(y)))
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.residual else y


class MNASNetStages(nn.Module):
    """torchvision mnasnet (``alpha`` 0.5 or 1.0) split at layers [9, 10, 12,
    14]: the stem (a 3×3 stride-2 conv, then a depthwise-separable pair)
    and stack 0, stack 1, stacks 2–3, stacks 4–5."""

    def __init__(self, alpha: float = 1.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        (c_stem, c_sep), outs = mnasnet_channels(alpha)
        self.conv_stem = Conv2d(3, c_stem, 3, 2, 1, generator=generator, use_bias=False)
        self.bn_stem = BatchNorm(c_stem)
        self.conv_sep_dw = Conv2d(c_stem, c_stem, 3, 1, 1, generator=generator, use_bias=False,
                                  groups=c_stem)
        self.bn_sep_dw = BatchNorm(c_stem)
        self.conv_sep_pw = Conv2d(c_stem, c_sep, 1, generator=generator, use_bias=False)
        self.bn_sep_pw = BatchNorm(c_sep)
        self.stacks = []
        c = c_sep
        for si, ((k, s, t, _, n), out) in enumerate(zip(MNASNET_STACKS, outs)):
            names = []
            for bi in range(n):
                name = f"stack{si}_{bi}"
                self.add_module(name, MnasBlock(c, out, k, s if bi == 0 else 1, t, generator))
                names.append(name)
                c = out
            self.stacks.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn_stem(self.conv_stem(x)))
        x = F.relu(self.bn_sep_dw(self.conv_sep_dw(x)))
        x = self.bn_sep_pw(self.conv_sep_pw(x))
        feats = []
        for si, names in enumerate(self.stacks):
            for name in names:
                x = getattr(self, name)(x)
            if si in _MNAS_STAGE_ENDS:
                feats.append(x)
        return feats


def convert_mnasnet_state(state: Mapping[str, np.ndarray]) -> dict:
    """torchvision mnasnet state dict (``layers.N…``) → ``{'params',
    'batch_stats'}``, for either width (the widths are the state's)."""
    params: Dict = {}
    stats: Dict = {}
    for conv, bn, tconv, tbn in (("conv_stem", "bn_stem", 0, 1),
                                 ("conv_sep_dw", "bn_sep_dw", 3, 4),
                                 ("conv_sep_pw", "bn_sep_pw", 6, 7)):
        put(params, f"{conv}/kernel", conv_w(state[f"layers.{tconv}.weight"]))
        bn_from_torch(params, stats, bn, state, f"layers.{tbn}")
    for si, (_, _, _, _, n) in enumerate(MNASNET_STACKS):
        for bi in range(n):
            src, dst = f"layers.{8 + si}.{bi}.layers", f"stack{si}_{bi}"
            for conv, bn, tconv, tbn in (("conv_pw", "bn1", 0, 1), ("conv_dw", "bn2", 3, 4),
                                         ("conv_pwl", "bn3", 6, 7)):
                put(params, f"{dst}/{conv}/kernel", conv_w(state[f"{src}.{tconv}.weight"]))
                bn_from_torch(params, stats, f"{dst}/{bn}", state, f"{src}.{tbn}")
    return {"params": params, "batch_stats": stats}

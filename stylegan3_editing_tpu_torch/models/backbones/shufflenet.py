"""ShuffleNetV2-x0.5 feature stages (NHWC in public) for the projected discriminator.

Counterpart of the JAX package's `models/backbones/shufflenet.py`:
torchvision ``shufflenet_v2_x0_5`` as the reference's ``_make_shufflenet``
slices it: stage 0 is ``conv1`` and the max pool (/4, 24 channels), stages
1–3 are ``stage2/3/4`` (48, 96, 192 at /8, /16, /32). The depthwise convs
go through `Conv2d(groups=…)`.

The channel shuffle is the JAX package's on NHWC: ``[…, C]`` →
``[…, 2, C/2]``, the last two axes swapped, back to ``[…, C]``; output
channel ``2i + g`` is input channel ``g·C/2 + i``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.image import max_pool2d
from .common import BatchNorm, Conv2d, bn_from_torch, conv_w, put

# x0.5: per stage (repeats, out channels).
SHUFFLENET_V2_X0_5 = ((4, 48), (8, 96), (4, 192))
_STEM = 24


def _shuffle(x: torch.Tensor) -> torch.Tensor:
    """Channel shuffle with two groups (torchvision's ``channel_shuffle``), NHWC."""
    n, h, w, c = x.shape
    return x.reshape(n, h, w, 2, c // 2).transpose(-1, -2).reshape(n, h, w, c)


class ShuffleBlock(nn.Module):
    """torchvision ShuffleNetV2 ``InvertedResidual``: at stride 1 the input's
    second half runs ``branch2`` (1×1, depthwise 3×3, 1×1) beside its first
    half; at stride 2 the whole input runs ``branch1`` (depthwise 3×3, 1×1)
    and ``branch2``. Then the shuffle."""

    def __init__(self, in_channels: int, out: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        half = out // 2
        b2_in = in_channels if stride > 1 else in_channels // 2
        if stride > 1:
            self.b1_dw = Conv2d(in_channels, in_channels, 3, stride, 1, generator=generator,
                                use_bias=False, groups=in_channels)
            self.b1_bn1 = BatchNorm(in_channels)
            self.b1_pw = Conv2d(in_channels, half, 1, generator=generator, use_bias=False)
            self.b1_bn2 = BatchNorm(half)
        self.b2_pw1 = Conv2d(b2_in, half, 1, generator=generator, use_bias=False)
        self.b2_bn1 = BatchNorm(half)
        self.b2_dw = Conv2d(half, half, 3, stride, 1, generator=generator, use_bias=False,
                            groups=half)
        self.b2_bn2 = BatchNorm(half)
        self.b2_pw2 = Conv2d(half, half, 1, generator=generator, use_bias=False)
        self.b2_bn3 = BatchNorm(half)

    def _branch2(self, y: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.b2_bn1(self.b2_pw1(y)))
        y = self.b2_bn2(self.b2_dw(y))
        return F.relu(self.b2_bn3(self.b2_pw2(y)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            c = x.shape[-1] // 2
            out = torch.cat([x[..., :c], self._branch2(x[..., c:])], dim=-1)
        else:
            b1 = self.b1_bn1(self.b1_dw(x))
            b1 = F.relu(self.b1_bn2(self.b1_pw(b1)))
            out = torch.cat([b1, self._branch2(x)], dim=-1)
        return _shuffle(out)


class ShuffleNetV2Stages(nn.Module):
    """NHWC input → 4 feature maps (/4 24 channels, /8 48, /16 96, /32 192)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv2d(3, _STEM, 3, 2, 1, generator=generator, use_bias=False)
        self.bn1 = BatchNorm(_STEM)
        self.stages = []
        c = _STEM
        for si, (reps, out) in enumerate(SHUFFLENET_V2_X0_5, start=2):
            names = []
            for bi in range(reps):
                name = f"stage{si}_{bi}"
                self.add_module(name, ShuffleBlock(c, out, 2 if bi == 0 else 1, generator))
                names.append(name)
                c = out
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        outs = [x]
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return outs


def convert_shufflenet_state(state: Mapping[str, np.ndarray]) -> dict:
    """torchvision shufflenet_v2 state dict → ``{'params', 'batch_stats'}``."""
    params: Dict = {}
    stats: Dict = {}
    put(params, "conv1/kernel", conv_w(state["conv1.0.weight"]))
    bn_from_torch(params, stats, "bn1", state, "conv1.1")
    for si, (reps, _) in enumerate(SHUFFLENET_V2_X0_5, start=2):
        for bi in range(reps):
            src, dst = f"stage{si}.{bi}", f"stage{si}_{bi}"
            convs = (("b2_pw1", "branch2.0"), ("b2_dw", "branch2.3"), ("b2_pw2", "branch2.5"))
            bns = (("b2_bn1", "branch2.1"), ("b2_bn2", "branch2.4"), ("b2_bn3", "branch2.6"))
            if bi == 0:  # the stride-2 block has branch1
                convs += (("b1_dw", "branch1.0"), ("b1_pw", "branch1.2"))
                bns += (("b1_bn1", "branch1.1"), ("b1_bn2", "branch1.3"))
            for ours, theirs in convs:
                put(params, f"{dst}/{ours}/kernel", conv_w(state[f"{src}.{theirs}.weight"]))
            for ours, theirs in bns:
                bn_from_torch(params, stats, f"{dst}/{ours}", state, f"{src}.{theirs}")
    return {"params": params, "batch_stats": stats}

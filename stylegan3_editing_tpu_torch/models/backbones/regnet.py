"""RegNetX / RegNetY feature stages (NHWC in public) for the projected discriminator.

Counterpart of the JAX package's `models/backbones/regnet.py`: timm
``regnetx_002…064`` and ``regnety_002…064`` as the reference's
``_make_regnet`` slices them: stage 0 is the stem and ``s1`` (/4), stages
1–3 are ``s2/s3/s4`` (/8, /16, /32). `regnet_stages` evaluates the RegNet
generation rule as timm does (widths ``w0 + wa·i`` quantised to powers of
``wm`` and to multiples of 8, then to the group width), so a timm state
dict fits shape for shape. The y-series puts a squeeze-excite between the
group conv and the projection, reduced from the block's input width.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm, Conv2d, bn_from_torch, conv_w, put

# name → (depth, w0, wa, wm, group width); the y-series has SE ratio 0.25.
REGNET_PARAMS = {
    "regnetx_002": (13, 24, 36.44, 2.49, 8),
    "regnetx_004": (22, 24, 24.48, 2.54, 16),
    "regnetx_006": (16, 48, 36.97, 2.24, 24),
    "regnetx_008": (16, 56, 35.73, 2.28, 16),
    "regnetx_016": (18, 80, 34.01, 2.25, 24),
    "regnetx_032": (25, 88, 26.31, 2.25, 48),
    "regnetx_040": (23, 96, 38.65, 2.43, 40),
    "regnetx_064": (17, 184, 60.83, 2.07, 56),
    "regnety_002": (13, 24, 36.44, 2.49, 8),
    "regnety_004": (16, 48, 27.89, 2.09, 8),
    "regnety_006": (15, 48, 32.54, 2.32, 16),
    "regnety_008": (14, 56, 38.84, 2.4, 16),
    "regnety_016": (27, 48, 20.71, 2.65, 24),
    "regnety_032": (21, 80, 42.63, 2.66, 24),
    "regnety_040": (22, 96, 31.41, 2.24, 64),
    "regnety_064": (25, 112, 33.22, 2.27, 72),
}
_STEM = 32


def regnet_stages(name: str) -> Tuple[Tuple[int, int, int], ...]:
    """name → per stage (depth, width, groups), the widths adjusted to the
    group width (timm's ``generate_regnet`` and ``adjust_widths_groups_comp``
    at bottleneck ratio 1)."""
    depth, w0, wa, wm, g = REGNET_PARAMS[name]
    cont = np.arange(depth) * wa + w0
    exps = np.round(np.log(cont / w0) / np.log(wm))
    widths = (np.round(w0 * np.power(wm, exps) / 8) * 8).astype(int)
    stage_widths, stage_depths = np.unique(widths, return_counts=True)
    out = []
    for w, d in zip(stage_widths.tolist(), stage_depths.tolist()):
        gw = min(g, w)
        w = int(round(w / gw) * gw)
        out.append((int(d), int(w), w // gw))
    if len(out) != 4:
        raise ValueError(f"{name}: expected 4 stages, got {len(out)}")
    return tuple(out)


class RegNetBlock(nn.Module):
    """timm's RegNet bottleneck: 1×1 → grouped 3×3 (stride) [→ SE] → 1×1,
    BN after each conv, ReLU after the first two; the input, or a strided
    1×1 conv and BN of it where the stride or the width changes, is added,
    then ReLU."""

    def __init__(self, in_channels: int, width: int, stride: int, groups: int, se: bool,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.se = se
        self.conv1 = Conv2d(in_channels, width, 1, generator=generator, use_bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = Conv2d(width, width, 3, stride, 1, generator=generator, use_bias=False,
                            groups=groups)
        self.bn2 = BatchNorm(width)
        if se:
            red = int(round(in_channels * 0.25))  # of the block's input width
            self.se_fc1 = Conv2d(width, red, 1, generator=generator)
            self.se_fc2 = Conv2d(red, width, 1, generator=generator)
        self.conv3 = Conv2d(width, width, 1, generator=generator, use_bias=False)
        self.bn3 = BatchNorm(width)
        self.downsample = stride != 1 or in_channels != width
        if self.downsample:
            self.down_conv = Conv2d(in_channels, width, 1, stride, generator=generator,
                                    use_bias=False)
            self.down_bn = BatchNorm(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        if self.se:
            s = F.relu(self.se_fc1(y.mean(dim=(1, 2), keepdim=True)))
            y = y * torch.sigmoid(self.se_fc2(s))
        y = self.bn3(self.conv3(y))
        if self.downsample:
            x = self.down_bn(self.down_conv(x))
        return F.relu(y + x)


class RegNetStages(nn.Module):
    """NHWC input → 4 feature maps at /4, /8, /16, /32 (stem and s1, s2, s3, s4)."""

    def __init__(self, name: str = "regnety_016", generator: Optional[torch.Generator] = None):
        super().__init__()
        se = name.startswith("regnety")
        self.stem_conv = Conv2d(3, _STEM, 3, 2, 1, generator=generator, use_bias=False)
        self.stem_bn = BatchNorm(_STEM)
        self.stages = []
        c = _STEM
        for si, (d, w, groups) in enumerate(regnet_stages(name), start=1):
            names = []
            for bi in range(1, d + 1):
                block = f"s{si}_b{bi}"
                self.add_module(block, RegNetBlock(c, w, 2 if bi == 1 else 1, groups, se,
                                                   generator))
                names.append(block)
                c = w
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        outs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return outs


def convert_regnet_state(state: Mapping[str, np.ndarray], name: str) -> dict:
    """timm regnet state dict (``stem.conv``, ``sN.bM.convK.conv`` …) →
    ``{'params', 'batch_stats'}``."""
    params: Dict = {}
    stats: Dict = {}
    put(params, "stem_conv/kernel", conv_w(state["stem.conv.weight"]))
    bn_from_torch(params, stats, "stem_bn", state, "stem.bn")
    se = name.startswith("regnety")
    for si, (d, _, _) in enumerate(regnet_stages(name), start=1):
        for bi in range(1, d + 1):
            src, dst = f"s{si}.b{bi}", f"s{si}_b{bi}"
            for k in (1, 2, 3):
                put(params, f"{dst}/conv{k}/kernel", conv_w(state[f"{src}.conv{k}.conv.weight"]))
                bn_from_torch(params, stats, f"{dst}/bn{k}", state, f"{src}.conv{k}.bn")
            if se:
                for fc in (1, 2):
                    put(params, f"{dst}/se_fc{fc}/kernel", conv_w(state[f"{src}.se.fc{fc}.weight"]))
                    put(params, f"{dst}/se_fc{fc}/bias", state[f"{src}.se.fc{fc}.bias"])
            if f"{src}.downsample.conv.weight" in state:
                put(params, f"{dst}/down_conv/kernel",
                    conv_w(state[f"{src}.downsample.conv.weight"]))
                bn_from_torch(params, stats, f"{dst}/down_bn", state, f"{src}.downsample.bn")
    return {"params": params, "batch_stats": stats}


def make_regnet(name: str):
    """'regnet[xy]_NNN' → (module factory, converter, the four stages' channels)."""

    def make(**kw) -> RegNetStages:
        return RegNetStages(name=name, **kw)

    def convert(state) -> dict:
        return convert_regnet_state(state, name)

    return make, convert, tuple(w for _, w, _ in regnet_stages(name))

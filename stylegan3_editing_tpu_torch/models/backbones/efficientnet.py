"""EfficientNet feature extractors (NHWC in public) for the projected discriminator.

Counterpart of the JAX package's `models/backbones/efficientnet.py`: timm
``tf_efficientnet_lite0`` / ``tf_efficientnet_b0`` and their compound-scaled
b1–b4 and lite1–lite4 ladder, sliced as the reference's
``_make_efficientnet`` does: level 0 = stem + stages 0–1 (/4), level 1 =
stage 2 (/8), level 2 = stages 3–4 (/16), level 3 = stages 5–6 (/32). The
lite variants use ReLU6, no squeeze-excite and a fixed 32-channel stem; the
b variants SiLU and squeeze-excite (a quarter of the block's input
channels). ``tf_`` means TensorFlow's "SAME" padding, which is asymmetric
on strided convs (`common.Conv2d` with ``padding="SAME"``); the depthwise
convs are grouped convs, and every batch norm has ε 1e-3 and runs on its
statistics. The converters read timm's state dicts (``conv_stem.weight``,
``blocks.3.1.conv_pwl.weight``, …).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm, Conv2d, bn_from_torch, conv_w, put

# Per stage (blocks, kernel, stride, expand ratio, out channels); b0/lite0.
_STAGES = (
    (1, 3, 1, 1, 16),
    (2, 3, 2, 6, 24),
    (2, 5, 2, 6, 40),
    (3, 3, 2, 6, 80),
    (3, 5, 1, 6, 112),
    (4, 5, 2, 6, 192),
    (1, 3, 1, 6, 320),
)
# Stage index ranges per feature level.
_LEVELS = ((0, 2), (2, 3), (3, 5), (5, 7))
BN_EPS = 1e-3  # TensorFlow's EfficientNet batch norms

# name → (width multiplier, depth multiplier): the compound-scaling ladder
# shared by the b and lite families.
EFFICIENTNET_SCALING = {
    0: (1.0, 1.0), 1: (1.0, 1.1), 2: (1.1, 1.2), 3: (1.2, 1.4), 4: (1.4, 1.8),
}


def _round_channels(c: float, mult: float) -> int:
    """timm ``round_channels`` (divisor 8): EfficientNet's width scaling."""
    v = c * mult
    new_v = max(8, int(v + 4) // 8 * 8)
    if new_v < 0.9 * v:
        new_v += 8
    return new_v


def scaled_stages(width_mult: float = 1.0, depth_mult: float = 1.0,
                  fix_first_last: bool = False):
    """The b0/lite0 stage table compound-scaled (timm ``decode_arch_def``:
    ``ceil(blocks · depth_mult)`` a stage, ``round_channels(c · width_mult)``;
    the lite family keeps the first and last stages' depth)."""
    out = []
    last = len(_STAGES) - 1
    for si, (blocks, k, s, e, c) in enumerate(_STAGES):
        if not (fix_first_last and si in (0, last)):
            blocks = int(math.ceil(blocks * depth_mult))
        out.append((blocks, k, s, e, _round_channels(c, width_mult)))
    return tuple(out)


def efficientnet_family(name: str):
    """``'tf_efficientnet_b3'`` / ``'tf_efficientnet_lite2'`` /
    ``'tf_efficientnet_b0_ns'`` → (stages, stem channels, se, act). ``_ns``
    (noisy-student weights) shares the base architecture."""
    base = name.replace("_ns", "")
    _, idx = base.rsplit("_", 1)
    lite = idx.startswith("lite")
    n = int(idx[4:] if lite else idx[1:])
    w, d = EFFICIENTNET_SCALING[n]
    if lite:
        return scaled_stages(w, d, fix_first_last=True), 32, False, "relu6"
    return scaled_stages(w, d), _round_channels(32, w), True, "silu"


_ACTS = {"relu6": lambda v: F.relu6(v), "silu": F.silu}


class SqueezeExcite(nn.Module):
    """timm SqueezeExcite: pooled → conv_reduce → act → conv_expand → gate."""

    def __init__(self, channels: int, reduced: int, act: str = "silu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _ACTS[act]
        self.conv_reduce = Conv2d(channels, reduced, 1, generator=generator)
        self.conv_expand = Conv2d(reduced, channels, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.conv_expand(self.act(self.conv_reduce(x.mean(dim=(1, 2), keepdim=True))))
        return x * torch.sigmoid(s)


class DepthwiseSeparable(nn.Module):
    """Stage-0 block: depthwise conv (+ SE) and a pointwise linear projection."""

    def __init__(self, in_channels: int, out: int, kernel: int, stride: int,
                 se_reduced: int = 0, act: str = "relu6",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act, self.residual = _ACTS[act], stride == 1 and in_channels == out
        self.conv_dw = Conv2d(in_channels, in_channels, kernel, stride, "SAME",
                              generator=generator, use_bias=False, groups=in_channels)
        self.bn1 = BatchNorm(in_channels, epsilon=BN_EPS)
        self.se = SqueezeExcite(in_channels, se_reduced, act, generator) if se_reduced else None
        self.conv_pw = Conv2d(in_channels, out, 1, generator=generator, use_bias=False)
        self.bn2 = BatchNorm(out, epsilon=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.bn1(self.conv_dw(x)))
        if self.se is not None:
            y = self.se(y)
        y = self.bn2(self.conv_pw(y))
        return y + x if self.residual else y


class InvertedResidual(nn.Module):
    """MBConv: pointwise expand → depthwise (+ SE) → pointwise linear
    (+ the input where the shape allows)."""

    def __init__(self, in_channels: int, out: int, kernel: int, stride: int, expand: int,
                 se_reduced: int = 0, act: str = "relu6",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        mid = in_channels * expand
        self.act, self.residual = _ACTS[act], stride == 1 and in_channels == out
        self.conv_pw = Conv2d(in_channels, mid, 1, generator=generator, use_bias=False)
        self.bn1 = BatchNorm(mid, epsilon=BN_EPS)
        self.conv_dw = Conv2d(mid, mid, kernel, stride, "SAME", generator=generator,
                              use_bias=False, groups=mid)
        self.bn2 = BatchNorm(mid, epsilon=BN_EPS)
        self.se = SqueezeExcite(mid, se_reduced, act, generator) if se_reduced else None
        self.conv_pwl = Conv2d(mid, out, 1, generator=generator, use_bias=False)
        self.bn3 = BatchNorm(out, epsilon=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.bn1(self.conv_pw(x)))
        y = self.act(self.bn2(self.conv_dw(y)))
        if self.se is not None:
            y = self.se(y)
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.residual else y


class EfficientNetFeatures(nn.Module):
    """NHWC input → 4 feature maps (/4, /8, /16, /32; 24, 40, 112, 320
    channels for b0/lite0). ``se`` + ``act="silu"`` is the full B0; the
    lite0 default has no SE and ReLU6."""

    def __init__(self, se: bool = False, act: str = "relu6", stages=_STAGES, stem: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _ACTS[act]
        self.conv_stem = Conv2d(3, stem, 3, 2, "SAME", generator=generator, use_bias=False)
        self.bn1 = BatchNorm(stem, epsilon=BN_EPS)
        self.levels = []
        in_c = stem
        for s0, s1 in _LEVELS:
            names = []
            for si in range(s0, s1):
                blocks, k, stride, exp, out = stages[si]
                for bi in range(blocks):
                    se_red = max(1, int(in_c * 0.25)) if se else 0
                    first_stride = stride if bi == 0 else 1
                    block = (DepthwiseSeparable(in_c, out, k, first_stride, se_red, act, generator)
                             if exp == 1 else
                             InvertedResidual(in_c, out, k, first_stride, exp, se_red, act,
                                              generator))
                    self.add_module(f"blocks_{si}_{bi}", block)
                    names.append(f"blocks_{si}_{bi}")
                    in_c = out
            self.levels.append(names)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.act(self.bn1(self.conv_stem(x)))
        outs = []
        for names in self.levels:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return outs


def EfficientNetLite0Features(**kw) -> EfficientNetFeatures:
    return EfficientNetFeatures(se=False, act="relu6", **kw)


def EfficientNetB0Features(**kw) -> EfficientNetFeatures:
    return EfficientNetFeatures(se=True, act="silu", **kw)


def _convert_efficientnet_state(state: Mapping[str, np.ndarray], se: bool,
                                stages=_STAGES) -> dict:
    params: Dict = {}
    stats: Dict = {}
    put(params, "conv_stem/kernel", conv_w(state["conv_stem.weight"]))
    bn_from_torch(params, stats, "bn1", state, "bn1")
    for si, (blocks, _, _, exp, _) in enumerate(stages):
        for bi in range(blocks):
            src, dst = f"blocks.{si}.{bi}", f"blocks_{si}_{bi}"
            # A depthwise weight [C, 1, kh, kw] becomes [kh, kw, 1, C], as any conv's.
            convs = (("conv_dw", "bn1"), ("conv_pw", "bn2")) if exp == 1 else \
                (("conv_pw", "bn1"), ("conv_dw", "bn2"), ("conv_pwl", "bn3"))
            for conv, bn in convs:
                put(params, f"{dst}/{conv}/kernel", conv_w(state[f"{src}.{conv}.weight"]))
                bn_from_torch(params, stats, f"{dst}/{bn}", state, f"{src}.{bn}")
            if se:
                for conv in ("conv_reduce", "conv_expand"):
                    put(params, f"{dst}/se/{conv}/kernel", conv_w(state[f"{src}.se.{conv}.weight"]))
                    put(params, f"{dst}/se/{conv}/bias", state[f"{src}.se.{conv}.bias"])
    return {"params": params, "batch_stats": stats}


def convert_efficientnet_lite0(state: Mapping[str, np.ndarray]) -> dict:
    """timm ``tf_efficientnet_lite0`` state dict → the module's variables."""
    return _convert_efficientnet_state(state, se=False)


def convert_efficientnet_b0(state: Mapping[str, np.ndarray]) -> dict:
    """timm ``tf_efficientnet_b0`` state dict → the module's variables."""
    return _convert_efficientnet_state(state, se=True)


def make_efficientnet(name: str):
    """Any ``tf_efficientnet_{b0..b4, b0_ns, lite0..lite4}`` → (module
    factory, converter, the 4 levels' channels)."""
    stages, stem, se, act = efficientnet_family(name)
    channels = tuple(stages[s1 - 1][4] for _, s1 in _LEVELS)

    def make(**kw) -> EfficientNetFeatures:
        return EfficientNetFeatures(se=se, act=act, stages=stages, stem=stem, **kw)

    def convert(state: Mapping[str, np.ndarray]) -> dict:
        return _convert_efficientnet_state(state, se=se, stages=stages)

    return make, convert, channels

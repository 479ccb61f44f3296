"""DenseNet feature stages (NHWC in public) for the projected discriminator.

Counterpart of the JAX package's `models/backbones/densenet.py`:
torchvision ``densenet121/169/201`` as the reference's ``_make_densenet``
slices it. Stage 0 is the stem, dense block 1 and transition 1 with its
pool (/8); each later stage is the splitter's leading 2×2 average pool, the
dense block and, for blocks 2 and 3, the transition's BN-ReLU-conv without
its pool (/16, /32); stage 3 ends with ``norm5`` and no ReLU (/64).
Parameter names are the flax paths (``block1_layer3.conv2.kernel``);
`convert_densenet_state` reads torchvision's state dict.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.image import avg_pool2d, max_pool2d
from .common import BatchNorm, Conv2d, bn_from_torch, conv_w, put

# name → dense layers per block (growth rate 32, stem 64, bottleneck 4 × 32).
DENSENET_BLOCKS = {
    "densenet121": (6, 12, 24, 16),
    "densenet169": (6, 12, 32, 32),
    "densenet201": (6, 12, 48, 32),
}
_GROWTH = 32
_BN_SIZE = 4


def densenet_channels(blocks: Sequence[int]) -> tuple:
    """The four stages' output channels for a block configuration."""
    c = 64
    outs = []
    for bi, n in enumerate(blocks):
        c += n * _GROWTH
        if bi < 3:
            c //= 2  # the transition conv halves them
        outs.append(c)
    return tuple(outs)


class DenseLayer(nn.Module):
    """torchvision ``_DenseLayer``: BN-ReLU-1×1 conv (128) → BN-ReLU-3×3 conv
    (32), concatenated after the input."""

    def __init__(self, in_channels: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = BatchNorm(in_channels)
        self.conv1 = Conv2d(in_channels, _BN_SIZE * _GROWTH, 1, generator=generator,
                            use_bias=False)
        self.norm2 = BatchNorm(_BN_SIZE * _GROWTH)
        self.conv2 = Conv2d(_BN_SIZE * _GROWTH, _GROWTH, 3, 1, 1, generator=generator,
                            use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=-1)


class DenseNetStages(nn.Module):
    """NHWC input → 4 feature maps (/8, /16, /32, /64)."""

    def __init__(self, blocks: Sequence[int] = DENSENET_BLOCKS["densenet121"],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.blocks = tuple(blocks)
        self.conv0 = Conv2d(3, 64, 7, 2, 3, generator=generator, use_bias=False)
        self.norm0 = BatchNorm(64)
        c = 64
        for bi, n in enumerate(self.blocks):
            for li in range(n):
                self.add_module(f"block{bi}_layer{li}", DenseLayer(c, generator))
                c += _GROWTH
            if bi < 3:
                self.add_module(f"trans{bi}_norm", BatchNorm(c))
                self.add_module(f"trans{bi}_conv", Conv2d(c, c // 2, 1, generator=generator,
                                                          use_bias=False))
                c //= 2
            else:
                self.norm5 = BatchNorm(c)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = max_pool2d(F.relu(self.norm0(self.conv0(x))), 3, 2, padding=1)
        outs = []
        for bi, n in enumerate(self.blocks):
            if bi > 0:
                x = avg_pool2d(x, 2, 2)  # the splitter's leading AvgPool2d
            for li in range(n):
                x = getattr(self, f"block{bi}_layer{li}")(x)
            if bi < 3:
                x = getattr(self, f"trans{bi}_conv")(F.relu(getattr(self, f"trans{bi}_norm")(x)))
                if bi == 0:  # only stage 0 keeps the transition's pool
                    x = avg_pool2d(x, 2, 2)
            else:
                x = self.norm5(x)
            outs.append(x)
        return outs


def convert_densenet_state(state: Mapping[str, np.ndarray],
                           blocks: Sequence[int] = DENSENET_BLOCKS["densenet121"]) -> dict:
    """torchvision densenet state dict → ``{'params', 'batch_stats'}``."""
    params: Dict = {}
    stats: Dict = {}
    put(params, "conv0/kernel", conv_w(state["features.conv0.weight"]))
    bn_from_torch(params, stats, "norm0", state, "features.norm0")
    for bi, n in enumerate(blocks):
        for li in range(n):
            src, dst = f"features.denseblock{bi + 1}.denselayer{li + 1}", f"block{bi}_layer{li}"
            for k in (1, 2):
                bn_from_torch(params, stats, f"{dst}/norm{k}", state, f"{src}.norm{k}")
                put(params, f"{dst}/conv{k}/kernel", conv_w(state[f"{src}.conv{k}.weight"]))
        if bi < 3:
            src = f"features.transition{bi + 1}"
            bn_from_torch(params, stats, f"trans{bi}_norm", state, f"{src}.norm")
            put(params, f"trans{bi}_conv/kernel", conv_w(state[f"{src}.conv.weight"]))
        else:
            bn_from_torch(params, stats, "norm5", state, "features.norm5")
    return {"params": params, "batch_stats": stats}


def make_densenet(name: str):
    """'densenet121/169/201' → (module factory, converter, channels)."""
    blocks = DENSENET_BLOCKS[name]

    def make(**kw) -> DenseNetStages:
        return DenseNetStages(blocks=blocks, **kw)

    def convert(state) -> dict:
        return convert_densenet_state(state, blocks)

    return make, convert, densenet_channels(blocks)

"""ReStyle encoders on the IR(-SE) and ResNet-34 trunks: plain (pSp) and
progressive (e4e).

Counterpart of the JAX package's `models/encoders/backbones.py` (reference
restyle_psp_encoders.BackboneEncoder / ResNetBackboneEncoder and
restyle_e4e_encoders.ProgressiveBackboneEncoder /
ResNetProgressiveBackboneEncoder). All styles are read off the trunk's
final 16×16×512 feature map by ``n_styles`` GradualStyleBlocks; the
progressive encoders emit w0 plus per-stage deltas. The progressive stage
is a plain Python argument, and every head exists whatever the stage, so
the parameter tree does not depend on it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..backbones.common import BatchNorm, Conv2d, PReLU
from ..backbones.irse import IRSEBody
from ..backbones.resnet import ResNet34Body
from .map2style import GradualStyleBlock

# e4e progressive training schedule (restyle_e4e_encoders.ProgressiveStage):
# stage k trains w0 + deltas 1..k; INFERENCE_STAGE applies all deltas.
INFERENCE_STAGE = -1

# The trunk of the ReStyle encoders: the IR(-SE) body without the face net's
# output layer (the JAX package's `_IRSETrunk`).
_IRSETrunk = IRSEBody


class _ResNetTrunk(nn.Module):
    """7×7 stride-2 stem (no max pool), BN, PReLU, then the ResNet-34 body:
    256² → 16×16×512."""

    def __init__(self, input_nc: int = 6, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv2d(input_nc, 64, 7, 2, 3, generator=generator, use_bias=False)
        self.bn1 = BatchNorm(64)
        self.relu = PReLU(64)
        self.body = ResNet34Body(generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.body(self.relu(self.bn1(self.conv1(x), train=train)), train=train)


def _read_styles(encoder: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``[N, n_styles, style_dim]``, one head a style."""
    return torch.stack([getattr(encoder, f"style_{j}")(x) for j in range(encoder.n_styles)],
                       dim=1)


def _progressive_styles(encoder: nn.Module, x: torch.Tensor, stage: int) -> torch.Tensor:
    """w0 in every row, plus delta i in row i for the stage's active heads;
    the heads past the stage are not run (their deltas count as zero)."""
    n_styles = encoder.n_styles
    w0 = encoder.style_0(x)
    limit = n_styles if stage == INFERENCE_STAGE else min(stage + 1, n_styles)
    rows = [w0] + [w0 + getattr(encoder, f"style_{i}")(x) if i < limit else w0
                   for i in range(1, n_styles)]
    return torch.stack(rows, dim=1)


class _StyleEncoder(nn.Module):
    """A trunk (``trunk``) plus heads ``style_0 … style_{n-1}``."""

    def __init__(self, trunk: nn.Module, n_styles: int, style_dim: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.n_styles, self.style_dim = n_styles, style_dim
        self.trunk = trunk
        for j in range(n_styles):
            self.add_module(f"style_{j}", GradualStyleBlock(style_dim, 16, 512, generator))


class _IRSEEncoder(_StyleEncoder):
    def __init__(self, num_layers: int = 50, mode: str = "ir_se", n_styles: int = 16,
                 style_dim: int = 512, input_nc: int = 6,
                 generator: Optional[torch.Generator] = None):
        super().__init__(_IRSETrunk(num_layers, mode, input_nc, generator=generator),
                         n_styles, style_dim, generator)


class _ResNetEncoder(_StyleEncoder):
    def __init__(self, n_styles: int = 16, style_dim: int = 512, input_nc: int = 6,
                 generator: Optional[torch.Generator] = None):
        super().__init__(_ResNetTrunk(input_nc, generator), n_styles, style_dim, generator)


class _Plain:
    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return _read_styles(self, self.trunk(x, train=train))


class _Progressive:
    def forward(self, x: torch.Tensor, train: bool = False,
                stage: int = INFERENCE_STAGE) -> torch.Tensor:
        return _progressive_styles(self, self.trunk(x, train=train), stage)


class BackboneEncoder(_Plain, _IRSEEncoder):
    """ReStyle-pSp encoder, IR-SE-50 trunk. Input NHWC (``input_nc`` channels)."""


class ProgressiveBackboneEncoder(_Progressive, _IRSEEncoder):
    """ReStyle-e4e encoder, IR-SE-50 trunk, w0 + progressive deltas."""


class ResNetBackboneEncoder(_Plain, _ResNetEncoder):
    """ReStyle-pSp encoder, ResNet-34 trunk."""


class ResNetProgressiveBackboneEncoder(_Progressive, _ResNetEncoder):
    """ReStyle-e4e encoder, ResNet-34 trunk, w0 + progressive deltas."""

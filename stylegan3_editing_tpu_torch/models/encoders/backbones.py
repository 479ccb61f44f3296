"""ReStyle encoders on the IR(-SE) trunk: plain (pSp) and progressive (e4e).

Counterpart of the JAX package's `models/encoders/backbones.py` (reference
restyle_psp_encoders.BackboneEncoder and
restyle_e4e_encoders.ProgressiveBackboneEncoder). All styles are read off
the trunk's final 16×16×512 feature map by ``n_styles`` GradualStyleBlocks;
the progressive encoder emits w0 plus per-stage deltas. The progressive
stage is a plain Python argument, and every head exists whatever the stage,
so the parameter tree does not depend on it. The ResNet-34 trunks wait for
`models/backbones/resnet.py`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..backbones.irse import IRSEBody
from .map2style import GradualStyleBlock

# e4e progressive training schedule (restyle_e4e_encoders.ProgressiveStage):
# stage k trains w0 + deltas 1..k; INFERENCE_STAGE applies all deltas.
INFERENCE_STAGE = -1

# The trunk of the ReStyle encoders: the IR(-SE) body without the face net's
# output layer (the JAX package's `_IRSETrunk`).
_IRSETrunk = IRSEBody


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
    """IR(-SE) trunk (``trunk``) plus heads ``style_0 … style_{n-1}``."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se", n_styles: int = 16,
                 style_dim: int = 512, input_nc: int = 6,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_styles, self.style_dim = n_styles, style_dim
        self.trunk = _IRSETrunk(num_layers, mode, input_nc, generator=generator)
        for j in range(n_styles):
            self.add_module(f"style_{j}", GradualStyleBlock(style_dim, 16, 512, generator))


class BackboneEncoder(_StyleEncoder):
    """ReStyle-pSp encoder, IR-SE-50 trunk. Input NHWC (``input_nc`` channels)."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return _read_styles(self, self.trunk(x, train=train))


class ProgressiveBackboneEncoder(_StyleEncoder):
    """ReStyle-e4e encoder, IR-SE-50 trunk, w0 + progressive deltas."""

    def forward(self, x: torch.Tensor, train: bool = False,
                stage: int = INFERENCE_STAGE) -> torch.Tensor:
        return _progressive_styles(self, self.trunk(x, train=train), stage)

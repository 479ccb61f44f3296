"""map2style head: strided convs collapsing a feature map to one style.

Counterpart of the JAX package's `models/encoders/map2style.py` (reference
`GradualStyleBlock`): log2(S) stride-2 3×3 convs with LeakyReLU(0.01)
collapse S×S → 1×1, then an equalized-LR linear (`FullyConnected`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..backbones.common import Conv2d
from ..sg3.layers import FullyConnected


class GradualStyleBlock(nn.Module):
    """NHWC ``[N, S, S, in_c]`` → ``[N, out_c]``; ``in_c`` defaults to
    ``out_c`` (the encoders' 512-channel feature map)."""

    def __init__(self, out_c: int, spatial: int, in_c: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_c = out_c
        self.num_pools = int(np.log2(spatial))
        for i in range(self.num_pools):
            self.add_module(f"conv{i}", Conv2d(out_c if i or in_c is None else in_c, out_c, 3,
                                               2, 1, generator=generator))
        self.linear = FullyConnected(out_c, out_c, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_pools):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), 0.01)
        return self.linear(x.reshape(x.shape[0], self.out_c))

"""Shared building blocks and torch-weight mapping helpers for backbones.

Counterpart of the JAX package's `models/backbones/common.py`. Weights are
stored in the flax layout (HWIO kernels), so a flax tree copies in as it is.
The conv runs through PyTorch's convolution in full fp32 (`device.conv2d`;
the JAX package leaves these convs to XLA) on the NCHW view of an NHWC
tensor, which is channels-last in memory, so no copy is made either way.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ...device import conv2d


class Conv2d(nn.Module):
    """2-D convolution of NHWC tensors with an HWIO ``kernel`` and a ``bias``.

    Initialised from ``generator``: the kernel normal with std
    ``1/sqrt(fan_in)`` (flax's lecun normal, untruncated), the bias zero.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        fan_in = in_channels * kernel_size ** 2
        self.kernel = nn.Parameter(torch.randn(
            (kernel_size, kernel_size, in_channels, out_channels), generator=generator)
            / math.sqrt(fan_in))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(x.permute(0, 3, 1, 2), self.kernel.permute(3, 2, 0, 1), self.bias,
                   stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


def conv_w(t) -> np.ndarray:
    """torch conv weight OIHW → HWIO."""
    return np.asarray(t).transpose(2, 3, 1, 0)


def put(tree: Dict, dotted: str, value) -> None:
    """Set ``tree[a][b][c] = value`` for ``dotted = "a/b/c"``."""
    node = tree
    keys = dotted.split("/")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = np.asarray(value)

"""Shared building blocks and torch-weight mapping helpers for backbones.

Counterpart of the JAX package's `models/backbones/common.py`. Weights are
stored in the flax layout (HWIO kernels, ``[in, out]`` dense kernels) under
the flax names, so a flax tree copies in as it is; batch-norm statistics are
buffers named after the flax ``batch_stats`` collection (``mean``, ``var``).
The conv runs through PyTorch's convolution in full fp32 (`device.conv2d`;
the JAX package leaves these convs to XLA) on the NCHW view of an NHWC
tensor, which is channels-last in memory, so no copy is made either way.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import conv2d


class Conv2d(nn.Module):
    """2-D convolution of NHWC tensors with an HWIO ``kernel`` and, unless
    ``use_bias=False`` (flax ``nn.Conv(use_bias=False)``), a ``bias``.

    ``kernel_size`` is ``k`` (square) or ``(kh, kw)``. ``padding`` is a
    number of pixels on each side, a pair ``(ph, pw)`` (each on both sides
    of its axis, as torchvision's ``BasicConv2d`` pads a 1×7 kernel), or
    ``"SAME"`` as flax
    and TensorFlow pad: ``ceil(in / stride)`` outputs, the total padding
    ``k − stride`` (for an input the stride divides) split with the smaller
    half before, so a stride-2 conv on an even input pads one pixel fewer
    on the top and left than on the bottom and right. ``groups`` is flax's
    ``feature_group_count`` (``groups = channels``: depthwise; the kernel
    is then ``[k, k, 1, C]``).

    Initialised from ``generator``: the kernel normal with std
    ``1/sqrt(fan_in)`` (flax's lecun normal, untruncated), the bias zero.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]], stride: int = 1,
                 padding: Union[int, Tuple[int, int], str] = 0,
                 generator: Optional[torch.Generator] = None, use_bias: bool = True,
                 groups: int = 1):
        super().__init__()
        if isinstance(padding, str) and padding != "SAME":
            raise ValueError(f"padding must be a number, a pair or 'SAME', got {padding!r}")
        self.stride, self.groups = stride, groups
        self.padding = tuple(padding) if isinstance(padding, (tuple, list)) else padding
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        fan_in = in_channels // groups * kh * kw
        self.kernel = nn.Parameter(torch.randn(
            (kh, kw, in_channels // groups, out_channels),
            generator=generator) / math.sqrt(fan_in))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, padding = x.permute(0, 3, 1, 2), self.padding
        if padding == "SAME":
            pads = []
            for size, k in ((x.shape[3], self.kernel.shape[1]), (x.shape[2], self.kernel.shape[0])):
                total = max((-(-size // self.stride) - 1) * self.stride + k - size, 0)
                pads += [total // 2, total - total // 2]
            x, padding = F.pad(x, pads), 0
        y = conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias, stride=self.stride,
                   padding=padding, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with a ``[in, out]`` kernel."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.randn((in_features, out_features), generator=generator)
                                   / math.sqrt(in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: ``scale``, ``bias``, flax's
    default epsilon 1e-6 unless another is given."""

    def __init__(self, width: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, eps=self.epsilon)


class PReLU(nn.Module):
    """Per-channel parametric ReLU (torch ``PReLU(num_parameters=C)``) over
    the last axis; ``alpha`` starts at 0.25."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, x * self.alpha.to(x.dtype))


class BatchNorm(nn.Module):
    """Batch norm over the last axis with torch-compatible parameters.

    ``scale``/``bias`` are parameters (if ``affine``), ``mean``/``var``
    buffers. ``train=True`` normalises by the batch's statistics (biased
    variance) and moves the buffers by torch's momentum convention
    (new = (1 − momentum)·old + momentum·batch, unbiased variance).
    ``epsilon`` is torch's 1e-5 unless another is given (TensorFlow's
    EfficientNets use 1e-3).
    """

    momentum = 0.1

    def __init__(self, channels: int, affine: bool = True, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.scale = nn.Parameter(torch.ones(channels)) if affine else None
        self.bias = nn.Parameter(torch.zeros(channels)) if affine else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            axes = tuple(range(x.ndim - 1))
            x32 = x.float()
            batch_mean = x32.mean(dim=axes)
            batch_var = x32.var(dim=axes, unbiased=False)
            n = math.prod(x.shape[a] for a in axes)
            with torch.no_grad():
                unbiased = batch_var * (n / max(n - 1, 1))
                self.mean.copy_((1 - self.momentum) * self.mean + self.momentum * batch_mean)
                self.var.copy_((1 - self.momentum) * self.var + self.momentum * unbiased)
            use_mean, use_var = batch_mean, batch_var
        else:
            use_mean, use_var = self.mean, self.var
        y = (x - use_mean.to(x.dtype)) * torch.rsqrt(use_var + self.epsilon).to(x.dtype)
        if self.scale is not None:
            y = y * self.scale.to(x.dtype) + self.bias.to(x.dtype)
        return y


def conv_w(t) -> np.ndarray:
    """torch conv weight OIHW → HWIO."""
    return np.asarray(t).transpose(2, 3, 1, 0)


def dense_w(t) -> np.ndarray:
    """torch linear weight ``[out, in]`` → flax Dense kernel ``[in, out]``."""
    return np.asarray(t).T


def put(tree: Dict, dotted: str, value) -> None:
    """Set ``tree[a][b][c] = value`` for ``dotted = "a/b/c"``."""
    node = tree
    keys = dotted.split("/")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = np.asarray(value)


def bn_from_torch(params: Dict, stats: Dict, prefix_out: str,
                  state: Mapping[str, np.ndarray], prefix_in: str,
                  affine: bool = True) -> None:
    """Copy one torch BatchNorm's 4 tensors into the two collections."""
    if affine:
        put(params, f"{prefix_out}/scale", state[f"{prefix_in}.weight"])
        put(params, f"{prefix_out}/bias", state[f"{prefix_in}.bias"])
    put(stats, f"{prefix_out}/mean", state[f"{prefix_in}.running_mean"])
    put(stats, f"{prefix_out}/var", state[f"{prefix_in}.running_var"])

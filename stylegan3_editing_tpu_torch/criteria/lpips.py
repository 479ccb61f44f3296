"""LPIPS perceptual distance (NHWC images in [-1, 1]).

Counterpart of the JAX package's `criteria/lpips.py` (reference
criteria/lpips/lpips.py): z-scored input, unit-normalised features at the
trunk's taps (AlexNet, VGG16 or SqueezeNet-1.1: 5, 5 or 7 of them), squared
differences, 1×1 linear heads (initialised to the channel mean, 1/C),
spatial mean, sum over layers and batch / batch.
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..models.backbones.alexnet import N_CHANNELS as ALEX_CHANNELS
from ..models.backbones.alexnet import AlexNetFeatures
from ..models.backbones.common import put
from ..models.backbones.squeezenet import N_CHANNELS as SQUEEZE_CHANNELS
from ..models.backbones.squeezenet import SqueezeNetFeatures
from ..models.backbones.vgg import N_CHANNELS as VGG_CHANNELS
from ..models.backbones.vgg import VGG16Features

TRUNKS = {"alex": (AlexNetFeatures, ALEX_CHANNELS),
          "vgg": (VGG16Features, VGG_CHANNELS),
          "squeeze": (SqueezeNetFeatures, SQUEEZE_CHANNELS)}

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _normalize_activation(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    # The sqrt at an all-zero feature vector has an infinite derivative, so
    # its gradient is NaN there, as in the JAX package.
    return x / (x.square().sum(-1, keepdim=True).sqrt() + eps)


class LPIPS(nn.Module):
    """LPIPS criterion: ``lpips(x, y)`` → scalar, images NHWC in [-1, 1].

    Random trunk weights come from ``generator`` (seed 0 by default) until
    `load_jax_variables` or the converters fill them. Built on the CUDA card
    unless ``device="cpu"``.
    """

    def __init__(self, net_type: str = "alex", device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if net_type not in TRUNKS:
            raise NotImplementedError(net_type)
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        trunk, channels = TRUNKS[net_type]
        self.net = trunk(generator=generator)
        for i, c in enumerate(channels):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.full((1, 1, c, 1), 1.0 / c)))
        self.register_buffer("shift", torch.tensor(_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE), persistent=False)
        self.to(device)

    def _layer_scores(self, x: torch.Tensor, y: torch.Tensor) -> List[torch.Tensor]:
        """Per tap, each image's head-weighted spatial mean, ``[N]``."""
        feats_x = self.net((x - self.shift) / self.scale)
        feats_y = self.net((y - self.shift) / self.scale)
        scores = []
        for i, (fx, fy) in enumerate(zip(feats_x, feats_y)):
            d = (_normalize_activation(fx) - _normalize_activation(fy)).square()
            scores.append((d @ getattr(self, f"lin{i}")[0, 0, :, 0]).mean((1, 2)))
        return scores

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for score in self._layer_scores(x, y):
            total = total + score.sum()
        return total / x.shape[0]

    def per_image(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``[N]``: each pair's distance, as a batch-1 call would give it."""
        total = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
        for score in self._layer_scores(x, y):
            total = total + score
        return total


def convert_lpips_linear_state(state: Mapping) -> dict:
    """richzhang linear heads (``{i}.1.weight``, ``[1, C, 1, 1]``) → ``{"lin{i}":
    [1, 1, C, 1]}``, any head count."""
    params: dict = {}
    for i in range(sum(1 for k in state if k.endswith(".1.weight"))):
        put(params, f"lin{i}", np.asarray(state[f"{i}.1.weight"]).transpose(2, 3, 1, 0))
    return params

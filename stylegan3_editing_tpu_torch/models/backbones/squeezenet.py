"""SqueezeNet-1.1 feature stack for LPIPS (NHWC in public).

Counterpart of the JAX package's `models/backbones/squeezenet.py`:
torchvision ``squeezenet1_1().features`` as sliced by the reference LPIPS,
seven taps with channels (64, 128, 256, 384, 384, 512, 512). A Fire module
is a 1×1 squeeze → ReLU → concat(1×1 expand, 3×3 expand), each expansion
ReLU'd. Convs are the port's `common.Conv2d` (full fp32 on the card).
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.image import max_pool2d
from .common import Conv2d, conv_w, put

N_CHANNELS = (64, 128, 256, 384, 384, 512, 512)
# (name, squeeze, expand per branch) in order; a ceil-mode 3×3/2 pool runs
# before fire3, fire6 and fire9.
_FIRES = (("fire3", 16, 64), ("fire4", 16, 64), ("fire6", 32, 128), ("fire7", 32, 128),
          ("fire9", 48, 192), ("fire10", 48, 192), ("fire11", 64, 256), ("fire12", 64, 256))
_POOL_BEFORE = {"fire3", "fire6", "fire9"}
_TAP_AFTER = {"fire4", "fire7", "fire9", "fire10", "fire11", "fire12"}


class Fire(nn.Module):
    """SqueezeNet Fire: squeeze 1×1 → ReLU → [expand 1×1 ‖ expand 3×3]."""

    def __init__(self, in_channels: int, squeeze: int, expand: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.squeeze = Conv2d(in_channels, squeeze, 1, generator=generator)
        self.expand1x1 = Conv2d(squeeze, expand, 1, generator=generator)
        self.expand3x3 = Conv2d(squeeze, expand, 3, 1, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], dim=-1)


class SqueezeNetFeatures(nn.Module):
    """NHWC input → list of 7 feature maps at the LPIPS tap points."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv0 = Conv2d(3, 64, 3, 2, 0, generator=generator)
        cin = 64
        for name, squeeze, expand in _FIRES:
            self.add_module(name, Fire(cin, squeeze, expand, generator))
            cin = 2 * expand

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.conv0(x))
        feats = [x]
        for name, _, _ in _FIRES:
            if name in _POOL_BEFORE:
                x = max_pool2d(x, 3, 2, ceil_mode=True)
            x = getattr(self, name)(x)
            if name in _TAP_AFTER:
                feats.append(x)
        return feats


def convert_squeezenet_state(state: Mapping) -> dict:
    """torchvision squeezenet1_1 state dict (``features.N.*``) → ``{"params":
    tree}`` for `load_jax_variables`."""
    params: dict = {}
    put(params, "conv0/kernel", conv_w(state["features.0.weight"]))
    put(params, "conv0/bias", state["features.0.bias"])
    for idx in (3, 4, 6, 7, 9, 10, 11, 12):
        for branch in ("squeeze", "expand1x1", "expand3x3"):
            put(params, f"fire{idx}/{branch}/kernel",
                conv_w(state[f"features.{idx}.{branch}.weight"]))
            put(params, f"fire{idx}/{branch}/bias", state[f"features.{idx}.{branch}.bias"])
    return {"params": params}

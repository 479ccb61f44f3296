"""MoCo-v2 feature similarity loss for non-face domains (NHWC).

Counterpart of the JAX package's `criteria/moco_loss.py` (reference
criteria/moco_loss.py): a nearest resize to 224², ResNet-50 features,
unit-normalised; the loss is ``mean(1 − ⟨ŷ, y⟩)`` with the target's
features detached, and the similarity improvement of ŷ over the source x is
reported. A MoCo checkpoint fills the trunk through
`models.backbones.resnet.convert_resnet50_state` once its
``module.encoder_q.`` prefix is stripped.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..models.backbones.resnet import ResNet50Features
from ..ops.image import resize_nearest


class MocoLoss(nn.Module):
    """forward(y_hat, y, x) → (loss, sim_improvement, logs). The trunk is
    seeded from ``generator`` on ``device`` (the CUDA card unless
    ``device="cpu"``) until `load_jax_variables` fills it."""

    def __init__(self, device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.model = ResNet50Features(generator=generator).to(resolve_device(device))

    def extract_feats(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.model(resize_nearest(x, 224))
        return feats / feats.square().sum(-1, keepdim=True).sqrt()

    def forward(self, y_hat: torch.Tensor, y: torch.Tensor, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        x_feats = self.extract_feats(x)
        y_feats = self.extract_feats(y).detach()
        y_hat_feats = self.extract_feats(y_hat)
        diff_target = (y_hat_feats * y_feats).sum(-1)
        diff_input = (y_hat_feats * x_feats).sum(-1)
        diff_views = (y_feats * x_feats).sum(-1)
        loss = (1 - diff_target).mean()
        sim_improvement = (diff_target - diff_views).mean()
        return loss, sim_improvement, {"diff_target": diff_target, "diff_input": diff_input,
                                       "diff_views": diff_views}

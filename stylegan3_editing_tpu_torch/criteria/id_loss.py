"""Identity loss through an IR-SE-50 face embedding (NHWC).

Counterpart of the JAX package's `criteria/id_loss.py` (reference
criteria/id_loss.py): pool to 256² (torch's adaptive average pooling),
crop rows 35:223 and columns 32:220, pool to 112², embed; the loss is
``mean(1 − ⟨ŷ, y⟩)`` with the target's features detached (the JAX
``stop_gradient``), and the similarity improvement of ŷ over the source x
is reported. The per-sample loop of the reference is one batched call.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..models.backbones.irse import IRSEBackbone
from ..ops.image import adaptive_avg_pool2d


class IDLoss(nn.Module):
    """forward(y_hat, y, x) → (loss, sim_improvement, logs). ``facenet`` is
    the face net to embed with (a seeded IR-SE-50 on ``device`` when none is
    given)."""

    def __init__(self, facenet: Optional[nn.Module] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if facenet is None:
            facenet = IRSEBackbone(input_size=112, num_layers=50, mode="ir_se", drop_ratio=0.6,
                                   generator=generator).to(resolve_device(device))
        self.facenet = facenet

    def extract_feats(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != 256:
            x = adaptive_avg_pool2d(x, 256)
        x = x[:, 35:223, 32:220, :]
        return self.facenet(adaptive_avg_pool2d(x, 112))

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

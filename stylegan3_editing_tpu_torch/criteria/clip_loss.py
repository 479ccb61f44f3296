"""CLIP similarity loss for StyleCLIP mapper training.

Counterpart of the JAX package's `criteria/clip_loss.py` (reference
criteria/clip_loss.py): the generator's output is upsampled ×7 by nearest
neighbour and average-pooled by ``stylegan_size / 32`` to 224², then
CLIP-normalised from [-1, 1]; the loss is ``1 − logits_per_image / 100``
against the tokenised text. The JAX op order is kept: at 1024² the ×7
intermediate is 7168² per image (about 1.2 GB at batch 2 in fp32).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike
from ..models.backbones.clip import CLIP, CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from ..ops.image import avg_pool2d, resize_nearest


class CLIPLoss(nn.Module):
    """forward(image NHWC in [-1, 1], text token ids ``[M, 77]``) → ``[N, M]``
    loss. ``model`` is the CLIP to score with (a seeded ViT-B/32 on
    ``device`` when none is given)."""

    def __init__(self, stylegan_size: int = 1024, model: Optional[CLIP] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stylegan_size = stylegan_size
        self.model = model if model is not None else CLIP(device=device, generator=generator)

    def forward(self, image: torch.Tensor, text) -> torch.Tensor:
        x = resize_nearest(image, image.shape[1] * 7)
        x = avg_pool2d(x, self.stylegan_size // 32)
        x = (x + 1) / 2
        mean, std = (torch.as_tensor(a, device=x.device) for a in (CLIP_IMAGE_MEAN,
                                                                    CLIP_IMAGE_STD))
        logits_per_image, _ = self.model((x - mean) / std, text)
        return 1 - logits_per_image / 100

"""Adaptive discriminator augmentation (ADA): the probability heuristic.

Counterpart of the JAX package's `setgan/ada.py` (reference
setgan/training_loop.py:482-486): `AdaController` moves the augmentation
probability ``p`` so that the mean sign of the real logits tracks
``target`` (0.6): after every ``interval_imgs`` images,
p += sign(E[sign(real logits)] − target) · images / (ada_kimg · 1000),
clipped to [0, 1]. It runs on the host, on one number a step. `apply_ada`
applies DiffAugment to each image with probability ``p``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .diffaugment import POLICY, apply_augment, draw_augment


@dataclasses.dataclass
class AdaState:
    p: float = 0.0
    sign_sum: float = 0.0
    count: int = 0


class AdaController:
    """Host-side p adaptation from accumulated real-logit signs."""

    def __init__(self, target: float = 0.6, interval_imgs: int = 4 * 64,
                 ada_kimg: float = 500.0):
        self.target = target
        self.interval_imgs = interval_imgs
        self.ada_kimg = ada_kimg
        self.state = AdaState()

    def update(self, real_logit_signs: float, batch_size: int) -> float:
        """Feed E[sign(real logits)] of one step; returns the current p."""
        s = self.state
        s.sign_sum += float(real_logit_signs) * batch_size
        s.count += batch_size
        if s.count >= self.interval_imgs:
            mean_sign = s.sign_sum / max(s.count, 1)
            adjust = np.sign(mean_sign - self.target) * (s.count / (self.ada_kimg * 1000))
            s.p = float(np.clip(s.p + adjust, 0.0, 1.0))
            s.sign_sum = 0.0
            s.count = 0
        return s.p


def apply_ada(images: torch.Tensor, p, generator: Optional[torch.Generator] = None,
              policy: str = POLICY, draws: Optional[Dict[str, torch.Tensor]] = None,
              keep_u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DiffAugment on each image of ``[N, H, W, C]`` with probability ``p``:
    an image is augmented where its uniform draw ``keep_u`` is below p.
    ``draws`` and ``keep_u`` are drawn from ``generator`` unless given."""
    if not isinstance(p, torch.Tensor) and p <= 0:
        return images
    n, h, w, _ = images.shape
    if draws is None:
        draws = draw_augment(n, h, w, generator, images.device, policy)
    if keep_u is None:
        keep_u = torch.rand(n, generator=generator, device=images.device)
    keep = (keep_u.to(images.device) < p)[:, None, None, None]
    return torch.where(keep, apply_augment(images, draws, policy), images)

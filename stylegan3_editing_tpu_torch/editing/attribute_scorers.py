"""Attribute, age and pose scorers for InterFaceGAN boundary training.

Counterpart of the JAX package's `editing/attribute_scorers.py` (reference
editing/interfacegan/helpers/): the DEX-VGG age estimator (VGG16 and a
101-way head, the expected age), the HopeNet pose estimator (ResNet-50 and
three 66-bin angle heads, the expectation over the bins) and the 40-attribute
CelebA classifier head on ResNet-50. Images are bilinearly resized to 224²
first. Parameters carry the flax names (``vgg``, ``trunk``, ``fc6``,
``fc_yaw``, ``head``; dense kernels ``[in, out]``), so `load_jax_variables`
fills them from a flax tree; without one the weights are random from a
seeded `torch.Generator`, which serves plumbing and parity only.

The scorers are built on the CUDA card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..models.backbones.common import Dense
from ..models.backbones.resnet import ResNet50Features
from ..models.backbones.vgg import VGG16Features
from ..ops.image import resize_bilinear

CELEBA_ATTRIBUTES = (
    "5_o_Clock_Shadow", "Arched_Eyebrows", "Attractive", "Bags_Under_Eyes",
    "Bald", "Bangs", "Big_Lips", "Big_Nose", "Black_Hair", "Blond_Hair",
    "Blurry", "Brown_Hair", "Bushy_Eyebrows", "Chubby", "Double_Chin",
    "Eyeglasses", "Goatee", "Gray_Hair", "Heavy_Makeup", "High_Cheekbones",
    "Male", "Mouth_Slightly_Open", "Mustache", "Narrow_Eyes", "No_Beard",
    "Oval_Face", "Pale_Skin", "Pointy_Nose", "Receding_Hairline",
    "Rosy_Cheeks", "Sideburns", "Smiling", "Straight_Hair", "Wavy_Hair",
    "Wearing_Earrings", "Wearing_Hat", "Wearing_Lipstick",
    "Wearing_Necklace", "Wearing_Necktie", "Young",
)


def _seeded(generator: Optional[torch.Generator]) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


class AgeEstimator(nn.Module):
    """DEX: VGG16 features → fc6, fc7 → 101-way age distribution → expected age.

    The head reads the top-left 7×7 of VGG16's 14×14 relu5_3 map, flattened
    channel-major as torch flattens NCHW, as the JAX package does (not a
    fifth max pool)."""

    def __init__(self, device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device, generator = resolve_device(device), _seeded(generator)
        self.vgg = VGG16Features(generator=generator)
        self.fc6 = Dense(512 * 7 * 7, 4096, generator=generator)
        self.fc7 = Dense(4096, 4096, generator=generator)
        self.age_head = Dense(4096, 101, generator=generator)
        self.to(device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: NHWC in [-1, 1] → expected ages ``[N]``."""
        feats = self.vgg(resize_bilinear(images, 224))[-1]  # [N, 14, 14, 512]
        h = feats[:, :7, :7, :].permute(0, 3, 1, 2).reshape(feats.shape[0], -1)
        h = torch.relu(self.fc6(h))
        h = torch.relu(self.fc7(h))
        probs = torch.softmax(self.age_head(h), dim=-1)
        return probs @ torch.arange(101, dtype=torch.float32, device=probs.device)


class PoseEstimator(nn.Module):
    """HopeNet: ResNet-50 trunk and yaw / pitch / roll bin heads → degrees
    (3° bins from −99°)."""

    def __init__(self, num_bins: int = 66, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device, generator = resolve_device(device), _seeded(generator)
        self.num_bins = num_bins
        self.trunk = ResNet50Features(generator=generator)
        for name in ("yaw", "pitch", "roll"):
            self.add_module(f"fc_{name}", Dense(2048, num_bins, generator=generator))
        self.to(device)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.trunk(resize_bilinear(images, 224))
        idx = torch.arange(self.num_bins, dtype=torch.float32, device=feats.device)
        return {name: (torch.softmax(getattr(self, f"fc_{name}")(feats), dim=-1) * idx)
                .sum(-1) * 3 - 99 for name in ("yaw", "pitch", "roll")}


class AttributeClassifier(nn.Module):
    """40-attribute CelebA classifier (an AnyCostGAN-style head on ResNet-50)."""

    def __init__(self, num_attributes: int = 40, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device, generator = resolve_device(device), _seeded(generator)
        self.trunk = ResNet50Features(generator=generator)
        self.head = Dense(2048, num_attributes, generator=generator)
        self.to(device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """→ logits ``[N, num_attributes]`` (sigmoid for probabilities)."""
        return self.head(self.trunk(resize_bilinear(images, 224)))


@torch.no_grad()
def score_latents(generator_apply: Callable, scorer_apply: Callable, ws: torch.Tensor,
                  batch_size: int = 8) -> np.ndarray:
    """Scores of the images of ``ws``, ``batch_size`` latents a render:
    ``generator_apply(ws, transform)`` → NHWC images in [-1, 1],
    ``scorer_apply(images)`` → one score per image. Returns ``[N, 1]``."""
    scores = []
    for start in range(0, ws.shape[0], batch_size):
        imgs = generator_apply(ws[start:start + batch_size], None)
        scores.append(scorer_apply(imgs).float().cpu().numpy())
    return np.concatenate(scores)[:, None]

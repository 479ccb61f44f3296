"""Image transforms (PIL/numpy, NHWC, [-1, 1]).

A copy of the JAX package's `data/transforms.py` (reference
configs/transforms_config.py `EncodeTransforms`: 256² resize, random
horizontal flip on train targets, normalize to [-1, 1]), with PIL imported
inside the functions that use it. Host-side only: the card sees ready
float32 NHWC batches.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np


def pil_to_array(im) -> np.ndarray:
    """PIL → float32 NHWC-single [-1, 1]."""
    x = np.asarray(im, dtype=np.float32) / 255.0
    if x.ndim == 2:
        x = x[:, :, None].repeat(3, axis=2)
    return x * 2.0 - 1.0


def resize(size: int) -> Callable:
    def apply(im):
        from PIL import Image

        return im.resize((size, size), Image.BILINEAR)
    return apply


def random_flip(rng: np.random.RandomState, p: float = 0.5):
    def apply(im):
        from PIL import Image

        if rng.uniform() < p:
            return im.transpose(Image.FLIP_LEFT_RIGHT)
        return im
    return apply


def compose(*fns):
    def apply(im):
        for fn in fns:
            im = fn(im)
        return im
    return apply


def encode_transforms(resolution: int = 256, seed: int = 0
                      ) -> Dict[str, Optional[Callable]]:
    """The EncodeTransforms dict: gt_train (flip), source (None), test,
    inference."""
    rng = np.random.RandomState(seed)
    return {
        "transform_gt_train": compose(resize(resolution), random_flip(rng), pil_to_array),
        "transform_source": None,
        "transform_test": compose(resize(resolution), pil_to_array),
        "transform_inference": compose(resize(resolution), pil_to_array),
    }

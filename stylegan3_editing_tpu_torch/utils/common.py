"""Transform math and image helpers.

Counterpart of the JAX package's `utils/common.py` (reference
utils/common.py): `make_transform` (rotation + translation 3×3),
`get_identity_transform` (inverted identity), `generate_random_transform`,
`tensor2im` (NHWC) and `generate_mp4`. `to_uint8` is `tensor2im` without
PIL (the card machine has none): the render paths use it. PIL is imported
inside `tensor2im` and imageio inside `generate_mp4` only.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def make_transform(translate: Tuple[float, float], angle: float) -> np.ndarray:
    """3×3 rotation+translation matrix (degrees, image-fraction translate)."""
    m = np.eye(3)
    s = np.sin(angle / 360.0 * np.pi * 2)
    c = np.cos(angle / 360.0 * np.pi * 2)
    m[0][0] = c
    m[0][1] = s
    m[0][2] = translate[0]
    m[1][0] = -s
    m[1][1] = c
    m[1][2] = translate[1]
    return m


def get_identity_transform() -> np.ndarray:
    return np.linalg.inv(make_transform((0.0, 0.0), 0.0))


def generate_random_transform(translate: float = 0.3, rotate: float = 25,
                              rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """The inverse of a random rotation and translation, drawn from ``rng``
    (numpy's global state when None)."""
    rng = rng or np.random
    angle = rng.uniform(low=-rotate, high=rotate)
    t = (rng.uniform(low=-translate, high=translate),
         rng.uniform(low=-translate, high=translate))
    return np.linalg.inv(make_transform(t, angle))


def to_uint8(var) -> np.ndarray:
    """One NHWC (or HWC) image in [-1, 1], numpy or torch → HWC uint8 numpy:
    ``clip((x + 1) / 2, 0, 1) · 255``, truncated. A tensor is scaled on its
    own device in float32 (the same roundings as numpy's) and comes back as
    uint8."""
    if hasattr(var, "detach"):
        x = var.detach().float()
        x = x[0] if x.ndim == 4 else x
        return (((x + 1) / 2).clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    arr = np.asarray(var)
    if arr.ndim == 4:
        arr = arr[0]
    arr = np.clip((arr + 1) / 2, 0, 1) * 255
    return arr.astype("uint8")


def tensor2im(var):
    """One NHWC (or HWC) image in [-1, 1], numpy or torch → PIL image."""
    from PIL import Image

    return Image.fromarray(to_uint8(var))


def generate_mp4(out_name, images: Sequence, kwargs: dict) -> None:
    """Write a list of PIL or numpy images to ``<out_name>.mp4``.

    Without an ffmpeg backend for imageio (``imageio[ffmpeg]`` not
    installed) the frames go to ``<out_name>_frames/`` as a PNG sequence:
    the same content, to be assembled elsewhere."""
    import imageio

    try:
        writer = imageio.get_writer(str(out_name) + ".mp4", **kwargs)
    except (ValueError, ImportError):
        frame_dir = Path(str(out_name) + "_frames")
        frame_dir.mkdir(parents=True, exist_ok=True)
        for i, image in enumerate(images):
            imageio.imwrite(frame_dir / f"{i:06d}.png", np.array(image))
        return
    for image in images:
        writer.append_data(np.array(image))
    writer.close()

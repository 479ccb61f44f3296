"""Temporal post-processing of per-frame inversions.

Counterpart of the JAX package's `video/post_processing.py` (reference
inversion/video/post_processing.py): fine-layer (9+) latent averaging,
the 5-tap temporal smoother `smooth_ws`, the StyleSpace `smooth_s`, and the
smoothed frames rendered through the FOV `Expander`, one frame a call (its
views one batched synthesis), each turned into uint8 on the card
(`utils.common.to_uint8`; no Pillow needed).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.common import get_identity_transform, to_uint8
from ..utils.fov_expansion import Expander


def smooth_ws(ws):
    """5-tap temporal smoother along axis 0: (x[t-2]·¼ + x[t-1]·¾ + x[t] +
    x[t+1]·¾ + x[t+2]·¼) / 3; the output has 4 fewer frames. A tensor stays
    a tensor; anything else becomes a float32 numpy array, as the JAX
    package computes it (float32 without x64)."""
    if not torch.is_tensor(ws):
        ws = np.asarray(ws, np.float32)
    out = (ws[2:-2] + 0.75 * ws[3:-1] + 0.75 * ws[1:-3]
           + 0.25 * ws[:-4] + 0.25 * ws[4:])
    return out / 3


def smooth_s(s: Sequence[Dict[str, torch.Tensor]]) -> List[Dict[str, torch.Tensor]]:
    """Smooth a per-frame list of StyleSpace dicts along the frame axis."""
    batched = {c: torch.cat([torch.as_tensor(si[c]) for si in s]) for c in s[0]}
    new_s = {c: smooth_ws(v) for c, v in batched.items()}
    frames = new_s["input"].shape[0]
    return [{c: new_s[c][i][None] for c in new_s} for i in range(frames)]


def average_fine_layers(latents: np.ndarray, from_idx: int = 9) -> np.ndarray:
    """Replace layers >= from_idx with their temporal mean (it stabilises
    texture flicker, reference post_processing.py:15)."""
    latents = np.array(latents)
    latents[:, from_idx:, :] = latents[:, from_idx:, :].mean(axis=0)
    return latents


@torch.no_grad()
def render_smoothed(generator, resolution: int, latents: np.ndarray,
                    transforms: Sequence[Optional[np.ndarray]],
                    expansion_amounts: Tuple[int, int, int, int] = (0, 0, 0, 0)
                    ) -> List[np.ndarray]:
    """Each frame's latent ``[num_ws, 512]`` and transform (None: the
    identity) → its expanded uint8 frame, one `Expander` call a frame."""
    pl, pr, pt, pb = expansion_amounts
    expander = Expander(generator, resolution)
    device = next(generator.parameters()).device
    frames = []
    for latent, trans in zip(latents, transforms):
        if trans is None:
            trans = get_identity_transform()
        canvas = expander.generate_expanded_image(
            torch.as_tensor(latent[None], device=device), np.asarray(trans, np.float32),
            pixels_left=pl, pixels_right=pr, pixels_top=pt, pixels_bottom=pb)
        frames.append(to_uint8(canvas[0]))
    return frames


def postprocess_and_smooth_inversions(
    result_latents: Dict[str, np.ndarray],
    landmarks_transforms: Optional[Sequence[np.ndarray]],
    generator,
    resolution: int,
    expansion_amounts: Tuple[int, int, int, int] = (0, 0, 0, 0),
    fine_layer_start: int = 9,
) -> List[np.ndarray]:
    """The whole smoothing pipeline → a list of expanded uint8 frames.

    ``result_latents``: frame name → final-iteration latent ``[num_ws, 512]``.
    """
    latents = np.array(list(result_latents.values()))
    latents = average_fine_layers(latents, fine_layer_start)
    smoothed_latents = smooth_ws(latents)

    if landmarks_transforms is not None:
        smoothed_transforms = smooth_ws(np.stack([np.asarray(t) for t in landmarks_transforms]))
    else:
        smoothed_transforms = np.repeat(
            get_identity_transform()[None], len(smoothed_latents), axis=0)
    return render_smoothed(generator, resolution, smoothed_latents, smoothed_transforms,
                           expansion_amounts)

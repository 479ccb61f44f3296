"""InterFaceGAN editing: linear latent-space boundary walks.

Counterpart of the JAX package's `editing/interfacegan.py` (reference
editing/interfacegan/): `FaceEditor` (latents + f·direction, optional user
transform), `train_boundary` (a linear-SVM fit; scikit-learn is imported
inside it, since it is offline tooling), and the pseudo-alignment trick for
unaligned generators (w[:, 0] = w_avg). A whole factor range renders as ONE
batched synthesis ([factors × batch] along the batch axis) instead of the
reference's per-factor loop; on the card it runs the forward kernel in its
bf16 route on the top layers (``force_fp32=False``, the generator's default).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.common import generate_random_transform

DEFAULT_DIRECTIONS = ("age", "smile", "pose", "Male")
# A code's images from a factor range match its render at the caller's batch
# within this share of max |image|, not bit for bit: the styles are normalised
# by their RMS over the whole batch (reference modulated_conv2d), so the two
# batches scale each bf16 layer's input by other constants, which demodulation
# cancels in exact arithmetic but not in their bf16 roundings. The generator
# tests' bf16 image tolerance; on SG3-R 1024 it lies between the factor-0
# renders' distance from the batch-2 render and that of the neighbouring
# factors' renders, both printed by chip_smoke.py's phase 10.
RANGE_RENDER_TOL = 2.2e-2


class FaceEditor:
    """Latent walks along attribute boundaries, batched over factors."""

    def __init__(self, generator, directions: Optional[Dict[str, np.ndarray]] = None,
                 boundaries_dir: Optional[Union[str, Path]] = None, impl: str = "auto"):
        """``generator``: the port's `Generator` (or anything exposing
        ``synthesize(ws, transform=, impl=)`` and its parameters); directions:
        name → ``[1, 512]`` (or ``[num_ws, 512]``) unit boundary normals, or
        else the InterFaceGAN ``<name>_boundary.npy`` files found in
        ``boundaries_dir``."""
        self.generator, self.impl = generator, impl
        if directions is None:
            assert boundaries_dir is not None
            directions = {}
            for name in DEFAULT_DIRECTIONS:
                p = Path(boundaries_dir) / f"{name}_boundary.npy"
                if p.exists():
                    directions[name] = np.load(p)
        device = next(generator.parameters()).device
        self.directions = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                           for k, v in directions.items()}

    def edit(
        self,
        latents: torch.Tensor,
        direction: str,
        factor: float = 1.0,
        factor_range: Optional[Tuple[int, int]] = None,
        user_transforms: Optional[np.ndarray] = None,
        apply_user_transformations: bool = False,
    ) -> Tuple[Union[torch.Tensor, List[torch.Tensor]], Union[torch.Tensor, List[torch.Tensor]]]:
        """latents ``[N, num_ws, 512]`` → (images, edit_latents).

        With ``factor_range=(a, b)``: images is a list over the factors
        ``range(a, b)`` of NHWC batches, edit_latents a list of
        ``[N, num_ws, 512]``, all from one synthesis call.
        """
        d = self.directions[direction]
        n = latents.shape[0]
        if apply_user_transformations and user_transforms is None:
            user_transforms = generate_random_transform()
        if apply_user_transformations and user_transforms is not None:
            t = torch.as_tensor(np.asarray(user_transforms, np.float32), device=latents.device)
        else:
            t = torch.eye(3, device=latents.device)
        if t.ndim == 2:
            t = t.expand(n, 3, 3)

        if factor_range is None:
            edit_latents = latents + factor * d
            images = self.generator.synthesize(edit_latents, transform=t, impl=self.impl)
            return images, edit_latents

        factors = list(range(*factor_range))
        all_latents = torch.cat([latents + f * d for f in factors])
        all_images = self.generator.synthesize(all_latents, transform=t.repeat(len(factors), 1, 1),
                                               impl=self.impl)
        images = list(all_images.split(n))
        edit_latents = list(all_latents.split(n))
        return images, edit_latents


def train_boundary(
    latent_codes: np.ndarray,
    scores: np.ndarray,
    chosen_num_or_ratio: float = 0.02,
    split_ratio: float = 0.7,
    invalid_value: Optional[float] = None,
    seed: int = 0,
) -> np.ndarray:
    """Fit a unit-norm linear-SVM boundary separating attribute extremes.

    latent_codes: [num, dim]; scores: [num, 1]. Takes the top/bottom
    `chosen_num` samples by score as positives/negatives, fits a linear SVM
    on a split, reports held-out accuracy, returns the normalized normal
    [1, dim]. (Host-side scikit-learn: boundary training is offline tooling.)
    """
    from sklearn import svm

    assert latent_codes.ndim == 2
    assert scores.shape == (latent_codes.shape[0], 1)
    rng = np.random.RandomState(seed)

    if invalid_value is not None:
        keep = scores[:, 0] != invalid_value
        latent_codes, scores = latent_codes[keep], scores[keep]

    order = np.argsort(scores[:, 0])[::-1]
    codes = latent_codes[order]
    num = codes.shape[0]
    chosen = (int(num * chosen_num_or_ratio) if chosen_num_or_ratio <= 1
              else int(chosen_num_or_ratio))
    chosen = max(min(chosen, num // 2), 1)
    train_num = int(chosen * split_ratio)

    pos_idx = rng.permutation(chosen)
    neg_idx = rng.permutation(chosen)
    pos, neg = codes[:chosen], codes[-chosen:]
    train_x = np.concatenate([pos[pos_idx[:train_num]], neg[neg_idx[:train_num]]])
    train_y = np.concatenate([np.ones(train_num), np.zeros(train_num)])
    val_x = np.concatenate([pos[pos_idx[train_num:]], neg[neg_idx[train_num:]]])
    val_y = np.concatenate([np.ones(chosen - train_num), np.zeros(chosen - train_num)])

    clf = svm.SVC(kernel="linear").fit(train_x, train_y)
    if len(val_x):
        acc = float(np.mean(clf.predict(val_x) == val_y))
        print(f"boundary validation accuracy: {acc:.4f}")

    normal = clf.coef_.reshape(1, -1).astype(np.float32)
    return normal / np.linalg.norm(normal)


def pseudo_align_latents(ws: torch.Tensor, w_avg: torch.Tensor) -> torch.Tensor:
    """Neutralize the learned input transform of an unaligned G by forcing
    w0 = w_avg (generate_latents_and_attribute_scores.py:71-73)."""
    out = ws.clone()
    out[:, 0] = w_avg
    return out

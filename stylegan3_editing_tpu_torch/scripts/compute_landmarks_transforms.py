"""Compute and cache the landmark transforms between cropped and aligned images (CLI).

The port of the JAX package's `scripts/compute_landmarks_transforms.py`
(reference prepare_data/compute_landmarks_transforms.py): for every image
of ``--raw_root``, the (angle, translation, transform, inverse) between its
crop in ``--cropped_root`` and its alignment in ``--aligned_root``, from
dlib's 68-point landmarks (`configs.model_paths["shape_predictor"]`),
written to ``<output_root>/landmarks_transforms.npy``, the name → tuple
dict that unaligned inversion and editing read. Host-side only (dlib,
Pillow, numpy).

    python -m stylegan3_editing_tpu_torch.scripts.compute_landmarks_transforms \\
        --raw_root RAW --aligned_root ALIGNED --cropped_root CROPPED --output_root OUT
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence

from ..configs import model_paths
from ..utils import alignment_utils as au
from ..utils.cli import parse_dataclass
from ..video.video_handler import LandmarksHandler


@dataclasses.dataclass
class LandmarksOptions:
    raw_root: str = "./raw_images"
    aligned_root: str = "./aligned_images"
    cropped_root: str = "./cropped_images"
    output_root: str = "./landmarks"
    force: bool = False


def run(opts: LandmarksOptions) -> dict:
    handler = LandmarksHandler(Path(opts.output_root),
                               landmark_fn=au.dlib_landmark_fn(model_paths["shape_predictor"]))
    paths = sorted(Path(opts.raw_root).iterdir())
    transforms = handler.get_landmarks_transforms(
        paths, Path(opts.cropped_root), Path(opts.aligned_root), force_computing=opts.force)
    print(f"computed {len(transforms)} transforms → {handler.path}")
    return transforms


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return run(parse_dataclass(LandmarksOptions, argv))


if __name__ == "__main__":
    main()

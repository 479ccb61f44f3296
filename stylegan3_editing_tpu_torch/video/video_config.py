"""Video pipeline configuration with edit-spec parsing.

A copy of the JAX package's `video/video_config.py` (reference
inversion/video/video_config.py): a dataclass with ``(-4_5)``-style
InterFaceGAN factor ranges and ``(4_0.13)``-style StyleCLIP alpha/beta
pairs, plus the port's ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple


class InterFaceGANEdit(NamedTuple):
    direction: str
    start: int
    end: int


class StyleCLIPEdit(NamedTuple):
    target_text: str
    alpha: float
    beta: float


@dataclasses.dataclass
class VideoConfig:
    video_path: str = ""
    output_path: str = "./experiments/video"
    checkpoint_path: Optional[str] = None
    generator_path: Optional[str] = None
    landmarks_transforms_path: Optional[str] = None
    max_frames: Optional[int] = None
    n_iters_per_batch: int = 3
    batch_size: int = 4
    fps: float = 30.0
    # Decode ReStyle iterations with the generator's bf16 layers instead of
    # the reference's force_fp32 protocol (psp3.py decode), NVIDIA's own SG3
    # inference default. The smoothed and edited renders follow the
    # generator's own policy either way.
    bf16_decode: bool = False
    device: Optional[str] = None  # cuda unless "cpu"

    # FOV expansion (left, right, top, bottom pixels).
    expansion_amounts: Tuple[int, int, int, int] = (0, 0, 0, 0)

    # Edits: directions + "(start_end)" ranges / "(alpha_beta)" pairs.
    interfacegan_directions: List[str] = dataclasses.field(default_factory=list)
    interfacegan_ranges: List[str] = dataclasses.field(default_factory=list)
    styleclip_directions: List[str] = dataclasses.field(default_factory=list)
    styleclip_alpha_betas: List[str] = dataclasses.field(default_factory=list)

    def interfacegan_edits(self) -> List[InterFaceGANEdit]:
        ranges = [self._parse_pair(r, int) for r in self.interfacegan_ranges]
        if len(self.interfacegan_directions) != len(ranges):
            raise ValueError(
                "provide one factor range per InterFaceGAN direction; got "
                f"{self.interfacegan_directions} / {self.interfacegan_ranges}")
        return [InterFaceGANEdit(d, lo, hi)
                for d, (lo, hi) in zip(self.interfacegan_directions, ranges)]

    def styleclip_edits(self) -> List[StyleCLIPEdit]:
        pairs = [self._parse_pair(p, float) for p in self.styleclip_alpha_betas]
        if len(self.styleclip_directions) != len(pairs):
            raise ValueError(
                "provide one (alpha_beta) per StyleCLIP direction; got "
                f"{self.styleclip_directions} / {self.styleclip_alpha_betas}")
        return [StyleCLIPEdit(d, a, b)
                for d, (a, b) in zip(self.styleclip_directions, pairs)]

    @staticmethod
    def _parse_pair(spec: str, cast):
        lo, hi = spec.strip("()").split("_")
        return cast(lo), cast(hi)

"""Latent and transform interpolation animations from inversion results.

The port of the JAX package's `scripts/create_inversion_animation.py`
(reference inversion/scripts/create_inversion_animation.py): between each
pair of consecutive inverted images (sorted names of ``latents.npy``) the
last iteration's latents, and the landmarks transforms when given (else
identities), are interpolated linearly over ``n_transition_frames``, every
frame rendered by the checkpoint's decoder in chunks of ``batch_size``, and
the frames go to ``<exp_dir>/animation.mp4`` (PNG frames without an ffmpeg
backend). It runs on the CUDA card unless ``--device cpu`` is given.
`render_animation` is the device part, a function of arrays.

The interpolation runs along a new leading frame axis, as the JAX CLI's
comment (``[T, num_ws, 512]``) intends; its own `lerp` broadcasts the frame
weights against the style axis and fails unless ``n_transition_frames`` is 1.

    python -m stylegan3_editing_tpu_torch.scripts.create_inversion_animation \\
        --checkpoint_path CKPT --latents_path latents.npy --exp_dir OUT [--device cpu]
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.sg3 import Generator
from ..utils.cli import parse_dataclass
from ..utils.common import generate_mp4, to_uint8
from ..utils.inference_utils import load_encoder


@dataclasses.dataclass
class AnimationOptions:
    """Render an interpolation video between inverted images."""

    exp_dir: str = "./experiments/animation"
    checkpoint_path: Optional[str] = None
    latents_path: str = "./latents.npy"
    landmarks_transforms_path: Optional[str] = None
    n_transition_frames: int = 25
    fps: float = 25.0
    batch_size: int = 8
    n_images: Optional[int] = None
    device: Optional[str] = None  # cuda unless "cpu"


def lerp(a: np.ndarray, b: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """``[T, *a.shape]``: a·(1 − t) + b·t for each t of ``ts``."""
    t = ts.reshape((-1,) + (1,) * np.ndim(a))
    return a[None] * (1 - t) + b[None] * t


def render_animation(decoder: Generator, latents: Sequence[np.ndarray],
                     transforms: Optional[Sequence[np.ndarray]] = None,
                     n_transition_frames: int = 25, batch_size: int = 8) -> List[np.ndarray]:
    """Frames (HWC uint8) between consecutive ``latents`` (``[num_ws, w_dim]``
    each), with ``transforms`` (``[3, 3]`` each) interpolated alike, else
    identities; every chunk of ``batch_size`` frames is one ``synthesize``
    on the decoder's device, in its dtype policy."""
    device = next(decoder.parameters()).device
    ts = np.linspace(0, 1, n_transition_frames, dtype=np.float32)
    frames: List[np.ndarray] = []
    for i in range(len(latents) - 1):
        ws = lerp(np.asarray(latents[i], np.float32), np.asarray(latents[i + 1], np.float32), ts)
        if transforms is not None:
            t = lerp(np.asarray(transforms[i], np.float32),
                     np.asarray(transforms[i + 1], np.float32), ts)
        else:
            t = np.repeat(np.eye(3, dtype=np.float32)[None], len(ts), axis=0)
        ws_t = torch.from_numpy(np.ascontiguousarray(ws, np.float32)).to(device)
        t_t = torch.from_numpy(np.ascontiguousarray(t, np.float32)).to(device)
        for start in range(0, len(ts), batch_size):
            with torch.inference_mode():
                imgs = decoder.synthesize(ws_t[start:start + batch_size],
                                          transform=t_t[start:start + batch_size])
            frames.extend(to_uint8(im) for im in imgs)
    return frames


def run(opts: AnimationOptions) -> List[np.ndarray]:
    device = resolve_device(opts.device)
    out = Path(opts.exp_dir)
    out.mkdir(parents=True, exist_ok=True)
    latents = np.load(opts.latents_path, allow_pickle=True).item()
    names = sorted(latents)[:opts.n_images]
    transforms = None
    if opts.landmarks_transforms_path:
        saved = np.load(opts.landmarks_transforms_path, allow_pickle=True).item()
        transforms = [np.asarray(saved[n][-1], np.float32) for n in names]

    model, _ = load_encoder(opts.checkpoint_path, device=device)
    frames = render_animation(model.decoder, [np.asarray(latents[n])[-1] for n in names],
                              transforms, opts.n_transition_frames, opts.batch_size)
    generate_mp4(out / "animation", frames, {"fps": opts.fps})
    print(f"wrote {len(frames)} frames to {out / 'animation'}.mp4")
    return frames


def main(argv: Optional[Sequence[str]] = None) -> List[np.ndarray]:
    return run(parse_dataclass(AnimationOptions, argv))


if __name__ == "__main__":
    main()

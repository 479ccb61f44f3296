"""Latent-space sampling and interpolation helpers.

Counterpart of the JAX package's `utils/gen_utils.py` (reference
models/styleganxl/torch_utils/gen_utils.py: `get_w_from_seed`, `lerp`,
`slerp` and the interpolation video). The whole trajectory synthesizes in
batched chunks instead of one frame at a time. The style RMS of the
synthesis is taken over the batch, so the chunking and the padding (batches
of ``batch``, the last frame repeated) are the JAX package's: the same
chunks give the same frames.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

ArrayLike = Union[torch.Tensor, np.ndarray, float, Sequence[float]]


def get_w_from_seed(model, seed: Union[int, torch.Generator], batch: int = 1,
                    truncation_psi: float = 1.0) -> torch.Tensor:
    """z drawn from ``seed`` (an int, or a `torch.Generator` on the CPU)
    through the mapping network → W+ latents ``[batch, num_ws, w_dim]``."""
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
    z = torch.randn((batch, model.cfg.z_dim), generator=gen)
    device = next(model.parameters()).device
    return model.map(z.to(device), truncation_psi=truncation_psi)


def _as_tensor(a: ArrayLike, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                           device=None if like is None else like.device)


def _path_weight(t: ArrayLike, a: torch.Tensor) -> torch.Tensor:
    """t (a scalar or ``[T]``) shaped to broadcast against ``a[None]``."""
    t = _as_tensor(t, a).to(a.dtype)
    while t.ndim < a.ndim + 1:
        t = t[..., None]
    return t


def lerp(a: ArrayLike, b: ArrayLike, t: ArrayLike) -> torch.Tensor:
    """Linear interpolation; ``t`` may be a scalar or ``[T]`` (a path)."""
    a, b = _as_tensor(a), _as_tensor(b)
    t = _path_weight(t, a)
    return a[None] * (1 - t) + b[None] * t


def slerp(a: ArrayLike, b: ArrayLike, t: ArrayLike, eps: float = 1e-7) -> torch.Tensor:
    """Spherical interpolation along the great circle through a and b;
    near-parallel inputs fall back to lerp."""
    a, b = _as_tensor(a), _as_tensor(b)
    t = _path_weight(t, a)
    an = a / (torch.linalg.norm(a, dim=-1, keepdim=True) + eps)
    bn = b / (torch.linalg.norm(b, dim=-1, keepdim=True) + eps)
    dot = torch.clamp((an * bn).sum(-1, keepdim=True), -1 + eps, 1 - eps)
    omega = torch.arccos(dot)
    so = torch.sin(omega)
    safe = so.abs() > eps
    w_a = torch.where(safe, torch.sin((1 - t) * omega) / so, 1 - t)
    w_b = torch.where(safe, torch.sin(t * omega) / so, t)
    return a[None] * w_a + b[None] * w_b


def interpolation_path(ws_keyframes: torch.Tensor, frames_per_segment: int,
                       mode: str = "lerp") -> torch.Tensor:
    """``[K, ...]`` keyframes → ``[(K-1)·F + 1, ...]``: each segment open at
    its end, the final keyframe appended."""
    assert mode in ("lerp", "slerp")
    fn = lerp if mode == "lerp" else slerp
    ws_keyframes = _as_tensor(ws_keyframes)
    t = torch.arange(frames_per_segment, device=ws_keyframes.device) / frames_per_segment
    segs = [fn(ws_keyframes[i], ws_keyframes[i + 1], t)
            for i in range(ws_keyframes.shape[0] - 1)]
    return torch.cat(segs + [ws_keyframes[-1:]], dim=0)


@torch.no_grad()
def interpolation_video(model, seeds: Sequence[int], out_path, frames_per_segment: int = 30,
                        fps: int = 30, truncation_psi: float = 0.7, mode: str = "slerp",
                        batch: int = 8, transform: Optional[torch.Tensor] = None) -> int:
    """Render a seed-to-seed interpolation video (`common.generate_mp4`);
    returns the frame count."""
    from .common import generate_mp4, tensor2im

    ws = torch.cat([get_w_from_seed(model, s, truncation_psi=truncation_psi) for s in seeds])
    path = interpolation_path(ws, frames_per_segment, mode=mode)
    pad = (-len(path)) % batch
    padded = torch.cat([path, path[-1:].expand(pad, *path.shape[1:])]) if pad else path
    frames = []
    for i in range(0, len(padded), batch):
        imgs = model.synthesize(padded[i:i + batch], transform=transform)
        frames.extend(tensor2im(img) for img in imgs)
    frames = frames[:len(path)]
    generate_mp4(out_path, frames, {"fps": fps})
    return len(frames)

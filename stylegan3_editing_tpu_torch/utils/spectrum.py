"""FFT power spectra of generated images (the aliasing diagnostic).

Counterpart of the JAX package's `utils/spectrum.py` (the reference's
`utils_spectrum.py`: `roll_quadrants`, `batch_fft`, `azimuthal_average` and
the spectrum statistics): alias-free synthesis shows no spurious
high-frequency energy. The azimuthal bins are the JAX package's: each
pixel goes to the bin of its distance from the centre, rounded half to
even (in float32), and a bin's sum is one ``index_add_`` over them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def roll_quadrants(data: torch.Tensor, backwards: bool = False) -> torch.Tensor:
    """Centre the DC term of ``[N, H, W]`` Fourier transforms."""
    if data.ndim != 3:
        raise ValueError(f"expected [N, H, W], got {tuple(data.shape)}")
    shifts = [s // 2 for s in data.shape[1:]]
    if backwards:
        shifts = [-s for s in shifts]
    return torch.roll(data, shifts, dims=(1, 2))


def batch_fft(data: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """2-D FFT of each of ``[N, H, W]`` images (``norm="ortho"`` when
    ``normalize``, else unscaled)."""
    if data.ndim != 3:
        raise ValueError(f"expected [N, H, W], got {tuple(data.shape)}")
    return torch.fft.fftn(data, dim=(1, 2), norm="ortho" if normalize else "backward")


def azimuthal_average(power: torch.Tensor,
                      center: Optional[Tuple[float, float]] = None) -> torch.Tensor:
    """Radial profile of centred ``[N, H, W]`` power spectra → ``[N,
    n_radii]``: the mean over each bin's pixels (an empty bin reads 0)."""
    if power.ndim != 3:
        raise ValueError(f"expected [N, H, W], got {tuple(power.shape)}")
    n, h, w = power.shape
    cy = (h - 1) / 2 if center is None else center[0]
    cx = (w - 1) / 2 if center is None else center[1]
    dev = power.device
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None] - np.float32(cy)
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :] - np.float32(cx)
    r_idx = torch.round(torch.sqrt(yy * yy + xx * xx)).to(torch.int64).reshape(-1)
    n_bins = int(np.rint(np.hypot(max(cy, h - 1 - cy), max(cx, w - 1 - cx)))) + 1
    flat = power.reshape(n, -1)
    counts = torch.zeros(n_bins, device=dev, dtype=flat.dtype).index_add_(
        0, r_idx, torch.ones_like(r_idx, dtype=flat.dtype))
    sums = torch.zeros((n, n_bins), device=dev, dtype=flat.dtype).index_add_(1, r_idx, flat)
    return sums / counts.clamp(min=1.0)


def power_spectrum(images: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """``[N, H, W, C]`` (the channel mean is taken) or ``[N, H, W]`` images →
    centred ``[N, H, W]`` power."""
    if images.ndim == 4:
        images = images.mean(dim=-1)
    return roll_quadrants(batch_fft(images, normalize=normalize).abs() ** 2)


def spectrum_stats(images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The mean and the (population) std of the radial power profile over a
    batch."""
    prof = azimuthal_average(power_spectrum(images))
    return {"mean": prof.mean(dim=0), "std": prof.std(dim=0, unbiased=False)}

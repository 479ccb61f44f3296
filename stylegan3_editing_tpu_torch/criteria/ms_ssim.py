"""SSIM and multi-scale SSIM over NHWC images.

Counterpart of the JAX package's `criteria/ms_ssim.py` (reference
criteria/ms_ssim.py, the jorge-pessoa variant): an 11-tap σ = 1.5 Gaussian
window (shrunk to the image when it is smaller), VALID windows, five scales
with the classic weights, the contrast-sensitivity product, optional relu or
simple normalisation, and the same dynamic L when ``val_range`` is None
(``max > 128`` → 255 else 1, ``min < -0.5`` → -1 else 0), chosen on the
device without a host sync. The windowed means are one depthwise conv
through `device.conv2d` (full fp32 on the card).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..device import conv2d
from ..ops.image import avg_pool2d

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def gaussian_window(window_size: int, sigma: float, device=None) -> torch.Tensor:
    """The 2-D window, made on ``device`` (in float64, then rounded to
    float32) so that no host copy waits for the work queued before it."""
    x = torch.arange(window_size, dtype=torch.float64, device=device) - window_size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g).float()


def _windowed_mean(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID conv of NHWC ``x`` with the 2-D ``window``."""
    c = x.shape[-1]
    w = window.to(x.dtype)[None, None].expand(c, 1, -1, -1)
    return conv2d(x.permute(0, 3, 1, 2), w, groups=c).permute(0, 2, 3, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True, full: bool = False,
         val_range: Optional[float] = None):
    """SSIM over NHWC images; ``val_range=None`` infers L from img1's range.
    ``full`` also returns the contrast-sensitivity term."""
    if val_range is None:
        level = torch.where(img1.max() > 128, 255.0, 1.0) - torch.where(
            img1.min() < -0.5, -1.0, 0.0)
    else:
        level = float(val_range)

    h, w = img1.shape[1], img1.shape[2]
    window = gaussian_window(min(window_size, h, w), 1.5, img1.device)

    mu1 = _windowed_mean(img1, window)
    mu2 = _windowed_mean(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _windowed_mean(img1 * img1, window) - mu1_sq
    sigma2_sq = _windowed_mean(img2 * img2, window) - mu2_sq
    sigma12 = _windowed_mean(img1 * img2, window) - mu1_mu2

    c1 = (0.01 * level) ** 2
    c2 = (0.03 * level) ** 2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma1_sq + sigma2_sq + c2
    cs_map = v1 / v2
    ssim_map = ((2 * mu1_mu2 + c1) * v1) / ((mu1_sq + mu2_sq + c1) * v2)

    if size_average:
        ret, cs = ssim_map.mean(), cs_map.mean()
    else:
        ret, cs = ssim_map.mean((1, 2, 3)), cs_map.mean((1, 2, 3))
    return (ret, cs) if full else ret


def msssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
           size_average: bool = True, val_range: Optional[float] = None,
           normalize=None) -> torch.Tensor:
    """Multi-scale SSIM over NHWC images (5 scales, 2× average pools between
    them). ``normalize``: None, ``"relu"`` or ``"simple"``/True. Without it a
    negative contrast term raised to its weight gives NaN, as in the
    reference."""
    ssims, mcs = [], []
    for _ in MSSSIM_WEIGHTS:
        sim, cs = ssim(img1, img2, window_size=window_size, size_average=size_average,
                       full=True, val_range=val_range)
        if normalize == "relu":
            sim, cs = F.relu(sim), F.relu(cs)
        ssims.append(sim)
        mcs.append(cs)
        img1, img2 = avg_pool2d(img1, 2), avg_pool2d(img2, 2)

    ssims, mcs = torch.stack(ssims), torch.stack(mcs)
    if normalize in ("simple", True):
        ssims, mcs = (ssims + 1) / 2, (mcs + 1) / 2
    # The weights stay Python floats: no tensor is copied from the host.
    pow_mcs = torch.stack([m ** wt for m, wt in zip(mcs[:-1], MSSSIM_WEIGHTS)])
    return torch.prod(pow_mcs, dim=0) * ssims[-1] ** MSSSIM_WEIGHTS[-1]

"""Pad → zero-upsample → FIR filter → downsample for NHWC image batches.

Plain PyTorch version of the JAX package's `ops/upfirdn2d.py` (and of the
reference `_upfirdn2d_ref`):

1. zero-stuff each pixel by the upsampling factor,
2. pad (negative = crop) w.r.t. the upsampled grid,
3. convolve with the FIR filter (correlation if ``flip_filter``),
4. keep every ``down``-th pixel.

Public tensors are NHWC; inside, the depthwise `F.conv2d` runs on an NCHW
view, in full fp32 (`device.conv2d`). A 1-D filter runs as two 1-D passes
(width, then height), each scaled by ``gain ** 0.5``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..device import conv2d

Scaling = Union[int, Sequence[int]]
Padding = Union[int, Sequence[int]]
Filter = Optional[Union[np.ndarray, torch.Tensor]]


def parse_scaling(scaling: Scaling) -> tuple[int, int]:
    """Normalize an int or (x, y) pair of scaling factors."""
    if isinstance(scaling, (int, np.integer)):
        scaling = [scaling, scaling]
    sx, sy = (int(s) for s in scaling)
    assert sx >= 1 and sy >= 1
    return sx, sy


def parse_padding(padding: Padding) -> tuple[int, int, int, int]:
    """Normalize an int, (x, y), or (x0, x1, y0, y1) padding spec."""
    if isinstance(padding, (int, np.integer)):
        padding = [padding, padding]
    padding = [int(p) for p in padding]
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    px0, px1, py0, py1 = padding
    return px0, px1, py0, py1


def filter_size(f: Filter) -> tuple[int, int]:
    """(width, height) of a 1-D, 2-D or ``None`` filter."""
    if f is None:
        return 1, 1
    assert 1 <= f.ndim <= 2
    return int(f.shape[-1]), int(f.shape[0])


def _depthwise_conv(x: torch.Tensor, f: torch.Tensor,
                    stride: tuple[int, int]) -> torch.Tensor:
    """Valid depthwise correlation of NCHW ``x`` with a shared 2-D ``f``."""
    c = x.shape[1]
    w = f[None, None].expand(c, 1, *f.shape)
    return conv2d(x, w, stride=stride, groups=c)


def upfirdn2d(
    x: torch.Tensor,
    f: Filter,
    up: Scaling = 1,
    down: Scaling = 1,
    padding: Padding = 0,
    flip_filter: bool = False,
    gain: float = 1,
) -> torch.Tensor:
    """Pad, upsample, FIR-filter, and downsample a batch of NHWC images.

    Args:
        x: ``[N, H, W, C]`` input.
        f: FIR filter — ``[fh, fw]`` (non-separable), ``[taps]``
           (separable), or ``None`` (identity).
        up / down: integer resampling factors, scalar or per-axis ``(x, y)``.
        padding: pixels w.r.t. the upsampled image; scalar, ``(x, y)``, or
            ``(x0, x1, y0, y1)``. Negative values crop.
        flip_filter: False = convolution, True = correlation.
        gain: overall magnitude scale.
    """
    assert x.ndim == 4, "expected NHWC input"
    upx, upy = parse_scaling(up)
    downx, downy = parse_scaling(down)
    px0, px1, py0, py1 = parse_padding(padding)
    n, in_h, in_w, c = x.shape
    fw, fh = filter_size(f)
    assert in_w * upx + px0 + px1 >= fw and in_h * upy + py0 + py1 >= fh, (
        "upsampled buffer smaller than the filter")

    x = x.permute(0, 3, 1, 2)
    if upx > 1 or upy > 1:
        x = x.reshape(n, c, in_h, 1, in_w, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(n, c, in_h * upy, in_w * upx)
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0):x.shape[2] - max(-py1, 0),
          max(-px0, 0):x.shape[3] - max(-px1, 0)]

    if f is None:
        f = torch.ones((1, 1), dtype=torch.float32)
    if isinstance(f, np.ndarray):
        f = np.ascontiguousarray(f)
    f = torch.as_tensor(f, dtype=torch.float32, device=x.device)
    f = f * (gain ** (f.ndim / 2))
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    f = f.to(x.dtype)

    if f.ndim == 2:
        x = _depthwise_conv(x, f, (downy, downx))
    else:
        x = _depthwise_conv(x, f[None, :], (1, downx))
        x = _depthwise_conv(x, f[:, None], (downy, 1))
    return x.permute(0, 2, 3, 1).contiguous()


def filter2d(x, f, padding: Padding = 0, flip_filter: bool = False, gain: float = 1):
    """FIR-filter NHWC images; output is same-size by default."""
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    p = [
        px0 + fw // 2,
        px1 + (fw - 1) // 2,
        py0 + fh // 2,
        py1 + (fh - 1) // 2,
    ]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up: Scaling = 2, padding: Padding = 0,
               flip_filter: bool = False, gain: float = 1):
    """Upsample NHWC images by ``up`` with FIR interpolation."""
    upx, upy = parse_scaling(up)
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    p = [
        px0 + (fw + upx - 1) // 2,
        px1 + (fw - upx) // 2,
        py0 + (fh + upy - 1) // 2,
        py1 + (fh - upy) // 2,
    ]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def downsample2d(x, f, down: Scaling = 2, padding: Padding = 0,
                 flip_filter: bool = False, gain: float = 1):
    """Downsample NHWC images by ``down`` with FIR anti-aliasing."""
    downx, downy = parse_scaling(down)
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = filter_size(f)
    p = [
        px0 + (fw - downx + 1) // 2,
        px1 + (fw - downx) // 2,
        py0 + (fh - downy + 1) // 2,
        py1 + (fh - downy) // 2,
    ]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)

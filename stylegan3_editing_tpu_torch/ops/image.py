"""Image-space helpers of the port (NHWC at the public functions).

Counterparts of the JAX package's `ops/image.py`; what the ported criteria,
backbones and scorers need.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

Size = Union[int, Sequence[int]]


def _hw(size: Size):
    return (size, size) if isinstance(size, int) else tuple(size)


def max_pool2d(x: torch.Tensor, window: int, stride: int, padding: int = 0,
               ceil_mode: bool = False) -> torch.Tensor:
    """Max pooling over NHWC with torch ``MaxPool2d`` semantics; ``padding``
    pads each side with -inf (so a padded cell never wins). ``ceil_mode``
    keeps the last partial window, less one that would start in the right
    padding (torch's rule, which the JAX package reproduces with an extra
    -inf pad)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding, ceil_mode=ceil_mode)
    return y.permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, window: int, stride: Optional[int] = None) -> torch.Tensor:
    """Average pooling without padding (VALID) over NHWC; stride defaults to
    the window."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride or window)
    return y.permute(0, 2, 3, 1)


def resize_nearest(x: torch.Tensor, size: Size) -> torch.Tensor:
    """Nearest-neighbour resize of NHWC images as torch's default
    ``F.interpolate``: source index ``floor(i · in / out)``, the product
    taken in float32 as the JAX package takes it, then two gathers."""
    oh, ow = _hw(size)
    h, w = x.shape[1], x.shape[2]
    rows = np.floor(np.arange(oh, dtype=np.float32) * np.float32(h / oh)).astype(np.int64)
    cols = np.floor(np.arange(ow, dtype=np.float32) * np.float32(w / ow)).astype(np.int64)
    x = x.index_select(1, torch.from_numpy(rows).to(x.device))
    return x.index_select(2, torch.from_numpy(cols).to(x.device))


def resize_bilinear(x: torch.Tensor, size: Size) -> torch.Tensor:
    """Bilinear resize of NHWC images with half-pixel centres and no
    antialiasing: `jax.image.resize(..., "linear", antialias=False)` of the
    JAX package, which is ``F.interpolate(mode="bilinear",
    align_corners=False)`` (an edge sample's weight outside the image goes
    to the edge pixel in both)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=_hw(size), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def adaptive_avg_pool2d(x: torch.Tensor,
                        output_size: Union[int, Sequence[int]]) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d`` over NHWC images: output cell i averages
    input rows ``floor(i·H/oh)`` to ``ceil((i+1)·H/oh)`` (and so for columns),
    so sizes that do not divide (and pooling up) keep torch's windows. The
    JAX package leaves this to XLA; here it is PyTorch's own op on the NCHW
    view. The input comes back unchanged when it already has the size."""
    oh, ow = (output_size, output_size) if isinstance(output_size, int) else output_size
    if tuple(x.shape[1:3]) == (oh, ow):
        return x
    y = F.adaptive_avg_pool2d(x.float().permute(0, 3, 1, 2), (oh, ow))
    return y.permute(0, 2, 3, 1).to(x.dtype)

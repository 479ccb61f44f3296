"""Image-space helpers of the port (NHWC at the public functions).

Counterparts of the JAX package's `ops/image.py`; only what the ported
criteria and encoders need so far.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Unpadded max pooling over NHWC with torch ``MaxPool2d`` semantics."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
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

"""2-D convolution with fused up/downsampling over NHWC images.

Counterpart of the JAX package's `ops/conv2d_resample.py` (reference
torch_utils/ops/conv2d_resample.py): the padding is applied once, with
respect to the upsampled grid, and the same six paths are taken:

1. 1×1 kernel, down only: FIR-downsample, then the conv;
2. 1×1 kernel, up only: the conv, then FIR-upsample;
3. down only: FIR-filter, then a strided conv;
4. up (and maybe down): a transposed strided conv, FIR-filter, then
   FIR-downsample if ``down > 1``;
5. neither, with symmetric non-negative padding: one padded conv;
6. otherwise: `upfirdn2d` (padding, upsampling), the conv, then
   FIR-downsample.

The FIR passes go through the port's `upfirdn2d`, the convs through
`device.conv2d` and `device.conv_transpose2d` (cuDNN in full fp32).
Weights are HWIO ``[kh, kw, in_channels // groups, out_channels]``.
"""

from __future__ import annotations

from typing import List, Union

import torch

from ..device import conv2d, conv_transpose2d
from .upfirdn2d import Filter, Padding, filter_size, parse_padding, upfirdn2d


def _conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
            padding: Union[int, List[int]] = 0, groups: int = 1,
            flip_weight: bool = True) -> torch.Tensor:
    """Grouped NHWC conv; ``flip_weight=True`` is a correlation (`F.conv2d`).
    ``padding``: an int or ``[py, px]``."""
    if not flip_weight and (w.shape[0] > 1 or w.shape[1] > 1):
        w = w.flip(0, 1)
    y = conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype), stride=stride,
               padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def _conv_transpose2d(x: torch.Tensor, w: torch.Tensor, stride: int, padding: List[int],
                      groups: int = 1, flip_weight: bool = True) -> torch.Tensor:
    """The JAX package's `_conv_transpose2d`: a grouped correlation of the
    ``stride``-dilated input, padded by ``k - 1 - padding``, with ``w``
    flipped when ``flip_weight``. That is `F.conv_transpose2d` with padding
    ``padding`` and ``w`` flipped when ``flip_weight`` is False; the HWIO
    kernel goes to ``[in, out // groups, kh, kw]`` group by group."""
    kh, kw, in_per_group, out_channels = w.shape
    if not flip_weight:
        w = w.flip(0, 1)
    wt = w.reshape(kh, kw, in_per_group, groups, out_channels // groups)
    wt = wt.permute(3, 2, 4, 0, 1).reshape(groups * in_per_group, out_channels // groups, kh, kw)
    y = conv_transpose2d(x.permute(0, 3, 1, 2), wt.to(x.dtype), stride=stride, padding=padding,
                         groups=groups)
    return y.permute(0, 2, 3, 1)


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f: Filter = None, up: int = 1,
                    down: int = 1, padding: Padding = 0, groups: int = 1,
                    flip_weight: bool = True, flip_filter: bool = False) -> torch.Tensor:
    """Conv with optional FIR-filtered up/downsampling, the padding applied
    once with respect to the upsampled image.

    Args:
        x: ``[N, H, W, C]``.
        w: ``[kh, kw, in_channels // groups, out_channels]`` (HWIO).
        f: a `setup_filter`-prepared FIR (1-D separable or 2-D), or None.
        up / down: integer resampling factors.
        padding: with respect to the upsampled image; int, ``(x, y)`` or
            ``(x0, x1, y0, y1)``.
        groups: feature groups.
        flip_weight: False = convolution, True = correlation (default).
        flip_filter: False = convolution, True = correlation.
    """
    assert x.ndim == 4 and w.ndim == 4
    assert isinstance(up, int) and up >= 1 and isinstance(down, int) and down >= 1
    kh, kw = int(w.shape[0]), int(w.shape[1])
    fw, fh = filter_size(f)
    px0, px1, py0, py1 = parse_padding(padding)

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    if kw == 1 and kh == 1 and down > 1 and up == 1:
        x = upfirdn2d(x, f, down=down, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return _conv2d(x, w, groups=groups, flip_weight=flip_weight)

    if kw == 1 and kh == 1 and up > 1 and down == 1:
        x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        return upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                         flip_filter=flip_filter)

    if down > 1 and up == 1:
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return _conv2d(x, w, stride=down, groups=groups, flip_weight=flip_weight)

    if up > 1:
        px0 -= kw - 1
        px1 -= kw - up
        py0 -= kh - 1
        py1 -= kh - up
        pxt = max(min(-px0, -px1), 0)
        pyt = max(min(-py0, -py1), 0)
        x = _conv_transpose2d(x, w, stride=up, padding=[pyt, pxt], groups=groups,
                              flip_weight=not flip_weight)
        x = upfirdn2d(x, f, padding=[px0 + pxt, px1 + pxt, py0 + pyt, py1 + pyt],
                      gain=up ** 2, flip_filter=flip_filter)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    if up == 1 and down == 1 and px0 == px1 and py0 == py1 and px0 >= 0 and py0 >= 0:
        return _conv2d(x, w, padding=[py0, px0], groups=groups, flip_weight=flip_weight)

    x = upfirdn2d(x, f if up > 1 else None, up=up, padding=[px0, px1, py0, py1],
                  gain=up ** 2, flip_filter=flip_filter)
    x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x

"""Filtered leaky ReLU: bias → up-FIR → leaky-ReLU·gain → clamp → down-FIR.

The hot op of alias-free synthesis. Two implementations with one meaning:

- the plain composition of `bias_act` and `upfirdn2d` (the JAX package's
  `impl="xla"` path, `ops/filtered_lrelu.py`), used for CPU tensors, for
  configurations outside the kernel's envelope (the filterless ToRGB layer)
  and when the caller passes ``impl="ref"``;
- the hand-written CUDA kernel (`flrelu_cuda.py`) for CUDA tensors inside
  its envelope. It launches or raises; it never falls back.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import flrelu_cuda
from .bias_act import bias_act
from .upfirdn2d import Filter, filter_size, parse_padding, upfirdn2d


def choose_impl(device_type: str, fu: Filter, fd: Filter, up: int, down: int,
                flip_filter: bool = False, impl: str = "auto") -> str:
    """'cuda' (the kernel) or 'ref' (the plain composition).

    CPU tensors and ``impl="ref"`` take the plain version. CUDA tensors
    inside the kernel's envelope take the kernel; outside it (ToRGB: up =
    down = 1, no filters) the composition, as in the JAX package.
    """
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {device_type!r}")
    if impl == "ref" or device_type == "cpu":
        return "ref"
    return "cuda" if flrelu_cuda.in_envelope(fu, fd, up, down, flip_filter) else "ref"


def filtered_lrelu_ref(
    x: torch.Tensor,
    fu: Filter = None,
    fd: Filter = None,
    b: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding=0,
    gain: float = math.sqrt(2),
    slope: float = 0.2,
    clamp: Optional[float] = None,
    flip_filter: bool = False,
) -> torch.Tensor:
    """The plain composition (reference `_filtered_lrelu_ref` semantics)."""
    px0, px1, py0, py1 = parse_padding(padding)
    x = bias_act(x=x, b=b)
    x = upfirdn2d(x=x, f=fu, up=up, padding=[px0, px1, py0, py1],
                  gain=up ** 2, flip_filter=flip_filter)
    x = bias_act(x=x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x=x, f=fd, down=down, flip_filter=flip_filter)


def filtered_lrelu(
    x: torch.Tensor,
    fu: Filter = None,
    fd: Filter = None,
    b: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding=0,
    gain: float = math.sqrt(2),
    slope: float = 0.2,
    clamp: Optional[float] = None,
    flip_filter: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """Fused filtered leaky ReLU over NHWC images.

    Args:
        x: ``[N, H, W, C]`` input.
        fu / fd: up/downsampling FIR filters (1-D separable, 2-D, or None).
        b: per-channel bias ``[C]`` or None.
        up / down: integer resampling factors.
        padding: w.r.t. the upsampled image; scalar / (x, y) / (x0, x1, y0, y1).
        gain: scale applied with the leaky ReLU (default sqrt(2)).
        slope: negative-side slope of the leaky ReLU.
        clamp: clamp magnitude after activation (None = disabled).
        flip_filter: False = convolution, True = correlation.
        impl: 'auto' (see `choose_impl`) or 'ref' (always the composition).

    Returns:
        ``[N, out_h, out_w, C]`` in x's dtype with
        ``out = (in*up + pad0 + pad1 - (fu_taps-1) - (fd_taps-1) + (down-1)) // down``.
    """
    assert x.ndim == 4, "expected NHWC input"
    assert isinstance(up, int) and up >= 1
    assert isinstance(down, int) and down >= 1
    assert gain > 0 and slope >= 0
    assert clamp is None or clamp >= 0
    px0, px1, py0, py1 = parse_padding(padding)
    fu_w, fu_h = filter_size(fu)
    fd_w, fd_h = filter_size(fd)
    batch, in_h, in_w, channels = x.shape
    out_w = (in_w * up + (px0 + px1) - (fu_w - 1) - (fd_w - 1) + (down - 1)) // down
    out_h = (in_h * up + (py0 + py1) - (fu_h - 1) - (fd_h - 1) + (down - 1)) // down

    if choose_impl(x.device.type, fu, fd, up, down, flip_filter, impl) == "cuda":
        y = flrelu_cuda.filtered_lrelu_cuda(
            x, fu, fd, b, up, (px0, px1, py0, py1),
            gain=gain, slope=slope, clamp=clamp)
    else:
        y = filtered_lrelu_ref(x, fu, fd, b, up, down, (px0, px1, py0, py1),
                               gain, slope, clamp, flip_filter)
    assert y.shape == (batch, out_h, out_w, channels)
    assert y.dtype == x.dtype
    return y

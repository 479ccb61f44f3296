"""Filtered leaky ReLU: bias → up-FIR → leaky-ReLU·gain → clamp → down-FIR.

The hot op of alias-free synthesis. Two implementations with one meaning:

- the plain composition of `bias_act` and `upfirdn2d` (the JAX package's
  `impl="xla"` path, `ops/filtered_lrelu.py`), used for CPU tensors, for
  configurations outside the kernel's envelope (the filterless ToRGB layer)
  and when the caller passes ``impl="ref"``;
- the hand-written CUDA kernels (`flrelu_cuda.py`) for CUDA tensors inside
  their envelope, through `FusedFilteredLrelu`: the forward kernel, and the
  backward kernel under autograd. They launch or raise; they never fall back.

`filtered_lrelu_bwd_ref` is the plain version of the backward kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..device import kernel_or_plain
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
    if kernel_or_plain(device_type, impl) == "ref":
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


def filtered_lrelu_bwd_ref(
    dy: torch.Tensor,
    x: torch.Tensor,
    fu,
    fd,
    b: Optional[torch.Tensor],
    up: int,
    padding,
    gain: float = math.sqrt(2),
    slope: float = 0.2,
    clamp: Optional[float] = None,
) -> torch.Tensor:
    """dx of the filtered lrelu (down 2), computed as the backward kernel does.

    In fp32, on the backward frame of the up grid (the forward's, shifted by
    ``tu − 1 − p0``): dy up-sampled ×2 by correlation with fd on the
    backward padding; times act'(A)·gain·up², zero where
    |lrelu(A)·gain| > clamp, with A = up-FIR(x + b) recomputed (bias on real
    pixels only); then a stride-``up`` correlation with fu. Returns dx in
    x's dtype. db is ``dx.float().sum((0, 1, 2))``.
    """
    px0, px1, py0, py1 = parse_padding(padding)
    tu = len(fu)
    td_w, td_h = filter_size(fd)
    (_, xh, xw, _), (_, yh, yw, _) = x.shape, dy.shape
    ppx = flrelu_cuda.backward_padding(xw, yw, up, px0, tu, td_w)
    ppy = flrelu_cuda.backward_padding(xh, yh, up, py0, tu, td_h)
    g = upfirdn2d(dy.float(), fd, up=2, padding=[*ppx, *ppy], flip_filter=True)
    a = upfirdn2d(bias_act(x.float(), None if b is None else b.float()), fu, up=up,
                  padding=[tu - 1, tu - up, tu - 1, tu - up], gain=up ** 2)
    factor = torch.where(a >= 0, 1.0, slope) * (gain * up ** 2)
    if clamp is not None:
        pre = torch.where(a >= 0, a, a * slope) * gain
        factor = torch.where(pre.abs() <= clamp, factor, 0.0)
    dx = upfirdn2d(g * factor, fu, down=up, flip_filter=True)
    assert dx.shape == x.shape, (dx.shape, x.shape)
    return dx.to(x.dtype)


class FusedFilteredLrelu(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient.

    Saves only x and b: the backward recomputes the pre-activation from
    them. db = Σ dx over N, H, W in fp32, outside the kernel, as in the JAX
    package (`ops/filtered_lrelu.py:138`). The kernel writes dx into a
    fresh tensor that carries no graph, so the backward is not
    differentiable again: a double backward (a path-length penalty's
    second-order terms) raises instead of dropping those terms.
    """

    @staticmethod
    def forward(ctx, x, b, fu, fd, up, padding, gain, slope, clamp):
        ctx.save_for_backward(x, b)
        ctx.conf = (fu, fd, up, padding, gain, slope, clamp)
        return flrelu_cuda.filtered_lrelu_cuda(x, fu, fd, b, up, padding,
                                               gain=gain, slope=slope, clamp=clamp)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, b = ctx.saved_tensors
        fu, fd, up, padding, gain, slope, clamp = ctx.conf
        dx = flrelu_cuda.filtered_lrelu_bwd_cuda(
            dy.contiguous(), x, fu, fd, b, up, padding, gain=gain, slope=slope,
            clamp=clamp)
        db = None
        if b is not None and ctx.needs_input_grad[1]:
            db = dx.float().sum((0, 1, 2)).to(b.dtype)
        return dx, db, None, None, None, None, None, None, None


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
            On the kernel route autograd runs the backward kernel; on the
            plain route, autograd of the composition.

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
        y = FusedFilteredLrelu.apply(x, b, fu, fd, up, (px0, px1, py0, py1),
                                     gain, slope, clamp)
    else:
        y = filtered_lrelu_ref(x, fu, fd, b, up, down, (px0, px1, py0, py1),
                               gain, slope, clamp, flip_filter)
    assert y.shape == (batch, out_h, out_w, channels)
    assert y.dtype == x.dtype
    return y

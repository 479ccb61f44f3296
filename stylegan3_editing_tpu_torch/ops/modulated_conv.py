"""Style-modulated convolution over NHWC images.

Semantics of the JAX package's `ops/modulated_conv.py` (and the reference
`modulated_conv2d`): by linearity, modulating the weight's input channels
by the styles equals scaling the input channels, and demodulating the
weight's output channels equals scaling the output channels. So one conv,
shared across the batch, runs on style-scaled inputs and its output is
rescaled. With a 1×1 kernel (SG3-R) the conv is one `torch.matmul` over the
channel axis; larger kernels go to `F.conv2d` in full fp32 (`device.conv2d`).
``up=2`` correlates the kernel with the input dilated by 2 (zeros between
its pixels), as JAX's ``lhs_dilation``: `conv2d_resample`'s transposed conv
with padding ``k - 1 - padding`` and ``flip_weight=False`` (in full fp32).
Weights are HWIO.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

import torch.nn.functional as F

from ..device import conv2d
from .conv2d_resample import _conv_transpose2d


def modulated_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    s: torch.Tensor,
    demodulate: bool = True,
    padding: int = 0,
    input_gain: Optional[Union[float, torch.Tensor]] = None,
    up: int = 1,
) -> torch.Tensor:
    """Per-sample style-modulated conv over NHWC images.

    Args:
        x: input ``[N, H, W, I]`` (compute dtype: fp32 or bf16).
        w: weights ``[kh, kw, I, O]`` (fp32).
        s: styles ``[N, I]`` (fp32).
        demodulate: pre-normalize w and s, demodulate output channels.
        padding: symmetric spatial padding (int).
        input_gain: optional scale for input channels — scalar, ``[I]``,
            or ``[N, I]`` (the magnitude-EMA gain of alias-free layers).
        up: input dilation (1, or 2 for the StyleGAN2 up-convs, whose
            callers flip the kernel and blur after).

    Returns:
        ``[N, up*(H-1) + 2*padding - kh + 2, up*(W-1) + 2*padding - kw + 2, O]``
        in x.dtype.
    """
    batch = x.shape[0]
    kh, kw, in_channels, out_channels = w.shape
    assert x.shape[-1] == in_channels
    assert s.shape == (batch, in_channels)

    w = w.float()
    s = s.float()
    if demodulate:
        w = w * torch.rsqrt(w.square().mean(dim=(0, 1, 2), keepdim=True))
        s = s * torch.rsqrt(s.square().mean())
        dcoefs = torch.rsqrt(s.square() @ w.square().sum(dim=(0, 1)) + 1e-8)  # [N, O]

    scale = s
    if input_gain is not None:
        g = torch.as_tensor(input_gain, dtype=torch.float32, device=s.device)
        scale = scale * g.reshape((1, -1) if g.ndim <= 1 else (batch, in_channels))

    out_dtype = x.dtype
    x = x * scale[:, None, None, :].to(x.dtype)
    if up > 1:
        q = [k - 1 - padding for k in (kh, kw)]
        x = _conv_transpose2d(x, w, stride=up, padding=[max(v, 0) for v in q],
                              flip_weight=False)
        if min(q) < 0:  # padding past k - 1: the outer rows see only zeros
            x = F.pad(x, [0, 0] + [max(-q[1], 0)] * 2 + [max(-q[0], 0)] * 2)
    elif kh == 1 and kw == 1 and padding == 0:
        x = torch.matmul(x, w[0, 0].to(x.dtype))
    else:
        x = conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype),
                   padding=padding).permute(0, 2, 3, 1)
    if demodulate:
        x = x * dcoefs[:, None, None, :].to(x.dtype)
    return x.to(out_dtype).contiguous()

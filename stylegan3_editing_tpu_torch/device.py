"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU. With
no card and no explicit ``device="cpu"`` they raise: nothing carries on
quietly on the CPU. A tensor's device also decides between a hand-written
kernel and its plain version (`kernel_or_plain`). Every convolution of the
port goes through `conv2d` or `conv_transpose2d`, which keep cuDNN in full
fp32, forward and backward; `fp32_matmul` does the same for the matmuls of
a block.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

DeviceLike = Union[None, str, torch.device]
IntPair = Union[int, Sequence[int]]


def _fp32_cudnn():
    """cuDNN without TF32 inside the block, the caller's other flags kept:
    `torch.backends.cudnn.flags` would otherwise reset them to its defaults
    (``enabled=False`` among them)."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def _pair(v: IntPair) -> List[int]:
    return [int(v)] * 2 if isinstance(v, int) else [int(a) for a in v]


class _Conv2d(torch.autograd.Function):
    """`F.conv2d` whose forward and backward both run under `_fp32_cudnn`.
    Autograd's own backward of `F.conv2d` reads the flags when it runs,
    inside the caller's ``backward()``, where TF32 is PyTorch's default."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, dilation, groups, bias is not None)
        with _fp32_cudnn():
            return F.conv2d(x, weight, bias, stride, padding, dilation, groups)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, groups, has_bias = ctx.conf
        want = ctx.needs_input_grad
        with _fp32_cudnn():
            dx, dw, db = torch.ops.aten.convolution_backward(
                dy, x, weight, [weight.shape[0]] if has_bias else None, stride, padding,
                dilation, False, [0, 0], groups, [want[0], want[1], has_bias and want[2]])
        return dx, dw, db, None, None, None, None


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: IntPair = 1, padding: IntPair = 0, dilation: IntPair = 1,
           groups: int = 1) -> torch.Tensor:
    """`F.conv2d` (numeric padding only) with cuDNN held to full fp32 for
    the call and for its gradients.

    PyTorch lets cuDNN run fp32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32``), which keeps about three decimal
    digits. The caller's cuDNN settings come back after each call. The
    gradient is not differentiable again (no double backward).
    """
    return _Conv2d.apply(x, weight, bias, _pair(stride), _pair(padding), _pair(dilation),
                         int(groups))


class _ConvTranspose2d(torch.autograd.Function):
    """`F.conv_transpose2d` whose forward and backward both run under
    `_fp32_cudnn`, as `_Conv2d`."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, output_padding, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, output_padding, groups, bias is not None)
        with _fp32_cudnn():
            return F.conv_transpose2d(x, weight, bias, stride, padding, output_padding, groups)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        stride, padding, output_padding, groups, has_bias = ctx.conf
        want = ctx.needs_input_grad
        with _fp32_cudnn():
            dx, dw, db = torch.ops.aten.convolution_backward(
                dy, x, weight, [weight.shape[1] * groups] if has_bias else None, stride,
                padding, [1, 1], True, output_padding, groups,
                [want[0], want[1], has_bias and want[2]])
        return dx, dw, db, None, None, None, None


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     stride: IntPair = 1, padding: IntPair = 0, output_padding: IntPair = 0,
                     groups: int = 1) -> torch.Tensor:
    """`F.conv_transpose2d` (weight ``[in, out // groups, kh, kw]``) with
    cuDNN held to full fp32 for the call and for its gradients, as
    `conv2d`. The gradient is not differentiable again."""
    return _ConvTranspose2d.apply(x, weight, bias, _pair(stride), _pair(padding),
                                  _pair(output_padding), int(groups))


@contextmanager
def fp32_matmul() -> Iterator[None]:
    """fp32 matmuls without TF32 inside the block (precision ``"highest"``),
    whatever the caller set; the caller's precision comes back after it."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; raise when CUDA is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def kernel_or_plain(device_type: str, impl: str = "auto") -> str:
    """'cuda' (the kernel) or 'ref' (the plain version): CPU tensors and
    ``impl="ref"`` take the plain version, CUDA tensors the kernel."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {device_type!r}")
    return "ref" if impl == "ref" or device_type == "cpu" else "cuda"

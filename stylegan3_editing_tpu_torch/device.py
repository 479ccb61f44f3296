"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU. With
no card and no explicit ``device="cpu"`` they raise: nothing carries on
quietly on the CPU. A tensor's device also decides between a hand-written
kernel and its plain version (`kernel_or_plain`).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


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

"""Bias + activation + gain + clamp, as plain PyTorch tensor ops.

Semantics follow the JAX package's `ops/bias_act.py` (and the reference
`_bias_act_ref`): add a per-channel bias, apply the named activation, scale
by the gain and clamp. The registry (name → function, default alpha and
gain) lets network code pick activations by name.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ActivationSpec:
    func: Callable[..., torch.Tensor]
    def_alpha: float = 0.0
    def_gain: float = 1.0


_SQRT2 = math.sqrt(2)

activation_funcs: dict[str, ActivationSpec] = {
    "linear": ActivationSpec(lambda x, **_: x),
    "relu": ActivationSpec(lambda x, **_: torch.relu(x), def_gain=_SQRT2),
    "lrelu": ActivationSpec(
        lambda x, alpha, **_: torch.where(x >= 0, x, x * alpha),
        def_alpha=0.2,
        def_gain=_SQRT2,
    ),
    "tanh": ActivationSpec(lambda x, **_: torch.tanh(x)),
    "sigmoid": ActivationSpec(lambda x, **_: torch.sigmoid(x)),
    "elu": ActivationSpec(lambda x, **_: F.elu(x)),
    "selu": ActivationSpec(lambda x, **_: F.selu(x)),
    "softplus": ActivationSpec(lambda x, **_: F.softplus(x)),
    "swish": ActivationSpec(lambda x, **_: torch.sigmoid(x) * x, def_gain=_SQRT2),
}


def bias_act(
    x: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    dim: int = -1,
    act: str = "linear",
    alpha: Optional[float] = None,
    gain: Optional[float] = None,
    clamp: Optional[float] = None,
) -> torch.Tensor:
    """Add per-channel bias, apply activation, scale by gain, clamp.

    Args:
        x: input of any shape.
        b: 1-D bias matching ``x.shape[dim]``, or ``None``.
        dim: channel dimension of ``x`` (default -1: NHWC convention).
        act: activation name from `activation_funcs`.
        alpha: activation shape parameter (None = registry default).
        gain: output scale (None = registry default).
        clamp: clamp output to ``[-clamp, clamp]`` (None = disabled).
    """
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    assert clamp is None or clamp >= 0

    if b is not None:
        assert b.ndim == 1
        axis = dim % x.ndim
        assert b.shape[0] == x.shape[axis]
        shape = [1] * x.ndim
        shape[axis] = -1
        x = x + b.reshape(shape).to(x.dtype)

    x = spec.func(x, alpha=alpha)
    if gain != 1:
        x = x * gain
    if clamp is not None:
        x = torch.clamp(x, -clamp, clamp)
    return x

"""Fully connected layer and mapping network of the alias-free generator.

PyTorch counterparts of the JAX package's `models/sg3/layers.py` (reference
`FullyConnectedLayer` and `MappingNetwork`). Parameter and buffer names
follow the flax variable tree, so `from_jax.load_jax_variables` maps it 1:1.
Weights are initialised on the CPU from an explicit `torch.Generator`; the
caller moves the module to its device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ...ops.bias_act import bias_act


class FullyConnected(nn.Module):
    """Equalized-LR fully connected layer.

    Weight stored ``[out_features, in_features]`` (reference layout); runtime
    gain ``lr_multiplier / sqrt(in_features)``.
    """

    def __init__(
        self,
        in_features: int,
        out_features: int,
        activation: str = "linear",
        use_bias: bool = True,
        lr_multiplier: float = 1.0,
        weight_init: float = 1.0,
        bias_init: Union[float, Sequence[float]] = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight_gain = lr_multiplier / math.sqrt(in_features)
        self.weight = nn.Parameter(
            torch.randn((out_features, in_features), generator=generator)
            * (weight_init / lr_multiplier))
        self.bias = None
        if use_bias:
            bias0 = np.broadcast_to(np.asarray(bias_init, np.float32), (out_features,))
            self.bias = nn.Parameter(torch.tensor(bias0 / lr_multiplier))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.weight * self.weight_gain).to(x.dtype)
        y = x @ w.T
        b = None if self.bias is None else (self.bias * self.lr_multiplier).to(x.dtype)
        return bias_act(y, b, dim=-1, act=self.activation)


def _normalize_2nd_moment(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + 1e-8)


class MappingNetwork(nn.Module):
    """z (+ class embedding) → broadcast W+ latents with truncation.

    ``w_avg`` is a buffer; ``update_emas=True`` tracks the W moving average
    in place before truncation uses it.
    """

    def __init__(
        self,
        z_dim: int,
        c_dim: int,
        w_dim: int,
        num_ws: int,
        num_layers: int = 2,
        lr_multiplier: float = 0.01,
        w_avg_beta: float = 0.998,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim = z_dim, c_dim, w_dim
        self.num_ws, self.num_layers, self.w_avg_beta = num_ws, num_layers, w_avg_beta
        if c_dim > 0:
            self.embed = FullyConnected(c_dim, w_dim, generator=generator)
        features = z_dim + (w_dim if c_dim > 0 else 0)
        for idx in range(num_layers):
            self.add_module(f"fc{idx}", FullyConnected(
                features, w_dim, activation="lrelu", lr_multiplier=lr_multiplier,
                generator=generator))
            features = w_dim
        self.register_buffer("w_avg", torch.zeros(w_dim))

    def forward(
        self,
        z: torch.Tensor,
        c: Optional[torch.Tensor] = None,
        truncation_psi: Union[float, torch.Tensor] = 1.0,
        truncation_cutoff: Optional[int] = None,
        update_emas: bool = False,
    ) -> torch.Tensor:
        assert z.shape[-1] == self.z_dim
        if truncation_cutoff is None:
            truncation_cutoff = self.num_ws

        x = _normalize_2nd_moment(z.float())
        if self.c_dim > 0:
            assert c is not None and c.shape[-1] == self.c_dim
            y = _normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=1)
        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)

        if update_emas:
            with torch.no_grad():
                batch_mean = x.detach().mean(dim=0)
                self.w_avg.copy_(batch_mean + self.w_avg_beta * (self.w_avg - batch_mean))

        ws = x[:, None, :].repeat(1, self.num_ws, 1)
        if not (isinstance(truncation_psi, (int, float)) and truncation_psi == 1):
            psi = torch.as_tensor(truncation_psi, dtype=torch.float32, device=ws.device)
            truncated = self.w_avg + psi * (ws[:, :truncation_cutoff] - self.w_avg)
            ws = torch.cat([truncated, ws[:, truncation_cutoff:]], dim=1)
        return ws

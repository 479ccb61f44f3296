"""Latent-space discriminator and replay pool for e4e training.

Counterpart of the JAX package's `training/latent_discriminator.py`
(reference e4e_modules/discriminator.py, an MLP over single w vectors, and
e4e_modules/latent_codes_pool.py, a 50 %-replacement replay buffer). The
layers are named after the flax paths (``fc0.kernel``, ``out.bias``), so
`load_jax_variables` fills them. The pool is host-side numpy state between
steps with the JAX pool's `RandomState` draws, in the same order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.backbones.common import Dense


class LatentCodesDiscriminator(nn.Module):
    """MLP on w vectors ``[N, style_dim]`` → logits ``[N, 1]``: ``n_mlp − 1``
    Dense + lrelu(0.2) layers, then ``out``."""

    def __init__(self, style_dim: int = 512, n_mlp: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_mlp = n_mlp
        for i in range(n_mlp - 1):
            self.add_module(f"fc{i}", Dense(style_dim, style_dim, generator=generator))
        self.out = Dense(style_dim, 1, generator=generator)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        x = w
        for i in range(self.n_mlp - 1):
            x = F.leaky_relu(getattr(self, f"fc{i}")(x), 0.2)
        return self.out(x)


class LatentCodesPool:
    """Replay buffer of w codes (host-side, numpy).

    query(ws): per sample, if the pool is not full, store and return the
    input; else with p = 0.5 swap it with a random stored code. 3-D inputs
    (``[N, num_ws, 512]``) contribute one random row each.
    """

    def __init__(self, pool_size: int, seed: int = 0):
        self.pool_size = pool_size
        self.ws = []
        self.rng = np.random.RandomState(seed)

    def query(self, ws: np.ndarray) -> np.ndarray:
        if self.pool_size == 0:
            return ws
        out = []
        for w in np.asarray(ws):
            if w.ndim == 2:  # [num_ws, 512] → a random row
                w = w[self.rng.randint(0, w.shape[0])]
            out.append(self._handle(w))
        return np.stack(out, axis=0)

    def _handle(self, w: np.ndarray) -> np.ndarray:
        if len(self.ws) < self.pool_size:
            self.ws.append(w)
            return w
        if self.rng.uniform() > 0.5:
            idx = self.rng.randint(0, self.pool_size)
            old = self.ws[idx].copy()
            self.ws[idx] = w
            return old
        return w

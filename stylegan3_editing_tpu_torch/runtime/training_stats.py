"""Training statistics as moment vectors.

Counterpart of the JAX package's `runtime/training_stats.py` (reference
torch_utils/training_stats.py: moment-accumulating reports): `moments`
reduces a tensor to ``[count, sum, sum of squares]``, and the host-side
`StatsCollector` accumulates them and answers mean and std queries. The
cross-device reduction (`psum_moments`) waits for the port's multi-card
runtime.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def moments(x) -> torch.Tensor:
    """``[count, sum, sum of squares]`` of a tensor (fp32), on its device."""
    x = torch.as_tensor(x, dtype=torch.float32).reshape(-1)
    return torch.stack([torch.tensor(float(x.numel()), device=x.device), x.sum(),
                        x.square().sum()])


class StatsCollector:
    """Host-side accumulator over reported moment vectors."""

    def __init__(self):
        self._acc: Dict[str, np.ndarray] = {}

    def report(self, name: str, value) -> None:
        """Accumulate a raw value (host scalar or array, tensor, or a moments
        vector)."""
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        v = np.asarray(value, np.float64)
        if v.shape == (3,):
            m = v
        else:
            flat = v.ravel()
            m = np.array([flat.size, flat.sum(), np.square(flat).sum()])
        self._acc[name] = self._acc.get(name, np.zeros(3)) + m

    def update(self, stats: Dict[str, np.ndarray]) -> None:
        for k, v in stats.items():
            self.report(k, v)

    def names(self):
        return sorted(self._acc)

    def num(self, name: str) -> int:
        return int(self._acc.get(name, np.zeros(3))[0])

    def mean(self, name: str) -> float:
        c, s, _ = self._acc.get(name, np.zeros(3))
        return float(s / c) if c > 0 else float("nan")

    def std(self, name: str) -> float:
        c, s, ss = self._acc.get(name, np.zeros(3))
        if c <= 1:
            return 0.0
        mean = s / c
        var = max(ss / c - mean * mean, 0.0)
        return float(np.sqrt(var))

    def as_dict(self) -> Dict[str, dict]:
        return {k: {"num": self.num(k), "mean": self.mean(k), "std": self.std(k)}
                for k in self.names()}

    def reset(self) -> None:
        self._acc.clear()

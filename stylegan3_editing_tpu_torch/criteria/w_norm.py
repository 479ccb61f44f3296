"""W-norm latent regulariser.

Counterpart of the JAX package's `criteria/w_norm.py` (reference
criteria/w_norm.py:11-14): the L2 norm of (latent − latent_avg) over the
(num_ws, w_dim) axes jointly, summed over the batch and divided by N.
"""

from __future__ import annotations

from typing import Optional

import torch


def w_norm_loss(latent: torch.Tensor, latent_avg: Optional[torch.Tensor] = None,
                start_from_latent_avg: bool = True) -> torch.Tensor:
    """latent: ``[N, num_ws, w_dim]``; latent_avg: broadcastable (``[w_dim]``)."""
    if start_from_latent_avg:
        assert latent_avg is not None
        latent = latent - latent_avg
    norms = latent.square().sum(dim=(1, 2)).sqrt()
    return norms.sum() / latent.shape[0]

"""Top-level alias-free generator: mapping + synthesis.

PyTorch counterpart of the JAX package's `models/sg3/generator.py`
(reference `Generator`). Built on the CUDA card unless ``device="cpu"`` is
passed; weights are random from an explicit `torch.Generator` (seed 0 by
default) until `from_jax.load_jax_variables` or a checkpoint fills them.
The filtered-lrelu kernel has no backward yet, so run the forward on the
card under `torch.inference_mode()` (or `torch.no_grad()`).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from .config import SG3Config
from .layers import MappingNetwork
from .synthesis import SynthesisNetwork


class Generator(nn.Module):
    def __init__(self, cfg: SG3Config, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.synthesis = SynthesisNetwork(cfg, generator=generator)
        self.mapping = MappingNetwork(
            z_dim=cfg.z_dim,
            c_dim=cfg.c_dim,
            w_dim=cfg.w_dim,
            num_ws=cfg.num_ws,
            num_layers=cfg.mapping_layers,
            lr_multiplier=cfg.mapping_lr_multiplier,
            w_avg_beta=cfg.w_avg_beta,
            generator=generator,
        )
        self.to(device)

    @property
    def num_ws(self) -> int:
        return self.cfg.num_ws

    def forward(
        self,
        z: torch.Tensor,
        c: Optional[torch.Tensor] = None,
        truncation_psi: Union[float, torch.Tensor] = 1.0,
        truncation_cutoff: Optional[int] = None,
        transform: Optional[torch.Tensor] = None,
        force_fp32: bool = False,
        update_emas: bool = False,
        impl: str = "auto",
    ) -> torch.Tensor:
        """z → NHWC image (fp32). ``impl="ref"`` runs the plain filtered lrelu."""
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff,
                          update_emas=update_emas)
        return self.synthesis(ws, transform=transform, force_fp32=force_fp32,
                              update_emas=update_emas, impl=impl)

    def map(
        self,
        z: torch.Tensor,
        c: Optional[torch.Tensor] = None,
        truncation_psi: Union[float, torch.Tensor] = 1.0,
        truncation_cutoff: Optional[int] = None,
        update_emas: bool = False,
    ) -> torch.Tensor:
        """z → W+ latents ``[N, num_ws, w_dim]``."""
        return self.mapping(z, c, truncation_psi=truncation_psi,
                            truncation_cutoff=truncation_cutoff,
                            update_emas=update_emas)

    def synthesize(
        self,
        ws: Optional[torch.Tensor],
        transform: Optional[torch.Tensor] = None,
        all_s: Optional[Dict[str, torch.Tensor]] = None,
        force_fp32: bool = False,
        update_emas: bool = False,
        impl: str = "auto",
    ) -> torch.Tensor:
        """W+ (or StyleSpace ``all_s``) → NHWC image."""
        return self.synthesis(ws, transform=transform, all_s=all_s,
                              force_fp32=force_fp32, update_emas=update_emas,
                              impl=impl)

    def w2s(self, ws: torch.Tensor) -> Dict[str, torch.Tensor]:
        """W+ → StyleSpace dict."""
        return self.synthesis.w2s(ws)

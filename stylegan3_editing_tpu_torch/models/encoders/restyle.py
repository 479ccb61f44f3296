"""ReStyle pSp/e4e: encoder + alias-free decoder with iterative refinement.

Counterpart of the JAX package's `models/encoders/restyle.py` (reference
psp3.py / e4e3.py): residual codes against ``latent_avg`` on the first
iteration and against the previous latent afterwards, 256² face pooling,
and the aligned/unaligned dual decode as ONE batched synthesis over the
stacked ``[identity; landmarks]`` transforms (the reference decodes twice
through a mutated buffer). Built on the CUDA card unless ``device="cpu"``
is passed; the decoder is the port's `Generator`, so on the card every
filtered layer runs the forward kernel, in its fp32 route under the
reference's ``force_fp32=True``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ...device import DeviceLike, resolve_device
from ...ops.image import adaptive_avg_pool2d
from ..sg3.config import SG3Config
from ..sg3.generator import Generator
from .backbones import (INFERENCE_STAGE, BackboneEncoder, ProgressiveBackboneEncoder,
                        ResNetBackboneEncoder, ResNetProgressiveBackboneEncoder)

ENCODER_TYPES = {
    "BackboneEncoder": BackboneEncoder,
    "ProgressiveBackboneEncoder": ProgressiveBackboneEncoder,
    "ResNetBackboneEncoder": ResNetBackboneEncoder,
    "ResNetProgressiveBackboneEncoder": ResNetProgressiveBackboneEncoder,
}
_PROGRESSIVE = {"ProgressiveBackboneEncoder", "ResNetProgressiveBackboneEncoder"}


class RestyleNet(nn.Module):
    """Unified ReStyle pSp / e4e model (the encoder type picks pSp or e4e).

    Weights are random from ``generator`` (seed 0 by default) until
    `load_jax_variables` (tree ``{params, batch_stats, buffers, ema}``, the
    decoder under ``decoder``) or `utils.inference_utils.load_encoder`
    fills them.
    """

    def __init__(self, decoder_cfg: SG3Config, encoder_type: str = "BackboneEncoder",
                 n_styles: int = 16, input_nc: int = 6, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.decoder_cfg, self.encoder_type = decoder_cfg, encoder_type
        self.n_styles, self.input_nc = n_styles, input_nc
        self.encoder = ENCODER_TYPES[encoder_type](n_styles=n_styles, input_nc=input_nc,
                                                   generator=generator)
        self.decoder = Generator(decoder_cfg, device=device, generator=generator)
        self.to(device)

    @property
    def is_progressive(self) -> bool:
        return self.encoder_type in _PROGRESSIVE

    def encode(self, x: torch.Tensor, latent: Optional[torch.Tensor] = None,
               latent_avg: Optional[torch.Tensor] = None, train: bool = False,
               stage: int = INFERENCE_STAGE) -> torch.Tensor:
        """x: NHWC (image ⊕ previous reconstruction) → codes ``[N, n_styles, 512]``,
        residual to ``latent`` when given, else to ``latent_avg``."""
        if self.is_progressive:
            codes = self.encoder(x, train=train, stage=stage)
        else:
            codes = self.encoder(x, train=train)
        if x.shape[-1] == self.input_nc and latent is not None:
            return codes + latent
        assert latent_avg is not None, "first iteration needs latent_avg"
        avg = torch.as_tensor(latent_avg, dtype=codes.dtype, device=codes.device)
        if avg.ndim == 1:
            avg = avg[None, None, :]
        elif avg.ndim == 2:
            avg = avg[None]
        return codes + avg

    def decode(self, codes: torch.Tensor, landmarks_transform: Optional[torch.Tensor] = None,
               resize: bool = True, force_fp32: bool = True, impl: str = "auto"
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """codes → (aligned, unaligned or None), in one batched synthesis."""
        n = codes.shape[0]
        identity = torch.eye(3, device=codes.device).expand(n, 3, 3)
        if landmarks_transform is None:
            images = self.decoder.synthesize(codes, transform=identity,
                                             force_fp32=force_fp32, impl=impl)
            unaligned = None
        else:
            lt = torch.as_tensor(landmarks_transform, dtype=torch.float32, device=codes.device)
            if lt.ndim == 2:
                lt = lt.expand(n, 3, 3)
            both = self.decoder.synthesize(torch.cat([codes, codes]),
                                           transform=torch.cat([identity, lt]),
                                           force_fp32=force_fp32, impl=impl)
            images, unaligned = both[:n], both[n:]
        if resize:
            images = adaptive_avg_pool2d(images, 256)
            if unaligned is not None:
                unaligned = adaptive_avg_pool2d(unaligned, 256)
        return images, unaligned

    def forward(self, x: torch.Tensor, latent: Optional[torch.Tensor] = None,
                latent_avg: Optional[torch.Tensor] = None, resize: bool = True,
                input_code: bool = False, landmarks_transform: Optional[torch.Tensor] = None,
                return_aligned_and_unaligned: bool = False, force_fp32: bool = True,
                train: bool = False, stage: int = INFERENCE_STAGE, impl: str = "auto"):
        """Returns (images, codes) or (aligned, unaligned, codes)."""
        codes = x if input_code else self.encode(x, latent=latent, latent_avg=latent_avg,
                                                 train=train, stage=stage)
        images, unaligned = self.decode(codes, landmarks_transform=landmarks_transform,
                                        resize=resize, force_fp32=force_fp32, impl=impl)
        if landmarks_transform is not None and return_aligned_and_unaligned:
            return images, unaligned, codes
        return images, codes


def get_average_image(model: RestyleNet, impl: str = "auto"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(avg_image ``[256, 256, C]``, latent_avg) from the decoder's ``w_avg``."""
    w_avg = model.decoder.mapping.w_avg
    codes = w_avg[None, None, :].expand(1, model.n_styles, w_avg.shape[-1])
    img, _ = model(codes, input_code=True, impl=impl)
    return img[0], w_avg


def run_restyle_iterations(
    model: RestyleNet,
    x: torch.Tensor,
    avg_image: torch.Tensor,
    latent_avg: torch.Tensor,
    n_iters: int = 3,
    landmarks_transform: Optional[torch.Tensor] = None,
    resize: bool = True,
    force_fp32: bool = True,
    impl: str = "auto",
) -> List[Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]]:
    """Iterative ReStyle inversion (inference): per iteration (aligned,
    unaligned or None, codes). Each iteration feeds the previous
    reconstruction as input channels 4–6. ``force_fp32=True`` is the
    reference protocol; ``impl="ref"`` runs the decoder's plain filtered
    lrelu."""
    n = x.shape[0]
    y_hat = avg_image[None].expand((n,) + tuple(avg_image.shape))
    latent = None
    results = []
    for _ in range(n_iters):
        x_input = torch.cat([x, y_hat], dim=-1)
        if landmarks_transform is not None:
            aligned, unaligned, codes = model(
                x_input, latent=latent, latent_avg=latent_avg,
                landmarks_transform=landmarks_transform, return_aligned_and_unaligned=True,
                resize=resize, force_fp32=force_fp32, impl=impl)
        else:
            aligned, codes = model(x_input, latent=latent, latent_avg=latent_avg,
                                   resize=resize, force_fp32=force_fp32, impl=impl)
            unaligned = None
        results.append((aligned, unaligned, codes))
        latent = codes
        y_hat = aligned
    return results

"""StyleCLIP latent mapper: per-level MLPs that map W+ to an edit direction.

Counterpart of the JAX package's `editing/styleclip_mapper.py` (reference
editing/styleclip_mapper/): `Mapper` (pixel norm, then 4 equalised-lr
lrelu FCs with lr multiplier 0.01, latent_mappers.py:9-31), `LevelsMapper`
(coarse :5, medium 5:8, fine 8:), `StyleCLIPMapperNet` (ŵ = w + 0.1 ·
mapper(w), then the decoder, in fp32 by default as in the JAX package) and
`MapperCoach` (training/coach.py:70-100: CLIP, ID and latent-L2 losses,
Ranger or Adam).

The coach trains the mapper only: the decoder, CLIP and the ID net are
frozen (``requires_grad_(False)``), so a step computes no weight gradient
through them. On the card the decoder runs the filtered-lrelu forward
kernel, and autograd its backward kernel for the gradient to the latents
(dx only: the frozen biases need no db). ``x_orig``, the image of the
unmapped latents for the ID loss, does not depend on the mapper: it is
rendered and embedded once, without a graph. Parameter names follow the flax tree
(``mapper.course_mapping.fc0.weight``), so `load_jax_variables` fills them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..criteria.clip_loss import CLIPLoss
from ..criteria.id_loss import IDLoss
from ..device import DeviceLike, resolve_device
from ..models.backbones.clip import CLIP
from ..models.sg3 import SG3Config
from ..models.sg3.generator import Generator
from ..models.sg3.layers import FullyConnected
from ..ops.image import adaptive_avg_pool2d
from ..training.ranger import ranger


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-8)


class Mapper(nn.Module):
    def __init__(self, latent_dim: int = 512, generator: Optional[torch.Generator] = None):
        super().__init__()
        for i in range(4):
            self.add_module(f"fc{i}", FullyConnected(latent_dim, latent_dim, activation="lrelu",
                                                     lr_multiplier=0.01, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pixel_norm(x)
        for i in range(4):
            x = getattr(self, f"fc{i}")(x)
        return x


class LevelsMapper(nn.Module):
    """Coarse / medium / fine mappers over the W+ style axis (the reference's
    ``course_mapping`` spelling kept); a level left out maps to zeros."""

    def __init__(self, no_coarse_mapper: bool = False, no_medium_mapper: bool = False,
                 no_fine_mapper: bool = False, latent_dim: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for name, off in (("course_mapping", no_coarse_mapper),
                          ("medium_mapping", no_medium_mapper), ("fine_mapping", no_fine_mapper)):
            setattr(self, name, None if off else Mapper(latent_dim, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = []
        for name, part in (("course_mapping", x[:, :5]), ("medium_mapping", x[:, 5:8]),
                           ("fine_mapping", x[:, 8:])):
            mapper = getattr(self, name)
            parts.append(torch.zeros_like(part) if mapper is None else mapper(part))
        return torch.cat(parts, dim=1)


class StyleCLIPMapperNet(nn.Module):
    """The mapper and the alias-free decoder. Built on the CUDA card unless
    ``device="cpu"``; the mapper seeded from ``generator``, the decoder seeded
    random unless one is given."""

    def __init__(self, decoder_cfg: SG3Config, mapper_type: str = "LevelsMapper",
                 decoder: Optional[Generator] = None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(0) if generator is None else generator
        self.mapper = (LevelsMapper(generator=generator) if mapper_type == "LevelsMapper"
                       else Mapper(generator=generator))
        self.decoder = decoder if decoder is not None else Generator(decoder_cfg, device=device)
        self.to(device)

    def map_latents(self, w: torch.Tensor) -> torch.Tensor:
        return w + 0.1 * self.mapper(w)

    def forward(self, w: torch.Tensor, force_fp32: bool = True,
                impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
        w_hat = self.map_latents(w)
        return self.decoder.synthesize(w_hat, force_fp32=force_fp32, impl=impl), w_hat


@dataclasses.dataclass
class MapperTrainOptions:
    """Parity: editing/styleclip_mapper/options/train_options.py."""

    exp_dir: str = "./experiments/mapper"
    description: str = "a face with a smile"
    mapper_type: str = "LevelsMapper"
    stylegan_size: int = 1024
    latents_train_path: Optional[str] = None
    latents_test_path: Optional[str] = None
    train_dataset_size: int = 5000
    batch_size: int = 2
    learning_rate: float = 0.5
    optim_name: str = "ranger"
    id_lambda: float = 0.1
    clip_lambda: float = 1.0
    latent_l2_lambda: float = 0.8
    max_steps: int = 50000
    val_interval: int = 2000
    save_interval: int = 2000
    board_interval: int = 50
    seed: int = 0


class MapperCoach:
    """Trains a StyleCLIP mapper toward a text description.

    ``decoder`` (a `Generator`), ``clip_model`` (a `CLIP`) and ``facenet``
    (the ID loss's IR-SE-50) are the frozen networks; each is seeded random
    on ``device`` when not given. ``text_tokens``: the tokenised description,
    ``[M, 77]``.
    """

    def __init__(self, opts: MapperTrainOptions, decoder_cfg: SG3Config,
                 decoder: Optional[Generator] = None, clip_model: Optional[CLIP] = None,
                 facenet: Optional[nn.Module] = None, text_tokens: Optional[np.ndarray] = None,
                 device: DeviceLike = None):
        if text_tokens is None:
            raise ValueError("tokenize the description first")
        device = resolve_device(device)
        self.opts = opts
        self.net = StyleCLIPMapperNet(decoder_cfg, opts.mapper_type, decoder=decoder,
                                      device=device,
                                      generator=torch.Generator().manual_seed(opts.seed))
        self.clip_loss = CLIPLoss(decoder_cfg.img_resolution, model=clip_model, device=device,
                                  generator=torch.Generator().manual_seed(1))
        self.id_loss = IDLoss(facenet, device=device, generator=torch.Generator().manual_seed(2))
        for frozen in (self.net.decoder, self.clip_loss, self.id_loss):
            frozen.requires_grad_(False)
        self.text_tokens = torch.as_tensor(np.asarray(text_tokens), dtype=torch.long,
                                           device=device)
        params = list(self.net.mapper.parameters())
        self.optimizer = (ranger(params, opts.learning_rate) if opts.optim_name == "ranger"
                          else torch.optim.Adam(params, opts.learning_rate))
        self.global_step = 0

    def loss(self, w: torch.Tensor, impl: str = "auto"
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The weighted loss of a batch of W+ latents and its parts."""
        x, w_hat = self.net(w, impl=impl)
        metrics = {}
        loss = torch.zeros((), device=w.device)
        if self.opts.clip_lambda > 0:
            loss_clip = self.clip_loss(x, self.text_tokens).mean()
            metrics["loss_clip"] = loss_clip
            loss = loss + loss_clip * self.opts.clip_lambda
        if self.opts.id_lambda > 0:
            # IDLoss(ŷ, x_orig, x_orig)'s loss, with x_orig embedded once.
            with torch.no_grad():
                target = self.id_loss.extract_feats(adaptive_avg_pool2d(
                    self.net.decoder.synthesize(w, force_fp32=True, impl=impl), 256))
            y_hat = self.id_loss.extract_feats(adaptive_avg_pool2d(x, 256))
            loss_id = (1 - (y_hat * target).sum(-1)).mean()
            metrics["loss_id"] = loss_id
            loss = loss + loss_id * self.opts.id_lambda
        if self.opts.latent_l2_lambda > 0:
            loss_l2 = (w_hat - w).square().mean()
            metrics["loss_l2_latent"] = loss_l2
            loss = loss + loss_l2 * self.opts.latent_l2_lambda
        metrics["loss"] = loss
        return loss, metrics

    def loss_and_grads(self, w: torch.Tensor, impl: str = "auto"
                       ) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
        """One forward and backward without a step: the metrics and the
        mapper's gradients by parameter name (the mapper's ``.grad`` is set)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss(w, impl=impl)
        loss.backward()
        grads = {name: p.grad.detach().clone() for name, p in self.net.mapper.named_parameters()}
        return {k: float(v.detach()) for k, v in metrics.items()}, grads

    def train_step(self, w_batch, impl: str = "auto") -> Dict[str, float]:
        w = torch.as_tensor(w_batch, dtype=torch.float32, device=self.text_tokens.device)
        metrics, _ = self.loss_and_grads(w, impl=impl)
        self.optimizer.step()
        self.global_step += 1
        return metrics

"""SetGAN generator: synthesis conditioned on a set of reference images.

Counterpart of the JAX package's `setgan/model.py` (reference
models/setgan/setgan.py): the encoder maps every reference image to W+
codes, mean-centred against ``latent_avg``; `StyleAttention` lets each
candidate's mapped noise styles attend to the reference codes, one set
transformer decoder per style index, then projects [attention ‖ noise
style] back to W (`StyleConcat`, or a residual); the alias-free decoder
renders the candidates. Sets are padded to a fixed size with a reference
mask ``[B, R]`` (True = a real image), so a padded slot changes no
candidate. ``restyle_mode="encoder"`` encodes [reference ‖ previous
reconstruction] for ``restyle_iters`` residual steps from the average
image. The decoder is one of three stems (`make_stem`): the alias-free
generator, StyleGAN2 or FastGAN. Built on the CUDA card unless
``device="cpu"``; on the card the alias-free decoder's filtered layers run
the forward kernel (``impl="ref"``: the plain version). Parameters carry
the flax names (``style_attn.attn_0.block_0…``, ``encoder.trunk…``,
``decoder.synthesis…``), so
`models.sg3.load_jax_variables` fills a `SetGAN` from the JAX package's
variables and `to_jax_variables` writes them back.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, fp32_matmul, resolve_device
from ..models.encoders.restyle import ENCODER_TYPES
from ..models.sg3.config import SG3Config
from ..models.sg3.generator import Generator
from ..ops.image import adaptive_avg_pool2d, resize_bilinear
from .set_transformer import SetTransformerDecoder


def make_stem(stem: str, cfg: SG3Config, device: DeviceLike = None,
              generator: Optional[torch.Generator] = None) -> Tuple[nn.Module, int]:
    """The decoder stem and its number of W+ entries: ``"sg3"`` (the
    alias-free generator), ``"sg2"`` (the NVIDIA-convention StyleGAN2 of
    StyleGAN-XL) or ``"fastgan"`` (FastGAN: no mapping, so ``w_dim`` must
    equal ``z_dim``), each built from ``cfg`` as the JAX package maps it.
    Every stem has `map` and `synthesize`."""
    if stem == "sg3":
        return Generator(cfg, device=device, generator=generator), cfg.num_ws
    if stem == "sg2":
        from ..models.sg2_stem import SG2Config, SG2Generator

        sg2_cfg = SG2Config(z_dim=cfg.z_dim, w_dim=cfg.w_dim, img_resolution=cfg.img_resolution,
                            img_channels=cfg.img_channels, channel_base=cfg.channel_base,
                            channel_max=cfg.channel_max, use_bf16=cfg.use_bf16,
                            conv_clamp=cfg.conv_clamp)
        return SG2Generator(sg2_cfg, device=device, generator=generator), sg2_cfg.num_ws
    if stem == "fastgan":
        from ..models.fastgan import FastGANConfig, FastGANGenerator

        if cfg.w_dim != cfg.z_dim:
            raise ValueError("the fastgan stem has no mapping network: w_dim must equal z_dim")
        fg_cfg = FastGANConfig(z_dim=cfg.z_dim, img_resolution=cfg.img_resolution,
                               img_channels=cfg.img_channels)
        return FastGANGenerator(fg_cfg, device=device, generator=generator), fg_cfg.num_ws
    raise ValueError(f"unknown stem {stem!r}")


def to_images(x: torch.Tensor) -> torch.Tensor:
    """``[B, S, ...]`` → ``[B·S, ...]``."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def to_set(x: torch.Tensor, batch: int) -> torch.Tensor:
    """``[B·S, ...]`` → ``[B, S, ...]``."""
    return x.reshape((batch, -1) + tuple(x.shape[1:]))


def to_imgset(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """Apply an image-batch function over a set tensor, keeping the sets."""
    return to_set(fn(to_images(x)), x.shape[0])


class StyleConcat(nn.Module):
    """Equalised 2D → D projection whose weight starts as [N(0, 0.2) | I]
    (the attention half random, the pass-through half the identity), gain
    1/√(2D), bias zero."""

    def __init__(self, latent: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        a = 0.2 * torch.randn((latent, latent), generator=generator)
        self.weight = nn.Parameter(torch.cat([a, torch.eye(latent)], dim=1))
        self.bias = nn.Parameter(torch.zeros(latent))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with fp32_matmul():
            return x @ (self.weight * (1 / math.sqrt(x.shape[-1]))).T + self.bias


class StyleAttention(nn.Module):
    """Noise styles attend to the reference set's styles, per style index."""

    def __init__(self, n_styles: int, latent: int = 512, n_heads: int = 4,
                 attn_layers: int = 2, use_set_decoder: bool = True,
                 use_temperature: bool = False, disable_style_concat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_styles, self.disable_style_concat = n_styles, disable_style_concat
        for i in range(n_styles):
            self.add_module(f"attn_{i}", SetTransformerDecoder(
                latent, latent, latent * 2, n_heads, attn_layers, ln=True, dropout=0.0,
                activation="lrelu", self_attn=use_set_decoder, use_temperature=use_temperature,
                generator=generator))
            if not disable_style_concat:
                self.add_module(f"style_concat_{i}", StyleConcat(latent, generator))

    def forward(self, codes: torch.Tensor, style_latents: torch.Tensor,
                ref_mask: Optional[torch.Tensor] = None, train: bool = False) -> torch.Tensor:
        """codes ``[B, R, n_styles, D]``, style_latents ``[B, C, n_styles, D]``,
        ref_mask ``[B, R]`` → ``[B, C, n_styles, D]``."""
        mask = None
        if ref_mask is not None:
            mask = ref_mask[:, None, :].expand(codes.shape[0], style_latents.shape[1],
                                               codes.shape[1])
        outs = []
        for i in range(self.n_styles):
            s = style_latents[:, :, i]
            out = getattr(self, f"attn_{i}")(s, codes[:, :, i], mask=mask, train=train)
            if self.disable_style_concat:
                out = out + s
            else:
                out = getattr(self, f"style_concat_{i}")(torch.cat([out, s], dim=-1))
            outs.append(out)
        return torch.stack(outs, dim=2)


class SetGAN(nn.Module):
    """Encoder + `StyleAttention` + alias-free decoder over sets.

    Weights are random from ``generator`` (seed 0 by default) until
    `load_jax_variables` fills them. ``encoder_num_layers`` sets the IR(-SE)
    trunk's depth (the ResNet families have one depth); ``remat_encoder``
    recomputes the encoder in the backward (`torch.utils.checkpoint`)
    instead of keeping its activations. With ``ref_resolution`` the
    references are average-pooled to it before the encoder when they come at
    another size (the superres recipe's 512² sets for a 256² encoder, whose
    style heads reduce a 16² map; the JAX package raises there). The pooling
    is the port's own choice: no code in the repository says how the
    reference implementation brings such sets to its encoder.
    """

    def __init__(self, decoder_cfg: SG3Config, stem: str = "sg3", n_heads: int = 4,
                 attn_layers: int = 2, mean_center: bool = True, use_set_decoder: bool = True,
                 use_temperature: bool = False, disable_style_concat: bool = False,
                 restyle_mode: str = "none", restyle_iters: int = 3,
                 encoder_type: str = "ProgressiveBackboneEncoder", encoder_num_layers: int = 50,
                 remat_encoder: bool = False, ref_resolution: Optional[int] = None,
                 device: DeviceLike = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if restyle_mode not in ("none", "encoder"):
            raise ValueError(f"restyle_mode must be 'none' or 'encoder', got {restyle_mode!r}")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.decoder_cfg, self.mean_center = decoder_cfg, mean_center
        self.restyle_mode, self.restyle_iters = restyle_mode, restyle_iters
        self.remat_encoder, self.ref_resolution = remat_encoder, ref_resolution
        self.decoder, self._num_ws = make_stem(stem, decoder_cfg, device, generator)
        enc_kwargs = {} if "ResNet" in encoder_type else {"num_layers": encoder_num_layers}
        self.encoder = ENCODER_TYPES[encoder_type](
            n_styles=self._num_ws, style_dim=decoder_cfg.w_dim,
            input_nc=6 if restyle_mode == "encoder" else 3, generator=generator, **enc_kwargs)
        self.style_attn = StyleAttention(
            self._num_ws, decoder_cfg.w_dim, n_heads, attn_layers, use_set_decoder,
            use_temperature, disable_style_concat, generator)
        self.to(device)

    @property
    def n_styles(self) -> int:
        return self._num_ws

    def _encode(self, imgs: torch.Tensor, train: bool) -> torch.Tensor:
        if self.remat_encoder and torch.is_grad_enabled():
            return checkpoint(lambda x: self.encoder(x, train=train), imgs, use_reentrant=False)
        return self.encoder(imgs, train=train)

    def forward(self, x: torch.Tensor, z: torch.Tensor,
                latent_avg: Optional[torch.Tensor] = None,
                ref_mask: Optional[torch.Tensor] = None, input_code: bool = False,
                return_latents: bool = False, update_emas: bool = False, train: bool = False,
                force_fp32: bool = False, impl: str = "auto"):
        """x: reference sets ``[B, R, H, W, 3]``; z: noise ``[B, C, z_dim]`` (or
        W+ ``[B, C, n_styles, w_dim]`` with ``input_code``). Returns images
        ``[B, C, res, res, 3]`` (and the latents ``[B, C, n_styles, w_dim]``)."""
        bs = x.shape[0]
        if latent_avg is not None:
            latent_avg = torch.as_tensor(latent_avg, dtype=torch.float32, device=x.device)
        if self.mean_center and latent_avg is None:
            raise ValueError("mean_center needs latent_avg")

        imgs = to_images(x)  # [B·R, H, W, 3]
        if self.ref_resolution and imgs.shape[1] != self.ref_resolution:
            imgs = adaptive_avg_pool2d(imgs, self.ref_resolution)
        if self.restyle_mode == "encoder":
            if latent_avg is None:
                raise ValueError("restyle_mode='encoder' needs latent_avg")
            n, enc_res = imgs.shape[0], imgs.shape[1]
            avg_codes = latent_avg[None, None, :].expand(1, self._num_ws, latent_avg.shape[-1])
            avg_image = self.decoder.synthesize(avg_codes, force_fp32=force_fp32, impl=impl)
            y = resize_bilinear(avg_image, enc_res).expand(imgs.shape)
            codes = avg_codes.expand((n,) + tuple(avg_codes.shape[1:]))
            for i in range(self.restyle_iters):
                codes = codes + self._encode(torch.cat([imgs, y.to(imgs.dtype)], dim=-1), train)
                if i < self.restyle_iters - 1:
                    y = resize_bilinear(self.decoder.synthesize(
                        codes, force_fp32=force_fp32, impl=impl), enc_res)
        else:
            codes = self._encode(imgs, train)  # [B·R, n_styles, D]
        if self.mean_center:
            codes = codes - latent_avg[None, None, :]
        codes = to_set(codes, bs)  # [B, R, n_styles, D]

        if input_code:
            style_latents = z
        else:
            style_latents = self.decoder.map(z.reshape(-1, z.shape[-1]), update_emas=update_emas)
            if self.mean_center:
                style_latents = style_latents - latent_avg[None, None, :]
            style_latents = to_set(style_latents, bs)  # [B, C, n_styles, D]

        transformed = self.style_attn(codes, style_latents, ref_mask=ref_mask, train=train)
        if self.mean_center:
            transformed = transformed + latent_avg[None, None, None, :]
        images = self.decoder.synthesize(to_images(transformed), force_fp32=force_fp32, impl=impl)
        images = to_set(images, bs)
        return (images, transformed) if return_latents else images

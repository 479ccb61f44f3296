"""StyleGAN2 generator and discriminator, rosinality's variant, over NHWC.

Counterpart of the JAX package's `models/stylegan2.py` (reference
models/stylegan2/model.py): `pixel_norm`, `EqualConv2d`, `EqualLinear`
(= the alias-free generator's `FullyConnected`), `NoiseInjection`,
`StyledConv` (a modulated conv, ×2 up through the input-dilated conv with
the kernel flipped and the 4-tap blur), `ToRGB`, the skip-architecture
`SG2Generator` with style mixing and truncation, and the residual
`SG2Discriminator` with minibatch stddev. The reference's CUDA ops map to
the port's `bias_act`, `upfirdn2d`, `upsample2d` and `conv2d_resample`;
convs run in full fp32 (`device.conv2d`, `device.conv_transpose2d`).

Noise (``noise_mode``): ``"random"`` draws a map a layer from
``generator`` (none given: no noise, as the reference without
``randomize_noise``), ``"const"`` reads the non-persistent buffers
``noises.noise_{i}`` (the reference's registry, zeros until set), and
``"none"`` adds none; ``noise`` (a list by layer) overrides all three.
Parameter names are the flax paths (``conv_up_8.modulation.weight``, …),
so `models.sg3.load_jax_variables` fills both modules.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from ..device import DeviceLike, conv2d, resolve_device
from ..ops.bias_act import bias_act
from ..ops.conv2d_resample import conv2d_resample
from ..ops.filter_design import setup_filter
from ..ops.modulated_conv import modulated_conv2d
from ..ops.upfirdn2d import upfirdn2d, upsample2d
from .sg3.layers import FullyConnected

EqualLinear = FullyConnected  # rosinality EqualLinear(activation="fused_lrelu")

_BLUR_KERNEL = (1, 3, 3, 1)


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-8)


def _channels(channel_multiplier: int) -> dict:
    cm = channel_multiplier
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm, 128: 128 * cm, 256: 64 * cm,
            512: 32 * cm, 1024: 16 * cm}


class EqualConv2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, stride: int = 1,
                 padding: int = 0, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.scale = 1 / math.sqrt(in_channels * kernel ** 2)
        self.weight = nn.Parameter(torch.randn((kernel, kernel, in_channels, out_channels),
                                               generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.weight * self.scale).permute(3, 2, 0, 1).to(x.dtype)
        y = conv2d(x.permute(0, 3, 1, 2), w, stride=self.stride,
                   padding=self.padding).permute(0, 2, 3, 1)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor]) -> torch.Tensor:
        return x if noise is None else x + self.weight.to(x.dtype) * noise


class StyledConv(nn.Module):
    """Modulated conv (+ the blur-upsample) + noise + fused lrelu."""

    def __init__(self, in_channels: int, out_channels: int, style_dim: int, kernel: int = 3,
                 upsample: bool = False, demodulate: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel, self.upsample, self.demodulate = kernel, upsample, demodulate
        self.scale = 1 / math.sqrt(in_channels * kernel ** 2)
        self.weight = nn.Parameter(torch.randn((kernel, kernel, in_channels, out_channels),
                                               generator=generator))
        self.modulation = FullyConnected(style_dim, in_channels, bias_init=1.0,
                                         generator=generator)
        self.noise = NoiseInjection()
        self.activate_bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, style_w: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        style = self.modulation(style_w)
        w = self.weight * self.scale
        if self.upsample:
            # conv_transpose2d(stride 2) + Blur(pad 1, 1): the 2×-dilated input
            # against the flipped kernel, then the blur with gain 4.
            y = modulated_conv2d(x, w.flip(0, 1), style, demodulate=self.demodulate,
                                 padding=self.kernel - 1, up=2)
            y = upfirdn2d(y, setup_filter(_BLUR_KERNEL, gain=1), padding=(1, 1, 1, 1), gain=4)
        else:
            y = modulated_conv2d(x, w, style, demodulate=self.demodulate,
                                 padding=self.kernel // 2)
        return bias_act(self.noise(y, noise), self.activate_bias, act="lrelu")


class ToRGB(nn.Module):
    def __init__(self, in_channels: int, style_dim: int, upsample_skip: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.upsample_skip = upsample_skip
        self.weight = nn.Parameter(torch.randn((1, 1, in_channels, 3), generator=generator))
        self.modulation = FullyConnected(style_dim, in_channels, bias_init=1.0,
                                         generator=generator)
        self.bias = nn.Parameter(torch.zeros(3))

    def forward(self, x: torch.Tensor, style_w: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        style = self.modulation(style_w)
        y = modulated_conv2d(x, self.weight / math.sqrt(x.shape[-1]), style, demodulate=False)
        y = y + self.bias.to(y.dtype)
        if skip is not None:
            if self.upsample_skip:
                skip = upsample2d(skip, setup_filter(_BLUR_KERNEL), up=2)
            y = y + skip
        return y


class SG2Generator(nn.Module):
    """Skip-architecture StyleGAN2 generator, z → NHWC image: style mixing
    with ``inject_index``, ``input_is_latent``, the truncation lerp,
    ``return_latents`` and the noise registry (module docstring). Built on
    the CUDA card unless ``device="cpu"``; weights random from
    ``generator`` (seed 0 by default)."""

    def __init__(self, size: int = 256, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2, lr_mlp: float = 0.01, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.size, self.style_dim, self.n_mlp = size, style_dim, n_mlp
        ch = _channels(channel_multiplier)
        self.log_size = int(math.log(size, 2))
        for i in range(n_mlp):
            self.add_module(f"style_{i}", FullyConnected(
                style_dim, style_dim, activation="lrelu", lr_multiplier=lr_mlp,
                generator=generator))
        self.input = nn.Parameter(torch.randn((1, 4, 4, ch[4]), generator=generator))
        self.conv1 = StyledConv(ch[4], ch[4], style_dim, generator=generator)
        self.to_rgb1 = ToRGB(ch[4], style_dim, upsample_skip=False, generator=generator)
        self.noises = nn.Module()
        self.noises.register_buffer("noise_0", torch.zeros((1, 4, 4, 1)), persistent=False)
        in_ch = ch[4]
        for res_log in range(3, self.log_size + 1):
            res = 2 ** res_log
            self.add_module(f"conv_up_{res}", StyledConv(in_ch, ch[res], style_dim, upsample=True,
                                                         generator=generator))
            self.add_module(f"conv_{res}", StyledConv(ch[res], ch[res], style_dim,
                                                      generator=generator))
            self.add_module(f"to_rgb_{res}", ToRGB(ch[res], style_dim, generator=generator))
            for j in (1, 2):
                self.noises.register_buffer(f"noise_{2 * (res_log - 3) + j}",
                                            torch.zeros((1, res, res, 1)), persistent=False)
            in_ch = ch[res]
        self.to(device)

    @property
    def n_latent(self) -> int:
        return self.log_size * 2 - 2

    @property
    def num_layers(self) -> int:
        """Noise maps: one conv at 4² and two a later resolution."""
        return 2 * (self.log_size - 2) + 1

    def mapping(self, z: torch.Tensor) -> torch.Tensor:
        """z → w (the rosinality ``style`` MLP)."""
        w = pixel_norm(z.float())
        for i in range(self.n_mlp):
            w = getattr(self, f"style_{i}")(w)
        return w

    def _layer_noise(self, i: int, res: int, n: int, noise_mode: str,
                     generator: Optional[torch.Generator],
                     device: torch.device) -> Optional[torch.Tensor]:
        if noise_mode == "none" or (noise_mode == "random" and generator is None):
            return None
        if noise_mode == "const":
            return getattr(self.noises, f"noise_{i}")
        return torch.randn((n, res, res, 1), generator=generator, device=device)

    def forward(self, z: Union[None, torch.Tensor, Sequence[torch.Tensor]] = None,
                styles: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, noise_mode: str = "random",
                noise: Optional[List[Optional[torch.Tensor]]] = None,
                truncation: float = 1.0, truncation_latent: Optional[torch.Tensor] = None,
                input_is_latent: bool = False, inject_index: Optional[int] = None,
                return_latents: bool = False):
        """``z``: one ``[N, D]`` latent or two (style mixing); ``styles``: a
        ready W+ ``[N, n_latent, D]`` (no mapping)."""
        if styles is None:
            assert z is not None
            zs = list(z) if isinstance(z, (list, tuple)) else [z]
            ws = [s.float() if input_is_latent else self.mapping(s) for s in zs]
            if truncation != 1.0 and truncation_latent is not None:
                ws = [truncation_latent + truncation * (w - truncation_latent) for w in ws]
            if len(ws) == 1:
                styles = ws[0][:, None, :].expand(-1, self.n_latent, -1)
            else:
                assert len(ws) == 2, "style mixing uses two latents"
                if inject_index is None:
                    inject_index = self.n_latent // 2
                styles = torch.cat([ws[0][:, None, :].expand(-1, inject_index, -1),
                                    ws[1][:, None, :].expand(-1, self.n_latent - inject_index,
                                                             -1)], dim=1)
        n, device = styles.shape[0], styles.device

        def layer_noise(i, res):
            if noise is not None:
                return noise[i]
            return self._layer_noise(i, res, n, noise_mode, generator, device)

        x = self.input.expand((n,) + tuple(self.input.shape[1:]))
        x = self.conv1(x, styles[:, 0], noise=layer_noise(0, 4))
        skip = self.to_rgb1(x, styles[:, 1])
        idx, noise_i = 1, 1
        for res_log in range(3, self.log_size + 1):
            res = 2 ** res_log
            x = getattr(self, f"conv_up_{res}")(x, styles[:, idx], noise=layer_noise(noise_i, res))
            x = getattr(self, f"conv_{res}")(x, styles[:, idx + 1],
                                             noise=layer_noise(noise_i + 1, res))
            skip = getattr(self, f"to_rgb_{res}")(x, styles[:, idx + 2], skip)
            idx += 2
            noise_i += 2
        return (skip, styles) if return_latents else skip


class _DiscBlock(nn.Module):
    """Residual D block: conv1 (3×3) + lrelu, then the blur and a stride-2
    conv in one `conv2d_resample(down=2)`, a 1×1 skip the same way,
    (y + skip)/√2."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = EqualConv2d(in_channels, in_channels, 3, padding=1, generator=generator)
        self.conv2_weight = nn.Parameter(torch.randn((3, 3, in_channels, out_channels),
                                                     generator=generator))
        self.conv2_bias = nn.Parameter(torch.zeros(out_channels))
        self.skip_weight = nn.Parameter(torch.randn((1, 1, in_channels, out_channels),
                                                    generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_c = x.shape[-1]
        blur = setup_filter(_BLUR_KERNEL)
        y = bias_act(self.conv1(x), act="lrelu")
        y = conv2d_resample(y, self.conv2_weight / math.sqrt(in_c * 9), f=blur, down=2,
                            padding=1)
        y = bias_act(y, self.conv2_bias, act="lrelu")
        skip = conv2d_resample(x, self.skip_weight / math.sqrt(in_c), f=blur, down=2, padding=0)
        return (y + skip) / math.sqrt(2)


class SG2Discriminator(nn.Module):
    def __init__(self, size: int = 256, channel_multiplier: int = 2, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        ch = _channels(channel_multiplier)
        self.log_size = int(math.log(size, 2))
        self.from_rgb = EqualConv2d(3, ch[size], 1, generator=generator)
        for res_log in range(self.log_size, 2, -1):
            self.add_module(f"block_{2 ** res_log}", _DiscBlock(
                ch[2 ** res_log], ch[2 ** (res_log - 1)], generator=generator))
        self.final_conv = EqualConv2d(ch[4] + 1, ch[4], 3, padding=1, generator=generator)
        self.final_linear1 = FullyConnected(ch[4] * 16, ch[4], activation="lrelu",
                                            generator=generator)
        self.final_linear2 = FullyConnected(ch[4], 1, generator=generator)
        self.to(device)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = bias_act(self.from_rgb(img), act="lrelu")
        for res_log in range(self.log_size, 2, -1):
            x = getattr(self, f"block_{2 ** res_log}")(x)
        n, h, w, c = x.shape
        group = min(4, n)
        y = x[:(n // group) * group].reshape(group, -1, h, w, c)
        stddev = torch.sqrt(y.var(dim=0, unbiased=False) + 1e-8)
        stddev = stddev.mean(dim=(1, 2, 3), keepdim=True).repeat(group, h, w, 1)
        x = torch.cat([x, stddev[:n]], dim=-1)
        x = bias_act(self.final_conv(x), act="lrelu")
        return self.final_linear2(self.final_linear1(x.reshape(n, -1)))


__all__ = ["EqualConv2d", "EqualLinear", "NoiseInjection", "SG2Discriminator", "SG2Generator",
           "StyledConv", "ToRGB", "pixel_norm"]

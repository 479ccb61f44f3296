"""Alias-free synthesis network (PyTorch, NHWC, bf16 policy).

Counterparts of the JAX package's `models/sg3/synthesis.py` (reference
`SynthesisInput`, `SynthesisLayer`, `SynthesisNetwork` with the StyleSpace
additions: a precomputed transform `t`, per-layer `styles`, and `w2s`).

- The user transform is an argument (identity by default), not a mutated
  buffer, so two transforms can share one batched call.
- `magnitude_ema` is a buffer, updated in place under ``update_emas``
  before its ``rsqrt`` becomes the conv's input gain.
- The top `num_fp16_res` resolutions run in bfloat16 (``use_bf16``);
  ``force_fp32`` runs every layer in float32.
- Activations stay NHWC. The filtered leaky ReLU of every layer except
  ToRGB launches the CUDA kernel on the card (`ops/filtered_lrelu.py`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ...ops.filtered_lrelu import filtered_lrelu
from ...ops.modulated_conv import modulated_conv2d
from .config import InputSpec, LayerSpec, SG3Config, build_synthesis_layout
from .layers import FullyConnected

_SQRT2 = math.sqrt(2)


def transform_from_t(t: torch.Tensor, user_transform: Optional[torch.Tensor],
                     batch: int) -> torch.Tensor:
    """Compose the learned (rotation, translation) with a user transform.

    ``t = (r_c, r_s, t_x, t_y)`` (unit-normalized in its first two
    components). Returns ``[N, 3, 3]`` inverse transforms w.r.t. the image.
    """
    r_c, r_s, t_x, t_y = t[:, 0], t[:, 1], t[:, 2], t[:, 3]
    zeros = torch.zeros_like(r_c)
    ones = torch.ones_like(r_c)
    m_r = torch.stack([
        torch.stack([r_c, -r_s, zeros], dim=-1),
        torch.stack([r_s, r_c, zeros], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)
    m_t = torch.stack([
        torch.stack([ones, zeros, -t_x], dim=-1),
        torch.stack([zeros, ones, -t_y], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)
    out = m_r @ m_t
    if user_transform is not None:
        u = torch.as_tensor(user_transform, dtype=torch.float32, device=t.device)
        if u.ndim == 2:
            u = u[None]
        out = out @ u
    return out.expand(batch, 3, 3)


class SynthesisInput(nn.Module):
    """Fourier-feature input stage: w → NHWC features on the first canvas."""

    def __init__(self, spec: InputSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        self.weight = nn.Parameter(
            torch.randn((spec.channels, spec.channels), generator=generator))
        self.affine = FullyConnected(spec.w_dim, 4, weight_init=0.0,
                                     bias_init=(1, 0, 0, 0), generator=generator)
        self.register_buffer("freqs", torch.from_numpy(spec.freqs.copy()))
        self.register_buffer("phases", torch.from_numpy(spec.phases.copy()))

    def compute_t(self, w: torch.Tensor) -> torch.Tensor:
        """w → unit-normalized (r_c, r_s, t_x, t_y); the 'input' StyleSpace entry."""
        t = self.affine(w.float())
        return t / torch.linalg.norm(t[:, :2], dim=1, keepdim=True)

    def forward(self, w: Optional[torch.Tensor],
                transform: Optional[torch.Tensor] = None,
                t: Optional[torch.Tensor] = None) -> torch.Tensor:
        s = self.spec
        if t is None:
            assert w is not None
            t = self.compute_t(w)
        batch = t.shape[0]
        transforms = transform_from_t(t, transform, batch)

        freqs = self.freqs[None].expand(batch, s.channels, 2)
        phases = self.phases[None] + torch.einsum("bck,bk->bc", freqs, transforms[:, :2, 2])
        freqs = torch.einsum("bck,bkl->bcl", freqs, transforms[:, :2, :2])

        # Dampen frequencies pushed out of band by the user transform.
        amplitudes = torch.clamp(
            1 - (torch.linalg.norm(freqs, dim=2) - s.bandwidth)
            / (s.sampling_rate / 2 - s.bandwidth), 0, 1)

        # Pixel-center sampling grid (torch affine_grid, align_corners=False).
        width, height = s.size
        dev = freqs.device
        gx = ((2 * torch.arange(width, dtype=torch.float32, device=dev) + 1) / width - 1) \
            * (0.5 * width / s.sampling_rate)
        gy = ((2 * torch.arange(height, dtype=torch.float32, device=dev) + 1) / height - 1) \
            * (0.5 * height / s.sampling_rate)

        x = (gx[None, None, :, None] * freqs[:, None, None, :, 0]
             + gy[None, :, None, None] * freqs[:, None, None, :, 1]
             + phases[:, None, None, :])
        x = torch.sin(x * (2 * math.pi))
        x = x * amplitudes[:, None, None, :]
        x = x @ (self.weight / math.sqrt(s.channels)).T
        assert x.shape == (batch, height, width, s.channels)
        return x


class SynthesisLayer(nn.Module):
    """One alias-free layer: affine → modulated conv → filtered lrelu."""

    def __init__(self, spec: LayerSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        s = self.spec = spec
        self.affine = FullyConnected(s.w_dim, s.in_channels, bias_init=1.0,
                                     generator=generator)
        self.weight = nn.Parameter(torch.randn(
            (s.conv_kernel, s.conv_kernel, s.in_channels, s.out_channels),
            generator=generator))
        self.bias = nn.Parameter(torch.zeros(s.out_channels))
        self.register_buffer("magnitude_ema", torch.ones(()))
        # The forward uses the spec's numpy filters (equal to these); the
        # buffers keep the checkpoint layout of the JAX package.
        if s.up_filter is not None:
            self.register_buffer("up_filter", torch.from_numpy(s.up_filter.copy()))
        if s.down_filter is not None:
            self.register_buffer("down_filter", torch.from_numpy(s.down_filter.copy()))

    def compute_styles(self, w: torch.Tensor) -> torch.Tensor:
        """w → per-layer styles; the layer's StyleSpace entry."""
        s = self.spec
        styles = self.affine(w.float())
        if s.is_torgb:
            styles = styles * (1 / math.sqrt(s.in_channels * s.conv_kernel ** 2))
        return styles

    def forward(
        self,
        x: torch.Tensor,
        w: Optional[torch.Tensor] = None,
        styles: Optional[torch.Tensor] = None,
        force_fp32: bool = False,
        update_emas: bool = False,
        impl: str = "auto",
    ) -> torch.Tensor:
        s = self.spec
        assert x.shape[1:] == (s.in_size[1], s.in_size[0], s.in_channels), (
            f"{s.name}: got {tuple(x.shape)}")

        if update_emas:
            with torch.no_grad():
                mag = x.detach().float().square().mean()
                self.magnitude_ema.copy_(
                    mag + s.magnitude_ema_beta * (self.magnitude_ema - mag))
        input_gain = torch.rsqrt(self.magnitude_ema)

        if styles is None:
            assert w is not None and w.shape == (x.shape[0], s.w_dim)
            styles = self.compute_styles(w)

        dtype = torch.bfloat16 if (s.use_bf16 and not force_fp32) else torch.float32
        x = modulated_conv2d(
            x.to(dtype), self.weight, styles,
            demodulate=not s.is_torgb,
            padding=s.conv_kernel - 1,
            input_gain=input_gain,
        )
        x = filtered_lrelu(
            x, fu=s.up_filter, fd=s.down_filter, b=self.bias.to(x.dtype),
            up=s.up_factor, down=s.down_factor, padding=s.padding,
            gain=1.0 if s.is_torgb else _SQRT2,
            slope=1.0 if s.is_torgb else 0.2,
            clamp=s.conv_clamp,
            impl=impl,
        )
        assert x.shape[1:] == (s.out_size[1], s.out_size[0], s.out_channels)
        assert x.dtype == dtype
        return x


class SynthesisNetwork(nn.Module):
    """Fourier input + N+1 alias-free layers. NHWC out, float32.

    ``all_s`` takes the StyleSpace dict produced by `w2s`
    ({'input': t, layer_name: styles}) and bypasses every affine.
    """

    def __init__(self, cfg: SG3Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.layout = build_synthesis_layout(cfg)
        self.input = SynthesisInput(self.layout.input, generator=generator)
        self.layer_names = [spec.name for spec in self.layout.layers]
        for spec in self.layout.layers:
            self.add_module(spec.name, SynthesisLayer(spec, generator=generator))

    @property
    def num_ws(self) -> int:
        return self.layout.num_ws

    def forward(
        self,
        ws: Optional[torch.Tensor],
        transform: Optional[torch.Tensor] = None,
        all_s: Optional[Dict[str, torch.Tensor]] = None,
        force_fp32: bool = False,
        update_emas: bool = False,
        impl: str = "auto",
    ) -> torch.Tensor:
        if all_s is None:
            assert ws is not None and ws.shape[1:] == (self.num_ws, self.cfg.w_dim)
            ws = ws.float()
            x = self.input(ws[:, 0], transform=transform)
            for i, name in enumerate(self.layer_names):
                x = getattr(self, name)(x, ws[:, i + 1], None, force_fp32,
                                        update_emas, impl)
        else:
            x = self.input(None, transform=transform, t=all_s["input"])
            for name in self.layer_names:
                x = getattr(self, name)(x, None, all_s[name], force_fp32,
                                        update_emas, impl)

        if self.cfg.output_scale != 1:
            x = x * self.cfg.output_scale
        assert x.shape[1:] == (self.cfg.img_resolution, self.cfg.img_resolution,
                               self.cfg.img_channels)
        return x.float()

    def w2s(self, ws: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Project W+ latents to StyleSpace (shares the forward affines)."""
        ws = ws.float()
        all_s: Dict[str, torch.Tensor] = {"input": self.input.compute_t(ws[:, 0])}
        for i, name in enumerate(self.layer_names):
            all_s[name] = getattr(self, name).compute_styles(ws[:, i + 1])
        return all_s

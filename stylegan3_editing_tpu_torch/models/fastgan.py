"""FastGAN generator: the lightweight SetGAN ``"fastgan"`` stem.

Counterpart of the JAX package's `models/fastgan.py` (reference
models/styleganxl/training/networks_fastgan.py and pg_modules/blocks.py):
z → a 4×4 init (a transposed conv, GroupNorm, GLU) → nearest ×2 `UpBlock`s
(3×3 conv, noise, GroupNorm, GLU; twice unless ``lite``) with skip-layer
excitation (`SEBlock`) from low to high resolutions → a 3×3 to-RGB conv.
`FastGANGenerator.map` lifts z to ``[N, 1, z_dim]`` (the reference's
`DummyMapping`), so ``w_dim == z_dim`` and there is no ``w_avg``.

The JAX package's choices are kept: GroupNorm (flax's, E[x²] − E[x]²
variance, ε 1e-6) for the reference's BatchNorm and equalised weight gains
1/√fan_in for its spectral norm (that module's docstring). NHWC; convs in
full fp32 through `device.conv2d`, the init's 1×1 → 4×4 step through
`device.conv_transpose2d`.

Noise: as the ``"sg2"`` stem's (`models/sg2_stem.py`), explicit by layer
(``"feat_8.0"``, ``"feat_8.1"``, … of ``[N, H, W, 1]``, `noise_shapes`) or
drawn from a `torch.Generator` (seeded 0 a call by default). Parameter
names are the flax paths (``init.GroupNorm_0.scale``, ``feat_8.conv0.weight``,
``se_64.conv4.weight``, ``to_big.bias``), so `models.sg3.load_jax_variables`
fills a `FastGANGenerator`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, conv2d, conv_transpose2d, resolve_device

_NFC_MULTI = {2: 16, 4: 16, 8: 8, 16: 4, 32: 2, 64: 2, 128: 1, 256: 0.5, 512: 0.25,
              1024: 0.125}
GROUP_NORM_EPS = 1e-6  # flax's default


@dataclasses.dataclass(frozen=True)
class FastGANConfig:
    z_dim: int = 256
    img_resolution: int = 256
    img_channels: int = 3
    ngf: int = 128
    lite: bool = False

    def nfc(self, res: int) -> int:
        return int(_NFC_MULTI[res] * self.ngf)

    @property
    def num_ws(self) -> int:
        return 1

    @property
    def w_dim(self) -> int:
        return self.z_dim


def _glu(x: torch.Tensor) -> torch.Tensor:
    c = x.shape[-1] // 2
    return x[..., :c] * torch.sigmoid(x[..., c:])


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)`` over NHWC: each group's channels of
    each image normalised over H, W and the group (variance E[x²] − E[x]²,
    floored at 0), then ``scale`` and ``bias``."""

    def __init__(self, channels: int, num_groups: int):
        super().__init__()
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        g = x.reshape(n, h, w, self.num_groups, c // self.num_groups)
        mean = g.mean(dim=(1, 2, 4), keepdim=True)
        var = ((g * g).mean(dim=(1, 2, 4), keepdim=True) - mean * mean).clamp_min(0)
        y = ((g - mean) * torch.rsqrt(var + GROUP_NORM_EPS)).reshape(n, h, w, c)
        return y * self.scale + self.bias


class _Conv(nn.Module):
    """HWIO conv with the equalised gain 1/√fan_in and flax's "SAME" padding."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, use_bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = kernel
        self.weight = nn.Parameter(torch.randn((kernel, kernel, in_channels, features),
                                               generator=generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel
        lo, hi = (k - 1) // 2, k - 1 - (k - 1) // 2
        w = self.weight / np.float32(np.sqrt(x.shape[-1] * k * k))
        x = x.permute(0, 3, 1, 2)
        if lo != hi:
            x, pad = F.pad(x, [lo, hi, lo, hi]), 0
        else:
            pad = lo
        y = conv2d(x, w.permute(3, 2, 0, 1).to(x.dtype), padding=pad).permute(0, 2, 3, 1)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class InitLayer(nn.Module):
    """z → ``[N, 4, 4, C]``: a transposed conv of the 1×1 input, GroupNorm, GLU."""

    def __init__(self, z_dim: int, channels: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn((4, 4, z_dim, channels * 2), generator=generator))
        self.GroupNorm_0 = GroupNorm(channels * 2, channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        z = z / np.float32(np.sqrt(z.shape[-1]))
        x = conv_transpose2d(z[:, :, None, None], self.weight.permute(2, 3, 0, 1))
        return _glu(self.GroupNorm_0(x.permute(0, 2, 3, 1)))


class UpBlock(nn.Module):
    """Nearest ×2 upsample, then conv, noise, GroupNorm and GLU (twice unless lite)."""

    def __init__(self, in_channels: int, channels: int, lite: bool,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lite = lite
        self.conv0 = _Conv(in_channels, channels * 2, generator=generator)
        self.norm0 = GroupNorm(channels * 2, channels)
        if not lite:
            self.noise_strength0 = nn.Parameter(torch.zeros(()))
            self.conv1 = _Conv(channels, channels * 2, generator=generator)
            self.noise_strength1 = nn.Parameter(torch.zeros(()))
            self.norm1 = GroupNorm(channels * 2, channels)

    def forward(self, x: torch.Tensor, noise: Tuple[Optional[torch.Tensor], ...]) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        for idx in ((0,) if self.lite else (0, 1)):
            x = getattr(self, f"conv{idx}")(x)
            if not self.lite:
                x = x + noise[idx].to(x.dtype) * getattr(self, f"noise_strength{idx}").to(x.dtype)
            x = _glu(getattr(self, f"norm{idx}")(x))
        return x


class SEBlock(nn.Module):
    """Skip-layer excitation: the small features gate the big ones."""

    def __init__(self, small_channels: int, channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv4 = _Conv(small_channels, channels, kernel=4, generator=generator)
        self.conv1 = _Conv(channels, channels, kernel=1, use_bias=True, generator=generator)

    def forward(self, small: torch.Tensor, big: torch.Tensor) -> torch.Tensor:
        kh, kw = small.shape[1] // 4, small.shape[2] // 4
        s = F.avg_pool2d(small.permute(0, 3, 1, 2), (kh, kw), (kh, kw)).permute(0, 2, 3, 1)
        s = self.conv4(s)[:, :1, :1, :]
        s = s * torch.sigmoid(s)  # swish
        return big * torch.sigmoid(self.conv1(s))


class FastGANGenerator(nn.Module):
    """FastGAN synthesis with the stem API (`map`, `synthesize`, `num_ws`).
    Built on the CUDA card unless ``device="cpu"``; weights random from
    ``generator`` (seed 0 by default)."""

    def __init__(self, cfg: FastGANConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.init = InitLayer(cfg.z_dim, cfg.nfc(2), generator=generator)
        channels = {4: cfg.nfc(2)}
        for res in self.resolutions:
            self.add_module(f"feat_{res}", UpBlock(channels[res // 2], cfg.nfc(res), cfg.lite,
                                                   generator=generator))
            channels[res] = cfg.nfc(res)
            if res in self.se_resolutions:
                self.add_module(f"se_{res}", SEBlock(channels[res // 16], cfg.nfc(res),
                                                     generator=generator))
        self.to_big = _Conv(channels[cfg.img_resolution], cfg.img_channels, use_bias=True,
                            generator=generator)
        self.to(device)

    @property
    def resolutions(self) -> Tuple[int, ...]:
        return tuple(2 ** i for i in range(3, int(np.log2(self.cfg.img_resolution)) + 1))

    @property
    def se_resolutions(self) -> Tuple[int, ...]:
        return tuple(r for r in self.resolutions if r in (64, 128, 256, 512) and r // 16 >= 4)

    @property
    def num_ws(self) -> int:
        return 1

    def noise_shapes(self, batch: int) -> Dict[str, Tuple[int, int, int, int]]:
        """The noise input of each conv, by name: ``[N, res, res, 1]``."""
        if self.cfg.lite:
            return {}
        return {f"feat_{res}.{i}": (batch, res, res, 1) for res in self.resolutions
                for i in (0, 1)}

    def draw_noise(self, batch: int, device: torch.device,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Normal noise for every conv from ``generator`` (seeded 0 if none)."""
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        return {k: torch.randn(s, generator=generator, device=device)
                for k, s in self.noise_shapes(batch).items()}

    def map(self, z: torch.Tensor, truncation_psi: float = 1.0,
            update_emas: bool = False) -> torch.Tensor:
        return z[:, None, :]

    def synthesize(self, ws: torch.Tensor, noise: Optional[Mapping[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None, force_fp32: bool = False,
                   impl: str = "auto") -> torch.Tensor:
        """``[N, 1, z_dim]`` → NHWC image (fp32). ``force_fp32`` and ``impl``
        are taken for the stem API: every layer is fp32, none has a hand kernel."""
        if noise is None:
            noise = self.draw_noise(ws.shape[0], ws.device, generator)
        z = ws[:, 0].float()
        z = z * torch.rsqrt(z.square().mean(dim=-1, keepdim=True) + 1e-8)
        feats = {4: self.init(z)}
        x = feats[4]
        for res in self.resolutions:
            x = getattr(self, f"feat_{res}")(x, (noise.get(f"feat_{res}.0"),
                                                 noise.get(f"feat_{res}.1")))
            if res in self.se_resolutions:
                x = getattr(self, f"se_{res}")(feats[res // 16], x)
            feats[res] = x
        return self.to_big(x).float()

    def forward(self, z: torch.Tensor, noise: Optional[Mapping[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.synthesize(self.map(z), noise=noise, generator=generator)

"""NVIDIA-convention StyleGAN2 generator: the SetGAN ``"sg2"`` stem.

Counterpart of the JAX package's `models/sg2_stem.py` (reference
models/styleganxl/training/networks_stylegan2.py): an 8-layer mapping with
the ``w_avg`` EMA, synthesis blocks b4..bN (conv0 up ×2, conv1, a skip
ToRGB added to the upsampled RGB of the block before), per-layer noise and
the [1, 3, 3, 1] resample filter. NHWC; one batch-shared modulated conv
(`ops/modulated_conv.py`); the up-convs are the input-dilated modulated
conv with the kernel flipped (`device.conv_transpose2d`) and the blur.

Dtypes follow the JAX package: a block among the ``num_fp16_res`` top
resolutions enters in bf16, and the activation's √2 gain (a float32 scalar
there) brings each layer's output back to fp32, so conv0 of such a block
runs in bf16 and the rest in fp32.

Noise: the JAX package draws it inside from ``fold_in(rng, res)``, which
torch cannot reproduce. `SG2Generator.synthesize` takes it explicitly, a
dict by layer (``"b4.conv1"``, ``"b8.conv0"``, … of ``[N, H, W, 1]``,
`noise_shapes`), or draws it from ``generator`` (a `torch.Generator` on
the images' device; by default one seeded 0 a call, so a call's noise is
the same each time, as the JAX package's default key is).

Parameter names are the flax paths (``b8.conv0.affine.weight``, …), so
`models.sg3.load_jax_variables` fills an `SG2Generator`; `convert_sg2_state`
reads the reference's state dict.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.modulated_conv import modulated_conv2d
from ..ops.upfirdn2d import upfirdn2d, upsample2d
from .sg3.layers import FullyConnected, MappingNetwork

_BLUR = np.array([1.0, 3.0, 3.0, 1.0], np.float32) / 8


@dataclasses.dataclass(frozen=True)
class SG2Config:
    z_dim: int = 512
    w_dim: int = 512
    img_resolution: int = 256
    img_channels: int = 3
    channel_base: int = 32768
    channel_max: int = 512
    mapping_layers: int = 8
    mapping_lr_multiplier: float = 0.01
    w_avg_beta: float = 0.998
    num_fp16_res: int = 4
    use_bf16: bool = True
    conv_clamp: Optional[float] = 256.0

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def block_resolutions(self) -> List[int]:
        return [2 ** i for i in range(2, int(np.log2(self.img_resolution)) + 1)]

    @property
    def num_ws(self) -> int:
        # One conv at b4 and two a later block; each block's ToRGB takes the
        # next block's first w, the last one an extra w.
        return 2 * len(self.block_resolutions)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    """lrelu in the input's dtype, then the √2 gain in fp32 (the JAX
    package's float32 scalar promotes a bf16 input)."""
    return torch.where(x >= 0, x, x * 0.2).float() * np.float32(np.sqrt(2))


class SG2Layer(nn.Module):
    """Modulated 3×3 conv (×2 up for conv0) + noise + bias + lrelu + clamp."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, up: bool = False,
                 clamp: Optional[float] = 256.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.up, self.clamp = up, clamp
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0, generator=generator)
        self.weight = nn.Parameter(torch.randn((3, 3, in_channels, out_channels),
                                               generator=generator))
        self.noise_strength = nn.Parameter(torch.zeros(()))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, w: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w)
        if self.up:
            # conv2d_resample(up=2, padding=1, flip_weight=False): the 2×-dilated
            # input against the flipped kernel, then the blur with gain 4.
            x = modulated_conv2d(x, self.weight.flip(0, 1), styles, padding=2, up=2)
            x = upfirdn2d(x, _BLUR, padding=(1, 1, 1, 1), gain=4)
        else:
            x = modulated_conv2d(x, self.weight, styles, padding=1)
        x = x + noise.to(x.dtype) * self.noise_strength.to(x.dtype)
        x = _lrelu(x + self.bias.to(x.dtype))
        if self.clamp is not None:
            x = x.clamp(-self.clamp, self.clamp)
        return x


class SG2ToRGB(nn.Module):
    def __init__(self, in_channels: int, w_dim: int, out_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0, generator=generator)
        self.weight = nn.Parameter(torch.randn((1, 1, in_channels, out_channels),
                                               generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w) / np.float32(np.sqrt(x.shape[-1]))
        x = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return x + self.bias.to(x.dtype)


class SG2Block(nn.Module):
    """One resolution: [const] or conv0 (up) + conv1, and the ToRGB skip."""

    def __init__(self, cfg: SG2Config, res: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.res = res
        out_ch = cfg.channels(res)
        if res == 4:
            self.const = nn.Parameter(torch.randn((4, 4, out_ch), generator=generator))
        else:
            self.conv0 = SG2Layer(cfg.channels(res // 2), out_ch, cfg.w_dim, up=True,
                                  clamp=cfg.conv_clamp, generator=generator)
        self.conv1 = SG2Layer(out_ch, out_ch, cfg.w_dim, clamp=cfg.conv_clamp,
                              generator=generator)
        self.torgb = SG2ToRGB(out_ch, cfg.w_dim, cfg.img_channels, generator=generator)

    def forward(self, x, img, ws, noise: Mapping[str, torch.Tensor], w_idx: int,
                dtype: torch.dtype):
        name = f"b{self.res}"
        if self.res == 4:
            x = self.const[None].expand((ws.shape[0],) + tuple(self.const.shape)).to(dtype)
            x = self.conv1(x, ws[:, w_idx], noise[f"{name}.conv1"])
            w_idx += 1
        else:
            x = self.conv0(x.to(dtype), ws[:, w_idx], noise[f"{name}.conv0"])
            x = self.conv1(x, ws[:, w_idx + 1], noise[f"{name}.conv1"])
            w_idx += 2
        y = self.torgb(x, ws[:, w_idx])
        img = y if img is None else upsample2d(img, _BLUR, up=2) + y.to(img.dtype)
        return x, img, w_idx


class SG2Generator(nn.Module):
    """Mapping + synthesis with the stem API of the SG3 `Generator`
    (`map`, `synthesize`, `num_ws`). Built on the CUDA card unless
    ``device="cpu"``; weights random from ``generator`` (seed 0 by default)."""

    def __init__(self, cfg: SG2Config, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.mapping = MappingNetwork(
            z_dim=cfg.z_dim, c_dim=0, w_dim=cfg.w_dim, num_ws=cfg.num_ws,
            num_layers=cfg.mapping_layers, lr_multiplier=cfg.mapping_lr_multiplier,
            w_avg_beta=cfg.w_avg_beta, generator=generator)
        for res in cfg.block_resolutions:
            self.add_module(f"b{res}", SG2Block(cfg, res, generator=generator))
        self.to(device)

    @property
    def num_ws(self) -> int:
        return self.cfg.num_ws

    def noise_shapes(self, batch: int) -> Dict[str, Tuple[int, int, int, int]]:
        """The noise input of each layer, by name: ``[N, res, res, 1]``."""
        shapes = {}
        for res in self.cfg.block_resolutions:
            for conv in (("conv1",) if res == 4 else ("conv0", "conv1")):
                shapes[f"b{res}.{conv}"] = (batch, res, res, 1)
        return shapes

    def draw_noise(self, batch: int, device: torch.device,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Normal noise for every layer from ``generator`` (seeded 0 if none)."""
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        return {k: torch.randn(s, generator=generator, device=device)
                for k, s in self.noise_shapes(batch).items()}

    def map(self, z: torch.Tensor, truncation_psi: float = 1.0,
            update_emas: bool = False) -> torch.Tensor:
        return self.mapping(z, truncation_psi=truncation_psi, update_emas=update_emas)

    def synthesize(self, ws: torch.Tensor, noise: Optional[Mapping[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None, force_fp32: bool = False,
                   impl: str = "auto") -> torch.Tensor:
        """W+ ``[N, num_ws, w_dim]`` → NHWC image (fp32). ``impl`` is taken
        for the stem API and unused: no layer here has a hand kernel."""
        cfg = self.cfg
        if noise is None:
            noise = self.draw_noise(ws.shape[0], ws.device, generator)
        resolutions = cfg.block_resolutions
        fp16_start = (len(resolutions) - cfg.num_fp16_res if cfg.use_bf16 and not force_fp32
                      else len(resolutions))
        x = img = None
        w_idx = 0
        for i, res in enumerate(resolutions):
            dtype = torch.bfloat16 if i >= fp16_start else torch.float32
            x, img, w_idx = getattr(self, f"b{res}")(x, img, ws, noise, w_idx, dtype)
        return img.float()

    def forward(self, z: torch.Tensor, truncation_psi: float = 1.0, update_emas: bool = False,
                noise: Optional[Mapping[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ws = self.map(z, truncation_psi=truncation_psi, update_emas=update_emas)
        return self.synthesize(ws, noise=noise, generator=generator)


def convert_sg2_state(state: Mapping[str, np.ndarray], cfg: SG2Config) -> dict:
    """A torch-style `networks_stylegan2` state dict (also one converted from
    TF1 by `persistence.convert_tf_generator_state`) → the flax variables
    ``{"params", "ema"}`` of `SG2Generator`, numpy leaves. The blur taps
    and the const-noise buffers are not variables here."""
    params: dict = {}
    ema: dict = {}

    def assign(path, v):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v

    for name, v in state.items():
        parts = name.split(".")
        v = np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
        if name == "mapping.w_avg":
            ema["mapping"] = {"w_avg": v}
        elif parts[0] == "mapping" and parts[1].startswith("fc"):
            assign(("mapping", parts[1], parts[2]), v)
        elif parts[0] == "synthesis" and parts[1].startswith("b"):
            block, mod = parts[1], parts[2]
            if mod == "const":
                assign((block, "const"), v.transpose(1, 2, 0))  # CHW → HWC
            elif parts[-1] in ("resample_filter", "noise_const"):
                pass
            elif parts[-1] == "weight" and parts[-2] in ("conv0", "conv1", "torgb", "skip"):
                assign((block, parts[-2], "weight"), v.transpose(2, 3, 1, 0))  # OIHW → HWIO
            elif len(parts) >= 5 and parts[3] == "affine":
                assign((block, parts[2], "affine", parts[4]), v)
            elif parts[-1] in ("bias", "noise_strength"):
                assign((block, parts[2], parts[-1]), v)
    return {"params": params, "ema": ema}


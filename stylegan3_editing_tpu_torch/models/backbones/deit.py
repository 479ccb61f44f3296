"""DeiT / ViT feature extractor (NHWC in public) for the projected discriminator.

Counterpart of the JAX package's `models/backbones/deit.py` (timm
``deit_base_distilled_patch16_224`` sliced DPT-style): a 16×16 patch
embedding, the prefix tokens (cls and, for the distilled DeiTs, dist) and
the position embedding, 12 pre-LN blocks (LayerNorm ε 1e-6, fused qkv,
exact GELU), the tokens taken after blocks 2, 5, 8 and 11 with the prefix
dropped, laid out on the 14×14 patch grid, then one head per stage: /4
(1×1 conv and a 4× transposed conv), /8 (1×1 and 2×), /16 (1×1), /32 (1×1
and a stride-2 3×3). The heads keep their random init in projected-GAN;
`convert_deit` fills the trunk from a timm state dict.

The convs go through `device.conv2d`; the transposed convs, whose stride
equals their kernel, are one product each (every output pixel takes one
input pixel and one tap), and every product runs in full fp32
(`device.fp32_matmul`). The input must be 224²: the discriminator always
resizes to it, and the JAX package's position-embedding interpolation for
other sizes (an antialiased resize) is not ported.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import fp32_matmul
from .common import Conv2d, Dense, LayerNorm, conv_w, dense_w, put

_DIM = 768
_HEADS = 12
_DEPTH = 12
_HOOKS = (2, 5, 8, 11)
_STAGE_CH = (96, 192, 384, 768)
_GRID = 14  # 224 / 16


class Block(nn.Module):
    """Pre-LN transformer block (timm ViT): fused qkv, GELU MLP."""

    def __init__(self, dim: int = _DIM, heads: int = _HEADS,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim, generator)
        self.proj = Dense(dim, dim, generator)
        self.norm2 = LayerNorm(dim)
        self.fc1 = Dense(dim, 4 * dim, generator)
        self.fc2 = Dense(4 * dim, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, d = x.shape
        with fp32_matmul():
            qkv = self.qkv(self.norm1(x)).reshape(n, t, 3, self.heads, d // self.heads)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [n, h, t, d/h]
            attn = (q @ k.transpose(-1, -2) / math.sqrt(d // self.heads)).softmax(-1)
            x = x + self.proj((attn @ v).transpose(1, 2).reshape(n, t, d))
            return x + self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="none"))


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, (k, k), strides=(k, k))`` (padding
    'SAME', a bias) on NHWC: output pixel ``(k·i + r, k·j + c)`` is input
    pixel ``(i, j)`` times the tap ``kernel[k−1−r, k−1−c]`` (flax does not
    flip the kernel of a transposed conv), one product over the input
    channels."""

    def __init__(self, in_channels: int, out_channels: int, k: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.randn((k, k, in_channels, out_channels),
                                               generator=generator) / math.sqrt(in_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        k, out = self.kernel.shape[0], self.kernel.shape[3]
        with fp32_matmul():
            y = torch.einsum("nhwi,rcio->nhrwco", x, self.kernel.flip(0, 1))
        return y.reshape(n, h * k, w * k, out) + self.bias


class DeiTFeatures(nn.Module):
    """224² NHWC input (normalised by the caller) → 4 feature maps (/4, /8,
    /16, /32 with ``stage_ch`` channels). ``dim``/``heads``/``stage_ch``
    select the family (base 768/12 by default); ``prefix_tokens`` is 2 for
    the distilled DeiTs (cls + dist) and 1 for a plain ViT (cls)."""

    def __init__(self, dim: int = _DIM, heads: int = _HEADS,
                 stage_ch: Sequence[int] = _STAGE_CH, prefix_tokens: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.prefix_tokens = dim, prefix_tokens
        self.patch_embed = Conv2d(3, dim, 16, 16, generator=generator)
        self.cls_token = nn.Parameter(torch.zeros((1, 1, dim)))
        if prefix_tokens == 2:
            self.dist_token = nn.Parameter(torch.zeros((1, 1, dim)))
        self.pos_embed = nn.Parameter(torch.zeros((1, prefix_tokens + _GRID ** 2, dim)))
        for i in range(_DEPTH):
            self.add_module(f"block{i}", Block(dim, heads, generator))
        for si, ch in enumerate(stage_ch):
            self.add_module(f"head{si}_proj", Conv2d(dim, ch, 1, generator=generator))
        self.head0_up = ConvTranspose(stage_ch[0], stage_ch[0], 4, generator)
        self.head1_up = ConvTranspose(stage_ch[1], stage_ch[1], 2, generator)
        self.head3_down = Conv2d(stage_ch[3], stage_ch[3], 3, 2, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        n, hh, ww, _ = x.shape
        if (hh, ww) != (16 * _GRID, 16 * _GRID):
            raise ValueError(f"DeiTFeatures takes 224x224 inputs (a 14x14 token grid), got "
                             f"{hh}x{ww}; the discriminator resizes its inputs to 224")
        npf, dim = self.prefix_tokens, self.dim
        tok = self.patch_embed(x).reshape(n, _GRID * _GRID, dim)
        prefix = [self.cls_token.expand(n, 1, dim)]
        if npf == 2:
            prefix.append(self.dist_token.expand(n, 1, dim))
        tok = torch.cat(prefix + [tok], dim=1) + self.pos_embed
        hooks = {}
        for i in range(_DEPTH):
            tok = getattr(self, f"block{i}")(tok)
            if i in _HOOKS:
                hooks[i] = tok
        outs = []
        for si, hook in enumerate(_HOOKS):
            fmap = hooks[hook][:, npf:].reshape(n, _GRID, _GRID, dim)
            fmap = getattr(self, f"head{si}_proj")(fmap)
            if si == 0:
                fmap = self.head0_up(fmap)
            elif si == 1:
                fmap = self.head1_up(fmap)
            elif si == 3:
                fmap = self.head3_down(fmap)
            outs.append(fmap)
        return outs


def DeiTSmallFeatures(**kw) -> DeiTFeatures:
    """timm ``deit_small_distilled_patch16_224``."""
    return DeiTFeatures(dim=384, heads=6, stage_ch=(48, 96, 192, 384), **kw)


def DeiTTinyFeatures(**kw) -> DeiTFeatures:
    """timm ``deit_tiny_distilled_patch16_224``."""
    return DeiTFeatures(dim=192, heads=3, stage_ch=(24, 48, 96, 192), **kw)


def ViTBaseFeatures(**kw) -> DeiTFeatures:
    """timm ``vit_base_patch16_224``: a plain ViT, the cls token only."""
    return DeiTFeatures(prefix_tokens=1, **kw)


def convert_deit(state: Mapping[str, np.ndarray]) -> dict:
    """timm DeiT/ViT state dict → the trunk's ``{"params": tree}``. The stage
    heads are not in it (projected-GAN leaves them at their random init):
    load the result over a module's own variables."""
    p: Dict = {}
    put(p, "patch_embed/kernel", conv_w(state["patch_embed.proj.weight"]))
    put(p, "patch_embed/bias", state["patch_embed.proj.bias"])
    put(p, "cls_token", state["cls_token"])
    if "dist_token" in state:  # plain ViTs have the cls token only
        put(p, "dist_token", state["dist_token"])
    put(p, "pos_embed", state["pos_embed"])
    for i in range(_DEPTH):
        src, dst = f"blocks.{i}", f"block{i}"
        for ours, theirs in (("norm1", "norm1"), ("norm2", "norm2")):
            put(p, f"{dst}/{ours}/scale", state[f"{src}.{theirs}.weight"])
            put(p, f"{dst}/{ours}/bias", state[f"{src}.{theirs}.bias"])
        for ours, theirs in (("qkv", "attn.qkv"), ("proj", "attn.proj"), ("fc1", "mlp.fc1"),
                             ("fc2", "mlp.fc2")):
            put(p, f"{dst}/{ours}/kernel", dense_w(state[f"{src}.{theirs}.weight"]))
            put(p, f"{dst}/{ours}/bias", state[f"{src}.{theirs}.bias"])
    return {"params": p}

"""IR / IR-SE face-recognition backbones (ArcFace-style), NHWC in public.

Counterpart of the JAX package's `models/backbones/irse.py` (reference
`Backbone` / `bottleneck_IR(_SE)` / `SEModule`): the trunk of every ReStyle
inversion encoder and the net behind the ID loss. Parameter and buffer
names follow the flax tree (``body_3.conv1.kernel``, ``body_3.bn1.mean``),
so `models.sg3.load_jax_variables` fills them from ``{params, batch_stats}``.
The converter maps InsightFace-style torch state dicts (``input_layer.*``,
``body.N.*``, ``output_layer.*``) onto that tree.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm, Conv2d, Dense, PReLU, bn_from_torch, conv_w, dense_w, put


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    in_channel: int
    depth: int
    stride: int


def get_blocks(num_layers: int) -> List[List[BlockSpec]]:
    def stage(in_channel, depth, num_units, stride=2):
        return [BlockSpec(in_channel, depth, stride)] + [
            BlockSpec(depth, depth, 1) for _ in range(num_units - 1)]

    if num_layers == 50:
        units = (3, 4, 14, 3)
    elif num_layers == 100:
        units = (3, 13, 30, 3)
    elif num_layers == 152:
        units = (3, 8, 36, 3)
    elif num_layers == 8:
        # A minimal 4-stage trunk (one bottleneck per stage), not a reference
        # depth: for tests, where pretrained weights do not matter.
        units = (1, 1, 1, 1)
    else:
        raise ValueError(f"num_layers must be 8/50/100/152, got {num_layers}")
    chans = ((64, 64), (64, 128), (128, 256), (256, 512))
    return [stage(i, d, n) for (i, d), n in zip(chans, units)]


def _block_specs(num_layers: int) -> List[BlockSpec]:
    return [spec for stage in get_blocks(num_layers) for spec in stage]


class SEModule(nn.Module):
    """Squeeze-and-excitation: x · sigmoid(fc2(relu(fc1(mean_hw(x)))))."""

    def __init__(self, channels: int, reduction: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Conv2d(channels, channels // reduction, 1, generator=generator,
                          use_bias=False)
        self.fc2 = Conv2d(channels // reduction, channels, 1, generator=generator,
                          use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(1, 2), keepdim=True)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * torch.sigmoid(s)


class BottleneckIR(nn.Module):
    """BN → 3×3 conv → PReLU → 3×3 conv (stride) → BN (→ SE), plus a
    shortcut: a strided view (``MaxPool2d(1, stride)``) where the channel
    count stays, else a strided 1×1 conv and BN."""

    def __init__(self, spec: BlockSpec, use_se: bool,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = s = spec
        if s.in_channel != s.depth:
            self.shortcut_conv = Conv2d(s.in_channel, s.depth, 1, s.stride,
                                        generator=generator, use_bias=False)
            self.shortcut_bn = BatchNorm(s.depth)
        self.bn1 = BatchNorm(s.in_channel)
        self.conv1 = Conv2d(s.in_channel, s.depth, 3, 1, 1, generator=generator,
                            use_bias=False)
        self.prelu = PReLU(s.depth)
        self.conv2 = Conv2d(s.depth, s.depth, 3, s.stride, 1, generator=generator,
                            use_bias=False)
        self.bn2 = BatchNorm(s.depth)
        self.se = SEModule(s.depth, generator=generator) if use_se else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        s = self.spec
        if s.in_channel == s.depth:
            shortcut = x[:, ::s.stride, ::s.stride, :]
        else:
            shortcut = self.shortcut_bn(self.shortcut_conv(x), train=train)
        r = self.bn1(x, train=train)
        r = self.prelu(self.conv1(r))
        r = self.bn2(self.conv2(r), train=train)
        if self.se is not None:
            r = self.se(r)
        return r + shortcut


class IRSEBody(nn.Module):
    """Input layer (3×3 conv, BN, PReLU) and the IR(-SE) bottlenecks
    ``body_0 …``: the part every IR net shares."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se", input_nc: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in ("ir", "ir_se"):
            raise ValueError(f"mode must be 'ir' or 'ir_se', got {mode!r}")
        self.input_conv = Conv2d(input_nc, 64, 3, 1, 1, generator=generator, use_bias=False)
        self.input_bn = BatchNorm(64)
        self.input_prelu = PReLU(64)
        self.n_blocks = 0
        for idx, spec in enumerate(_block_specs(num_layers)):
            self.add_module(f"body_{idx}", BottleneckIR(spec, mode == "ir_se", generator))
            self.n_blocks = idx + 1

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.input_prelu(self.input_bn(self.input_conv(x), train=train))
        for idx in range(self.n_blocks):
            x = getattr(self, f"body_{idx}")(x, train=train)
        return x


class IRSEBackbone(IRSEBody):
    """Full face net: 112² or 224² NHWC input → l2-normalised 512-d embedding."""

    def __init__(self, input_size: int = 112, num_layers: int = 50, mode: str = "ir_se",
                 drop_ratio: float = 0.6, affine: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_layers, mode, generator=generator)
        assert input_size in (112, 224)
        self.input_size, self.drop_ratio = input_size, drop_ratio
        side = input_size // 16
        self.output_bn = BatchNorm(512)
        self.output_linear = Dense(512 * side * side, 512, generator=generator)
        self.output_bn1d = BatchNorm(512, affine=affine)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        assert x.shape[1] == x.shape[2] == self.input_size
        x = self.output_bn(super().forward(x, train=train), train=train)
        x = F.dropout(x, self.drop_ratio, training=train)
        # torch flattens NCHW (C-major), so released linear weights apply unchanged.
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        x = self.output_bn1d(self.output_linear(x), train=train)
        return x / torch.linalg.norm(x, dim=1, keepdim=True)


def convert_irse_body_state(state: Mapping[str, np.ndarray], num_layers: int):
    """The input layer and ``body.N.*`` of a torch IR(-SE) state dict →
    ``(params, batch_stats)`` subtrees named as `IRSEBody`."""
    params: dict = {}
    stats: dict = {}
    put(params, "input_conv/kernel", conv_w(state["input_layer.0.weight"]))
    bn_from_torch(params, stats, "input_bn", state, "input_layer.1")
    put(params, "input_prelu/alpha", state["input_layer.2.weight"])
    for idx, spec in enumerate(_block_specs(num_layers)):
        t, o = f"body.{idx}", f"body_{idx}"
        if spec.in_channel != spec.depth:
            put(params, f"{o}/shortcut_conv/kernel",
                conv_w(state[f"{t}.shortcut_layer.0.weight"]))
            bn_from_torch(params, stats, f"{o}/shortcut_bn", state, f"{t}.shortcut_layer.1")
        bn_from_torch(params, stats, f"{o}/bn1", state, f"{t}.res_layer.0")
        put(params, f"{o}/conv1/kernel", conv_w(state[f"{t}.res_layer.1.weight"]))
        put(params, f"{o}/prelu/alpha", state[f"{t}.res_layer.2.weight"])
        put(params, f"{o}/conv2/kernel", conv_w(state[f"{t}.res_layer.3.weight"]))
        bn_from_torch(params, stats, f"{o}/bn2", state, f"{t}.res_layer.4")
        if f"{t}.res_layer.5.fc1.weight" in state:
            put(params, f"{o}/se/fc1/kernel", conv_w(state[f"{t}.res_layer.5.fc1.weight"]))
            put(params, f"{o}/se/fc2/kernel", conv_w(state[f"{t}.res_layer.5.fc2.weight"]))
    return params, stats


def convert_irse_state(state: Mapping[str, np.ndarray], num_layers: int = 50,
                       affine: bool = True) -> dict:
    """torch Backbone state dict → ``{'params', 'batch_stats'}`` variables."""
    params, stats = convert_irse_body_state(state, num_layers)
    bn_from_torch(params, stats, "output_bn", state, "output_layer.0")
    put(params, "output_linear/kernel", dense_w(state["output_layer.3.weight"]))
    put(params, "output_linear/bias", state["output_layer.3.bias"])
    bn_from_torch(params, stats, "output_bn1d", state, "output_layer.4", affine=affine)
    return {"params": params, "batch_stats": stats}

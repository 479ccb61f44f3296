"""InceptionV3 of the FID (pool3 features), NHWC in public.

Counterpart of the JAX package's `models/backbones/inception.py`: the TF-2015
FID network that NVIDIA's detector pickle holds (torchvision's InceptionV3
topology with the FID patches). The patches: every batch norm has ε 1e-3;
the pool branch of InceptionA, InceptionC and Mixed_7b is a 3×3 stride-1
average that does not count the padding; Mixed_7c's pool branch is a 3×3
stride-1 max pool padded with −inf. Parameters carry the flax names
(``Mixed_5b.branch5x5_2.conv.kernel``, HWIO), so `load_jax_variables` fills
the module from the JAX package's variables or from `convert_inception`,
which reads a torchvision / pytorch-fid state dict.

Inputs are [−1, 1] NHWC images of any size: a bilinear resize to 299²
(half-pixel centres, no antialiasing) and the detector's uint8 scaling
``(v − 128) / 128`` written for [−1, 1], ``x·127.5/128 − 0.5/128``. Every
conv goes through `device.conv2d` (full fp32 on the card).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import DeviceLike, resolve_device
from ...ops.image import max_pool2d, resize_bilinear
from .common import BatchNorm, Conv2d, bn_from_torch, conv_w, put


def _avg_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 average over NHWC, padded by one, the padding not
    counted (the FID patch of the InceptionA/C and Mixed_7b pool branches)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1, count_include_pad=False)
    return y.permute(0, 2, 3, 1)


def _max_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 max pool over NHWC padded with −inf (Mixed_7c's patch)."""
    return max_pool2d(x, 3, 1, padding=1)


class BasicConv2d(nn.Module):
    """Conv (no bias) → BatchNorm (ε 1e-3) → ReLU, as ``conv`` and ``bn``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: Tuple[int, int],
                 stride: int = 1, padding: Tuple[int, int] = (0, 0),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_channels = out_channels
        self.conv = Conv2d(in_channels, out_channels, kernel, stride, padding,
                           generator=generator, use_bias=False)
        self.bn = BatchNorm(out_channels, epsilon=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class _Branches(nn.Module):
    """A block of `BasicConv2d` chains; ``specs`` is ``name: (out, kernel,
    stride, padding, input)`` in order, where ``input`` is the name whose
    output the conv reads (None: the block's input)."""

    def __init__(self, in_channels: int, specs, generator):
        super().__init__()
        self.inputs = {}
        widths = {None: in_channels}
        for name, (out, kernel, stride, padding, src) in specs.items():
            self.add_module(name, BasicConv2d(widths[src], out, kernel, stride, padding,
                                              generator))
            self.inputs[name] = src
            widths[name] = out

    def run(self, x: torch.Tensor, name: str, cache: dict) -> torch.Tensor:
        if name not in cache:
            src = self.inputs[name]
            cache[name] = getattr(self, name)(x if src is None else self.run(x, src, cache))
        return cache[name]


def _c(out, kernel, src=None, stride=1, padding=(0, 0)):
    return out, kernel, stride, padding, src


class InceptionA(_Branches):
    def __init__(self, in_channels: int, pool_features: int, generator=None):
        super().__init__(in_channels, {
            "branch1x1": _c(64, (1, 1)),
            "branch5x5_1": _c(48, (1, 1)),
            "branch5x5_2": _c(64, (5, 5), "branch5x5_1", padding=(2, 2)),
            "branch3x3dbl_1": _c(64, (1, 1)),
            "branch3x3dbl_2": _c(96, (3, 3), "branch3x3dbl_1", padding=(1, 1)),
            "branch3x3dbl_3": _c(96, (3, 3), "branch3x3dbl_2", padding=(1, 1)),
        }, generator)
        self.branch_pool = BasicConv2d(in_channels, pool_features, (1, 1), generator=generator)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c: dict = {}
        return torch.cat([self.run(x, "branch1x1", c), self.run(x, "branch5x5_2", c),
                          self.run(x, "branch3x3dbl_3", c),
                          self.branch_pool(_avg_pool_3x3_same(x))], dim=-1)


class InceptionB(_Branches):
    def __init__(self, in_channels: int, generator=None):
        super().__init__(in_channels, {
            "branch3x3": _c(384, (3, 3), stride=2),
            "branch3x3dbl_1": _c(64, (1, 1)),
            "branch3x3dbl_2": _c(96, (3, 3), "branch3x3dbl_1", padding=(1, 1)),
            "branch3x3dbl_3": _c(96, (3, 3), "branch3x3dbl_2", stride=2),
        }, generator)
        self.out_channels = 384 + 96 + in_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c: dict = {}
        return torch.cat([self.run(x, "branch3x3", c), self.run(x, "branch3x3dbl_3", c),
                          max_pool2d(x, 3, 2)], dim=-1)


class InceptionC(_Branches):
    def __init__(self, in_channels: int, c7: int, generator=None):
        super().__init__(in_channels, {
            "branch1x1": _c(192, (1, 1)),
            "branch7x7_1": _c(c7, (1, 1)),
            "branch7x7_2": _c(c7, (1, 7), "branch7x7_1", padding=(0, 3)),
            "branch7x7_3": _c(192, (7, 1), "branch7x7_2", padding=(3, 0)),
            "branch7x7dbl_1": _c(c7, (1, 1)),
            "branch7x7dbl_2": _c(c7, (7, 1), "branch7x7dbl_1", padding=(3, 0)),
            "branch7x7dbl_3": _c(c7, (1, 7), "branch7x7dbl_2", padding=(0, 3)),
            "branch7x7dbl_4": _c(c7, (7, 1), "branch7x7dbl_3", padding=(3, 0)),
            "branch7x7dbl_5": _c(192, (1, 7), "branch7x7dbl_4", padding=(0, 3)),
        }, generator)
        self.branch_pool = BasicConv2d(in_channels, 192, (1, 1), generator=generator)
        self.out_channels = 4 * 192

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c: dict = {}
        return torch.cat([self.run(x, "branch1x1", c), self.run(x, "branch7x7_3", c),
                          self.run(x, "branch7x7dbl_5", c),
                          self.branch_pool(_avg_pool_3x3_same(x))], dim=-1)


class InceptionD(_Branches):
    def __init__(self, in_channels: int, generator=None):
        super().__init__(in_channels, {
            "branch3x3_1": _c(192, (1, 1)),
            "branch3x3_2": _c(320, (3, 3), "branch3x3_1", stride=2),
            "branch7x7x3_1": _c(192, (1, 1)),
            "branch7x7x3_2": _c(192, (1, 7), "branch7x7x3_1", padding=(0, 3)),
            "branch7x7x3_3": _c(192, (7, 1), "branch7x7x3_2", padding=(3, 0)),
            "branch7x7x3_4": _c(192, (3, 3), "branch7x7x3_3", stride=2),
        }, generator)
        self.out_channels = 320 + 192 + in_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c: dict = {}
        return torch.cat([self.run(x, "branch3x3_2", c), self.run(x, "branch7x7x3_4", c),
                          max_pool2d(x, 3, 2)], dim=-1)


class InceptionE(_Branches):
    """``pool="avg"`` (Mixed_7b, padding not counted) or ``"max"`` (Mixed_7c)."""

    def __init__(self, in_channels: int, pool: str = "avg", generator=None):
        super().__init__(in_channels, {
            "branch1x1": _c(320, (1, 1)),
            "branch3x3_1": _c(384, (1, 1)),
            "branch3x3_2a": _c(384, (1, 3), "branch3x3_1", padding=(0, 1)),
            "branch3x3_2b": _c(384, (3, 1), "branch3x3_1", padding=(1, 0)),
            "branch3x3dbl_1": _c(448, (1, 1)),
            "branch3x3dbl_2": _c(384, (3, 3), "branch3x3dbl_1", padding=(1, 1)),
            "branch3x3dbl_3a": _c(384, (1, 3), "branch3x3dbl_2", padding=(0, 1)),
            "branch3x3dbl_3b": _c(384, (3, 1), "branch3x3dbl_2", padding=(1, 0)),
        }, generator)
        self.pool = pool
        self.branch_pool = BasicConv2d(in_channels, 192, (1, 1), generator=generator)
        self.out_channels = 320 + 4 * 384 + 192

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c: dict = {}
        pooled = _avg_pool_3x3_same(x) if self.pool == "avg" else _max_pool_3x3_same(x)
        return torch.cat([self.run(x, name, c) for name in
                          ("branch1x1", "branch3x3_2a", "branch3x3_2b", "branch3x3dbl_3a",
                           "branch3x3dbl_3b")] + [self.branch_pool(pooled)], dim=-1)


class InceptionV3Features(nn.Module):
    """[−1, 1] NHWC images (any size) → ``[N, 2048]`` pool3 features."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), 2, generator=g)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3), generator=g)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1), generator=g)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1), generator=g)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3), generator=g)
        self.mixed = []
        c = 192
        for name, make in (("Mixed_5b", lambda c: InceptionA(c, 32, g)),
                           ("Mixed_5c", lambda c: InceptionA(c, 64, g)),
                           ("Mixed_5d", lambda c: InceptionA(c, 64, g)),
                           ("Mixed_6a", lambda c: InceptionB(c, g)),
                           ("Mixed_6b", lambda c: InceptionC(c, 128, g)),
                           ("Mixed_6c", lambda c: InceptionC(c, 160, g)),
                           ("Mixed_6d", lambda c: InceptionC(c, 160, g)),
                           ("Mixed_6e", lambda c: InceptionC(c, 192, g)),
                           ("Mixed_7a", lambda c: InceptionD(c, g)),
                           ("Mixed_7b", lambda c: InceptionE(c, "avg", g)),
                           ("Mixed_7c", lambda c: InceptionE(c, "max", g))):
            block = make(c)
            self.add_module(name, block)
            self.mixed.append(name)
            c = block.out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(x, 299) * np.float32(127.5 / 128.0) - np.float32(0.5 / 128.0)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = max_pool2d(x, 3, 2)
        for name in self.mixed:
            x = getattr(self, name)(x)
        return x.mean(dim=(1, 2))


# Every BasicConv2d in the network, in torch's dotted naming.
_BLOCKS = (
    ["Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1", "Conv2d_4a_3x3"]
    + [f"Mixed_5{s}.{b}" for s in "bcd"
       for b in ("branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1",
                 "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool")]
    + [f"Mixed_6a.{b}" for b in ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2",
                                 "branch3x3dbl_3")]
    + [f"Mixed_6{s}.{b}" for s in "bcde"
       for b in ("branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3", "branch7x7dbl_1",
                 "branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5",
                 "branch_pool")]
    + [f"Mixed_7a.{b}" for b in ("branch3x3_1", "branch3x3_2", "branch7x7x3_1",
                                 "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4")]
    + [f"Mixed_7{s}.{b}" for s in "bc"
       for b in ("branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b", "branch3x3dbl_1",
                 "branch3x3dbl_2", "branch3x3dbl_3a", "branch3x3dbl_3b", "branch_pool")]
)


def convert_inception(state: Mapping[str, np.ndarray]) -> dict:
    """torchvision / pytorch-fid InceptionV3 state dict → ``{'params',
    'batch_stats'}`` named as `InceptionV3Features`."""
    params: dict = {}
    stats: dict = {}
    for name in _BLOCKS:
        ours = name.replace(".", "/")
        put(params, f"{ours}/conv/kernel", conv_w(state[f"{name}.conv.weight"]))
        bn_from_torch(params, stats, f"{ours}/bn", state, f"{name}.bn")
    return {"params": params, "batch_stats": stats}


def inception_feature_fn(variables: Optional[Mapping] = None,
                         device: DeviceLike = None) -> Callable[[object], np.ndarray]:
    """``images`` ([−1, 1] NHWC, numpy or a tensor) → ``[N, 2048]`` float32
    features (numpy), computed on the card unless ``device="cpu"``: the
    default `ConditionalFID` extractor. ``variables`` (a flax-named tree,
    as `convert_inception` gives or the JAX package's) fill the network;
    None keeps its init drawn from seed 0."""
    from ..sg3 import load_jax_variables

    device = resolve_device(device)
    model = InceptionV3Features(generator=torch.Generator().manual_seed(0))
    if variables is not None:
        load_jax_variables(model, variables)
    model = model.to(device).eval()

    def features(images) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.float32) if not torch.is_tensor(images)
                            else images, dtype=torch.float32, device=device)
        with torch.no_grad():
            return model(x).cpu().numpy()

    return features

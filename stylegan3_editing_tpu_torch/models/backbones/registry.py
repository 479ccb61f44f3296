"""Feature-network registry: name → 4-stage extractor, normalisation, converter.

Counterpart of the JAX package's `models/backbones/registry.py` (the
reference's ``_make_pretrained``, which slices timm and
torchvision families into 4 feature stages for the projected
discriminator). Every entry gives:

- ``make(generator=...)`` → a module whose ``forward(x_nhwc)`` returns 4
  feature maps (the /4, /8, /16, /32 stage contract);
- ``mean``/``std`` → the input normalisation (applied by the caller to RGB
  in [0, 1]);
- ``convert`` → a torch/timm state dict → the module's variables, as a
  flax tree that `models.sg3.load_jax_variables` reads (stage heads the
  reference leaves at their random init keep it).

The registry lists the JAX package's names, and each builds: DeiT/ViT,
the EfficientNet ladder, the ResNet, VGG and AlexNet stages, DenseNet,
MobileNetV2, MNASNet, ShuffleNetV2, the RegNetX/Y ladder and CLIP's ViT-B/32
and RN50 trunks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
INCEPTION_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
INCEPTION_STD = np.array([0.5, 0.5, 0.5], np.float32)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class SlicedStages(nn.Module):
    """Run an inner multi-stage module (the child ``net``) and keep 4 of its
    stages."""

    def __init__(self, inner: Callable[..., nn.Module], take: Sequence[int] = (0, 1, 2, 3),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.take = tuple(take)
        self.net = inner(generator=generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = self.net(x)
        return [feats[i] for i in self.take]


@dataclasses.dataclass(frozen=True)
class FeatureNetworkSpec:
    name: str
    make: Callable[..., nn.Module]
    mean: np.ndarray
    std: np.ndarray
    convert: Optional[Callable[[Mapping[str, np.ndarray]], dict]]
    channels: Tuple[int, int, int, int]
    # True when `convert`'s output nests under the "net" child (SlicedStages).
    nested: bool = False
    # ViT families take one input size (their token grid is baked into the
    # position embedding); the discriminator resizes to it even without
    # interp224.
    fixed_input_res: Optional[int] = None


_REGISTRY: Dict[str, FeatureNetworkSpec] = {}


def register(name: str, make, mean, std, convert, channels, nested: bool = False,
             fixed_input_res: Optional[int] = None) -> None:
    _REGISTRY[name] = FeatureNetworkSpec(
        name=name, make=make, mean=np.asarray(mean, np.float32),
        std=np.asarray(std, np.float32), convert=convert, channels=tuple(channels),
        nested=nested, fixed_input_res=fixed_input_res)


def available() -> List[str]:
    return sorted(_REGISTRY)


def get_spec(name: str) -> FeatureNetworkSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown feature network '{name}'; available: {available()}")
    return _REGISTRY[name]


def make_feature_network(name: str, generator: Optional[torch.Generator] = None
                         ) -> Tuple[nn.Module, FeatureNetworkSpec]:
    """A registered 4-stage feature extractor, its weights drawn from
    ``generator``, and its spec."""
    spec = get_spec(name)
    return spec.make(generator=generator), spec


def convert_feature_network_state(name: str, state: Mapping[str, np.ndarray]) -> dict:
    """A pretrained torch/timm state dict → the variables of ``name``'s
    module as `make_feature_network` builds it (nested under ``net`` for
    the `SlicedStages` entries)."""
    spec = get_spec(name)
    if spec.convert is None:
        raise ValueError(f"{name} has no converter")
    variables = spec.convert(state)
    if spec.nested:
        variables = {coll: {"net": sub} for coll, sub in variables.items()}
    return variables


def _sliced(inner, take=(1, 2, 3, 4)):
    return lambda **kw: SlicedStages(inner, take=take, **kw)


def _register_defaults() -> None:
    from functools import partial

    from .alexnet import AlexNetFeatures, convert_alexnet_state
    from .clip import CLIPViTStages, convert_clip_visual_state
    from .clip_resnet import CLIPResNet50Stages, convert_clip_resnet_state
    from .densenet import DENSENET_BLOCKS, make_densenet
    from .deit import (DeiTFeatures, DeiTSmallFeatures, DeiTTinyFeatures, ViTBaseFeatures,
                       convert_deit)
    from .efficientnet import (EfficientNetB0Features, EfficientNetLite0Features,
                               convert_efficientnet_b0, convert_efficientnet_lite0,
                               make_efficientnet)
    from .mobilenet import (MNASNetStages, MobileNetV2Stages, convert_mnasnet_state,
                            convert_mobilenet_v2_state, mnasnet_channels)
    from .regnet import REGNET_PARAMS, make_regnet
    from .resnet import (BOTTLENECK_STAGES, ResNet18Stages, ResNet34Stages, ResNet50Stages,
                         ResNetBottleneckStages, convert_bottleneck_stages_state,
                         convert_resnet18_state, convert_resnet34_state,
                         convert_resnet50_state)
    from .shufflenet import ShuffleNetV2Stages, convert_shufflenet_state
    from .vgg import (VGG16Features, VGG19Features, convert_vgg16_state, convert_vgg19_state,
                      make_vgg)

    bottleneck = (256, 512, 1024, 2048)
    register("deit_base_distilled_patch16_224", DeiTFeatures, IMAGENET_MEAN, IMAGENET_STD,
             convert_deit, (96, 192, 384, 768), fixed_input_res=224)
    register("tf_efficientnet_lite0", EfficientNetLite0Features, INCEPTION_MEAN,
             INCEPTION_STD, convert_efficientnet_lite0, (24, 40, 112, 320))
    register("tf_efficientnet_b0", EfficientNetB0Features, IMAGENET_MEAN, IMAGENET_STD,
             convert_efficientnet_b0, (24, 40, 112, 320))
    # The compound-scaled ladder: b-series ImageNet statistics, lite Inception ones.
    for name in ("tf_efficientnet_b1", "tf_efficientnet_b2", "tf_efficientnet_b3",
                 "tf_efficientnet_b4", "tf_efficientnet_b0_ns", "tf_efficientnet_lite1",
                 "tf_efficientnet_lite2", "tf_efficientnet_lite3", "tf_efficientnet_lite4"):
        lite = "lite" in name
        register(name, *_ladder(make_efficientnet(name), lite))
    # timm 'efficientnet_b1': the b1 graph, normalised with Inception statistics.
    register("efficientnet_b1", *_ladder(make_efficientnet("tf_efficientnet_b1"), True))
    register("deit_small_distilled_patch16_224", DeiTSmallFeatures, IMAGENET_MEAN,
             IMAGENET_STD, convert_deit, (48, 96, 192, 384), fixed_input_res=224)
    register("deit_tiny_distilled_patch16_224", DeiTTinyFeatures, IMAGENET_MEAN, IMAGENET_STD,
             convert_deit, (24, 48, 96, 192), fixed_input_res=224)
    register("vit_base_patch16_224", ViTBaseFeatures, INCEPTION_MEAN, INCEPTION_STD,
             convert_deit, (96, 192, 384, 768), fixed_input_res=224)
    register("vgg16", _sliced(VGG16Features), IMAGENET_MEAN, IMAGENET_STD, convert_vgg16_state,
             (128, 256, 512, 512), nested=True)
    register("alexnet", _sliced(AlexNetFeatures), IMAGENET_MEAN, IMAGENET_STD,
             convert_alexnet_state, (192, 384, 256, 256), nested=True)
    register("resnet50", ResNet50Stages, IMAGENET_MEAN, IMAGENET_STD, convert_resnet50_state,
             bottleneck)
    for name in ("resnet101", "resnet152", "wide_resnet50_2", "wide_resnet101_2",
                 "seresnet50", "resnet26"):
        stages, se = BOTTLENECK_STAGES[name], name.startswith("seresnet")
        register(name, partial(ResNetBottleneckStages, stages=stages, se=se), IMAGENET_MEAN,
                 IMAGENET_STD, partial(convert_bottleneck_stages_state, stages=stages, se=se),
                 bottleneck)
    # timm -d variants: the deep 3×3 stem and the average-pool downsample.
    for name, base in (("resnet26d", "resnet26"), ("resnet50d", "resnet50")):
        stages = BOTTLENECK_STAGES[base]
        register(name, partial(ResNetBottleneckStages, stages=stages, deep_stem=True,
                               avg_down=True), IMAGENET_MEAN, IMAGENET_STD,
                 partial(convert_bottleneck_stages_state, stages=stages), bottleneck)
    register("resnet34", ResNet34Stages, IMAGENET_MEAN, IMAGENET_STD, convert_resnet34_state,
             (64, 128, 256, 512))
    register("resnet18", ResNet18Stages, IMAGENET_MEAN, IMAGENET_STD, convert_resnet18_state,
             (64, 128, 256, 512))
    register("vgg19", _sliced(VGG19Features), IMAGENET_MEAN, IMAGENET_STD, convert_vgg19_state,
             (128, 256, 512, 512), nested=True)
    for name in ("vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn"):
        make, convert = make_vgg(name)
        register(name, _sliced(make), IMAGENET_MEAN, IMAGENET_STD, convert,
                 (128, 256, 512, 512), nested=True)
    for name in DENSENET_BLOCKS:
        register(name, *_ladder(make_densenet(name), False))
    register("mobilenet_v2", MobileNetV2Stages, IMAGENET_MEAN, IMAGENET_STD,
             convert_mobilenet_v2_state, (24, 32, 96, 320))
    for alpha, name in ((0.5, "mnasnet0_5"), (1.0, "mnasnet1_0")):
        outs = mnasnet_channels(alpha)[1]
        register(name, partial(MNASNetStages, alpha=alpha), IMAGENET_MEAN, IMAGENET_STD,
                 convert_mnasnet_state, (outs[0], outs[1], outs[3], outs[5]))
    register("shufflenet_v2_x0_5", ShuffleNetV2Stages, IMAGENET_MEAN, IMAGENET_STD,
             convert_shufflenet_state, (24, 48, 96, 192))
    for name in REGNET_PARAMS:
        register(name, *_ladder(make_regnet(name), False))
    register("clip_vit_b32", CLIPViTStages, CLIP_MEAN, CLIP_STD, convert_clip_visual_state,
             (96, 192, 384, 768), fixed_input_res=224)
    register("resnet50_clip", CLIPResNet50Stages, CLIP_MEAN, CLIP_STD,
             convert_clip_resnet_state, (256, 512, 1024, 2048))


def _ladder(made, inception: bool):
    make, convert, channels = made
    return (make, INCEPTION_MEAN if inception else IMAGENET_MEAN,
            INCEPTION_STD if inception else IMAGENET_STD, convert, channels)


_register_defaults()

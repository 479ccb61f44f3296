"""Feature backbones of the port (NHWC in public), with torch-state-dict converters.

Parameter names follow the JAX package's flax paths (``conv0.kernel``, HWIO),
so `models.sg3.load_jax_variables` fills them from a flax variable tree.
"""

from .alexnet import AlexNetFeatures, convert_alexnet_state
from .inception import InceptionV3Features, convert_inception, inception_feature_fn
from .irse import IRSEBackbone, IRSEBody, convert_irse_state, get_blocks
from .resnet import (BasicBlock, Bottleneck, ResNet34Body, ResNet50Features,
                     convert_bottleneck_stages_state, convert_resnet34_body_state,
                     convert_resnet50_state)
from .squeezenet import Fire, SqueezeNetFeatures, convert_squeezenet_state
from .vgg import (VGG16Features, VGG19Features, VGGFeatures, convert_vgg16_state,
                  convert_vgg19_state)

__all__ = ["AlexNetFeatures", "convert_alexnet_state", "InceptionV3Features",
           "convert_inception", "inception_feature_fn", "IRSEBackbone", "IRSEBody",
           "convert_irse_state", "get_blocks", "BasicBlock", "Bottleneck", "ResNet34Body",
           "ResNet50Features", "convert_resnet34_body_state",
           "convert_bottleneck_stages_state", "convert_resnet50_state", "VGGFeatures", "VGG16Features",
           "VGG19Features", "convert_vgg16_state", "convert_vgg19_state", "Fire",
           "SqueezeNetFeatures", "convert_squeezenet_state"]

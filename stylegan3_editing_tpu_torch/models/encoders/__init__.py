"""ReStyle pSp / e4e inversion encoders (NHWC) on the IR(-SE) and ResNet-34 trunks."""

from .backbones import (INFERENCE_STAGE, BackboneEncoder, ProgressiveBackboneEncoder,
                        ResNetBackboneEncoder, ResNetProgressiveBackboneEncoder)
from .convert import convert_restyle_encoder_state, encoder_state_from_model_checkpoint
from .map2style import GradualStyleBlock
from .restyle import RestyleNet, get_average_image, run_restyle_iterations

__all__ = [
    "INFERENCE_STAGE",
    "convert_restyle_encoder_state",
    "encoder_state_from_model_checkpoint",
    "GradualStyleBlock",
    "BackboneEncoder",
    "ProgressiveBackboneEncoder",
    "ResNetBackboneEncoder",
    "ResNetProgressiveBackboneEncoder",
    "RestyleNet",
    "get_average_image",
    "run_restyle_iterations",
]

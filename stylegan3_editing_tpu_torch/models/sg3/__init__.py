"""Alias-free StyleGAN3 generator in PyTorch."""

from .config import SG3Config, build_synthesis_layout, sg3_r_config, sg3_t_config
from .from_jax import load_jax_variables, to_jax_variables
from .generator import Generator
from .layers import FullyConnected, MappingNetwork
from .synthesis import SynthesisInput, SynthesisLayer, SynthesisNetwork

__all__ = [
    "SG3Config",
    "build_synthesis_layout",
    "sg3_r_config",
    "sg3_t_config",
    "load_jax_variables",
    "to_jax_variables",
    "Generator",
    "FullyConnected",
    "MappingNetwork",
    "SynthesisInput",
    "SynthesisLayer",
    "SynthesisNetwork",
]

"""Signal-processing op core of the port (PyTorch, NHWC at the public functions).

Each op mirrors the JAX package's op of the same name. The filtered leaky
ReLU launches hand-written CUDA kernels for CUDA tensors, forward and
backward (`flrelu_cuda`); the rest are plain tensor ops. `banded_fir` holds
the banded-FIR probe's FIR in both of its forms, with a kernel each
(`fir_cuda`); `cuda_build` builds every kernel.
"""

from .bias_act import activation_funcs, bias_act
from .filter_design import design_lowpass_filter, setup_filter
from .filtered_lrelu import (choose_impl, filtered_lrelu, filtered_lrelu_bwd_ref,
                             filtered_lrelu_ref)
from .modulated_conv import modulated_conv2d
from .upfirdn2d import downsample2d, filter2d, upfirdn2d, upsample2d

__all__ = [
    "design_lowpass_filter",
    "setup_filter",
    "upfirdn2d",
    "filter2d",
    "upsample2d",
    "downsample2d",
    "bias_act",
    "activation_funcs",
    "choose_impl",
    "filtered_lrelu",
    "filtered_lrelu_ref",
    "filtered_lrelu_bwd_ref",
    "modulated_conv2d",
]

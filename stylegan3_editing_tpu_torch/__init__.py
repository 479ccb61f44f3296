"""StyleGAN3 editing framework in PyTorch and CUDA, for NVIDIA Hopper.

A port of the JAX package `stylegan3_editing_tpu`, which stays the
reference. It imports `torch`, numpy and scipy, and nothing of JAX or of the
JAX package. Image tensors are NHWC and conv weights HWIO at the public
functions, as in the JAX package. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

"""The hand-written CUDA kernels of the port against their plain versions, on the card.

These tests need a CUDA card and skip elsewhere: a CUDA kernel has no CPU
mode. They import nothing of JAX, so they run where only PyTorch is
installed (`tests/conftest.py` imports JAX; skip it there):

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from stylegan3_editing_tpu_torch.models.sg3 import build_synthesis_layout, sg3_r_config
from stylegan3_editing_tpu_torch.ops import filtered_lrelu
from stylegan3_editing_tpu_torch.ops import flrelu_cuda

# u=2 pad, u=4 crop, separable, separable crop, and a narrow-channel radial layer.
GEOMETRIES = ["L0_36_1024", "L2_52_1024", "L12_1044_64", "L13_1024_64", "L8_276_406"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layer(name):
    layout = build_synthesis_layout(sg3_r_config(1024))
    return next(s for s in layout.layers if s.name == name)


@pytest.mark.gpu
@pytest.mark.parametrize("name", GEOMETRIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flrelu_kernel_matches_plain(cuda_device, name, dtype):
    """fp32: atol = rtol = 1e-4 (sum order, cuDNN). bf16: one bf16 rounding
    of the output (rtol 2^-8, atol 1e-3) against the plain version in fp32 on
    the upcast input. Reduced spatial size, 2 images, ragged channel count."""
    s = _layer(name)
    rng = np.random.RandomState(7)
    hi = max(s.in_size[1] // 8, 40)
    c = min(s.out_channels, 45)
    x = torch.from_numpy(rng.randn(2, hi, hi + 5, c).astype(np.float32))
    b = torch.from_numpy(rng.randn(c).astype(np.float32))
    xd = x.to(cuda_device, getattr(torch, dtype))
    bd = b.to(cuda_device, xd.dtype)
    kw = dict(fu=s.up_filter, fd=s.down_filter, up=s.up_factor, down=s.down_factor,
              padding=s.padding, clamp=s.conv_clamp)
    before = flrelu_cuda.launches
    with torch.no_grad():
        got = filtered_lrelu(xd, b=bd, **kw)
        assert flrelu_cuda.launches == before + 1
        ref = filtered_lrelu(xd.float(), b=bd.float(), impl="ref", **kw)
    torch.cuda.synchronize()
    assert got.dtype == xd.dtype and got.shape == ref.shape
    atol, rtol = (1e-4, 1e-4) if dtype == "float32" else (1e-3, 2 ** -8)
    torch.testing.assert_close(got.float(), ref, atol=atol, rtol=rtol)


@pytest.mark.gpu
def test_flrelu_kernel_raises_instead_of_falling_back(cuda_device):
    s = _layer("L0_36_1024")
    x = torch.zeros((1, 36, 36, 8), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        flrelu_cuda.filtered_lrelu_cuda(x, s.up_filter, s.down_filter, None,
                                        s.up_factor, s.padding, 2 ** 0.5, 0.2, 256.0)
    x = torch.zeros((1, 36, 8, 36), device=cuda_device).transpose(2, 3)
    with pytest.raises(ValueError):
        flrelu_cuda.filtered_lrelu_cuda(x, s.up_filter, s.down_filter, None,
                                        s.up_factor, s.padding, 2 ** 0.5, 0.2, 256.0)

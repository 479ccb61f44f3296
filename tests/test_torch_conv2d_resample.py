"""Parity of the port's `conv2d_resample`, `device.conv_transpose2d` and the
``up=2`` modulated conv with the JAX package's, on the CPU.

Inputs come from numpy seeds; every kernel is drawn at random, so none is
symmetric, and a flip in the wrong place shows. The cases are the JAX
package's own (`tests/test_ops.py::TestConv2dResample`: all six paths,
both weight conventions, groups) plus odd sizes, a 4×4 kernel and a
padding past ``k - 1``.

Tolerance: 1e-5 of max |ref| (fp32 sum order of XLA's and cuDNN/oneDNN's
convolutions and FIR passes); `device.conv_transpose2d` against
`F.conv_transpose2d` in float64 to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.ops.conv2d_resample import conv2d_resample as jax_resample
from stylegan3_editing_tpu.ops.filter_design import setup_filter as jax_setup
from stylegan3_editing_tpu.ops.modulated_conv import modulated_conv2d as jax_modconv
from stylegan3_editing_tpu_torch.device import conv_transpose2d
from stylegan3_editing_tpu_torch.ops.conv2d_resample import conv2d_resample
from stylegan3_editing_tpu_torch.ops.filter_design import setup_filter
from stylegan3_editing_tpu_torch.ops.modulated_conv import modulated_conv2d

torch.set_num_threads(1)

TOL = 1e-5

CASES = [
    # (kh, up, down, padding, groups, flip_weight, size)
    (1, 1, 2, 0, 1, True, 16),    # 1×1 down-first
    (1, 2, 1, 0, 1, True, 16),    # 1×1 conv-first + up
    (3, 1, 2, 1, 1, True, 16),    # strided down conv
    (3, 2, 1, 1, 1, True, 16),    # transpose up conv
    (3, 2, 1, 1, 1, False, 16),   # transpose up, convolution convention
    (3, 2, 2, 1, 1, True, 16),    # up then down
    (3, 1, 1, 1, 1, True, 16),    # plain symmetric padding
    (3, 1, 1, (1, 0, 2, 1), 1, True, 16),  # generic fallback (asymmetric pad)
    (3, 2, 1, 1, 2, True, 16),    # grouped transpose up
    (3, 2, 1, 1, 1, False, 9),    # odd size, transpose up
    (4, 2, 1, 2, 1, True, 7),     # even kernel, odd size
    (3, 1, 2, 1, 2, False, 11),   # grouped strided down, odd size
]


@pytest.mark.parametrize("kh,up,down,padding,groups,flip_weight,size", CASES)
def test_conv2d_resample_matches_jax(kh, up, down, padding, groups, flip_weight, size):
    rng = np.random.RandomState(kh * 100 + up * 10 + down + groups + size)
    x = rng.randn(2, size, size + 1, 6).astype(np.float32)
    w = (rng.randn(kh, kh, 6 // groups, 4) * 0.3).astype(np.float32)
    taps = (rng.rand(4) + 0.1).astype(np.float32)
    want = np.asarray(jax_resample(jnp.asarray(x), jnp.asarray(w), f=jax_setup(taps), up=up,
                                   down=down, padding=padding, groups=groups,
                                   flip_weight=flip_weight))
    got = conv2d_resample(torch.from_numpy(x), torch.from_numpy(w), f=setup_filter(taps), up=up,
                          down=down, padding=padding, groups=groups,
                          flip_weight=flip_weight).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("h,w,k,padding", [(5, 7, 3, 2), (4, 4, 3, 0), (6, 5, 3, 3),
                                           (5, 5, 4, 1), (3, 6, 3, 1)])
@pytest.mark.parametrize("demodulate", [True, False])
def test_modulated_conv_up2_matches_jax(h, w, k, padding, demodulate):
    """``up=2``: a correlation with the 2×-dilated input (JAX's
    ``lhs_dilation``), including a padding past ``k - 1``."""
    rng = np.random.RandomState(h * 31 + w * 7 + k + padding)
    x = rng.randn(2, h, w, 4).astype(np.float32)
    wt = rng.randn(k, k, 4, 6).astype(np.float32)
    s = rng.randn(2, 4).astype(np.float32)
    want = np.asarray(jax_modconv(x, wt, s, demodulate=demodulate, padding=padding, up=2))
    got = modulated_conv2d(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(s),
                           demodulate=demodulate, padding=padding, up=2).numpy()
    assert got.shape == want.shape == (2, 2 * h + 2 * padding - k,
                                       2 * w + 2 * padding - k, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("case", [dict(stride=2, padding=0), dict(stride=2, padding=1, groups=2,
                                                                 output_padding=1),
                                  dict(stride=1, padding=(0, 1))])
def test_conv_transpose2d_gradients_match_pytorchs(case):
    """`device.conv_transpose2d`'s own backward gives `F.conv_transpose2d`'s
    output and gradients in float64, with and without a graph."""
    rng = np.random.RandomState(5)
    groups = case.get("groups", 1)
    x = torch.from_numpy(rng.randn(2, 4, 5, 6))
    w = torch.from_numpy(rng.randn(4, 3, 3, 2))
    b = torch.from_numpy(rng.randn(3 * groups))
    g, grads = None, []
    for fn in (conv_transpose2d, torch.nn.functional.conv_transpose2d):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        out = fn(*leaves, **case)
        g = torch.from_numpy(rng.randn(*out.shape)) if g is None else g
        (out * g).sum().backward()
        grads.append([out.detach()] + [t.grad for t in leaves])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=1e-12, rtol=1e-12)
    with torch.no_grad():
        torch.testing.assert_close(conv_transpose2d(x, w, b, **case), grads[1][0], atol=1e-12,
                                   rtol=1e-12)

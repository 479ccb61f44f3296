"""The forward kernel's tensor-core down pass, on the CPU.

On bf16 layers with a 12×12 fd the kernel computes the stride-2 down-FIR as
products of a constant operand W (`flrelu_cuda.mma_down_operand`: 16 outputs
of a 4×4 M-tile × 336 points of its window on the up grid) with the up grid,
each split into bf16 hi + lo (three products: hi·hi + hi·lo + lo·hi). The
kernel needs a card; here the operand, its window order and its split are
held against the plain down-FIR, and an emulation of the split arithmetic is
held against the JAX composition and the fp32 plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.ops.filtered_lrelu import filtered_lrelu as jax_filtered_lrelu
from stylegan3_editing_tpu_torch.models.sg3 import build_synthesis_layout, sg3_r_config
from stylegan3_editing_tpu_torch.ops import flrelu_cuda
from stylegan3_editing_tpu_torch.ops.bias_act import bias_act
from stylegan3_editing_tpu_torch.ops.filtered_lrelu import filtered_lrelu_ref
from stylegan3_editing_tpu_torch.ops.upfirdn2d import upfirdn2d

torch.set_num_threads(1)

RADIAL = [s for s in build_synthesis_layout(sg3_r_config(1024)).layers
          if s.down_filter is not None and s.down_filter.ndim == 2]
SLIM = {s.name: s for s in build_synthesis_layout(
    sg3_r_config(64, channel_base=2048, channel_max=64, num_layers=6)).layers}
BF16_TOL = (1e-3, 2 ** -8)  # (atol, rtol): one bf16 rounding of the output
SPLIT_TOL = 2 ** -14        # of max |ref|: the three-product split against fp32


def test_radial_layers_are_l0_to_l11():
    assert [s.name.split("_")[0] for s in RADIAL] == [f"L{i}" for i in range(12)]


def _mma_down(grid: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Apply W ``[16, K]`` to every M-tile's window of an up grid
    ``[1, H, W, C]``: the outputs ``[1, 4·th, 4·tw, C]`` of the th × tw
    M-tiles whose windows lie inside the grid."""
    _, h, wd, c = grid.shape
    t = flrelu_cuda.MMA_TILE
    th = (h - flrelu_cuda.MMA_WINDOW) // (2 * t) + 1
    tw = (wd - flrelu_cuda.MMA_WINDOW) // (2 * t) + 1
    ij, _ = flrelu_cuda.mma_down_window_offsets()
    rows = torch.from_numpy(2 * t * np.arange(th)[:, None, None] + ij[None, None, :, 0])
    cols = torch.from_numpy(2 * t * np.arange(tw)[None, :, None] + ij[None, None, :, 1])
    win = grid[0][rows, cols]                               # [th, tw, K, C]
    out = torch.einsum("mk,abkc->abmc", w.to(grid.dtype), win)
    out = out.reshape(th, tw, t, t, c).permute(0, 2, 1, 3, 4)
    return out.reshape(1, th * t, tw * t, c)


@pytest.mark.parametrize("s", RADIAL, ids=lambda s: s.name)
def test_operand_on_windows_is_the_stride2_correlation(s):
    """fp64: W on the gathered windows of a random up grid equals the port's
    ``upfirdn2d(down=2, f=fd)`` (which rounds fd to float32, as the kernel
    does) to 1e-12."""
    grid = torch.from_numpy(np.random.RandomState(0).randn(1, 74, 74, 3))
    w = torch.from_numpy(flrelu_cuda.mma_down_operand(s.down_filter))
    assert w.shape == (16, flrelu_cuda.MMA_K)
    got = _mma_down(grid, w)
    ref = upfirdn2d(grid, s.down_filter, down=2)
    assert got.shape == ref.shape == (1, 32, 32, 3)
    assert float((got - ref).abs().max()) <= 1e-12


@pytest.mark.parametrize("s", RADIAL, ids=lambda s: s.name)
def test_operand_split_rebuilds_w(s):
    """hi + lo rebuilds W to 2⁻¹⁶ of each entry; hi alone (plain bf16
    taps) is off by far more than that."""
    w = flrelu_cuda.mma_down_operand(s.down_filter)
    hi, lo = flrelu_cuda.bf16_split(w)
    assert hi.dtype == lo.dtype == np.uint16 and hi.shape == w.shape
    w_hi = flrelu_cuda.bf16_value(hi).astype(np.float64)
    rebuilt = w_hi + flrelu_cuda.bf16_value(lo)
    assert (np.abs(rebuilt - w) <= 2 ** -16 * np.abs(w)).all()
    assert np.abs(w_hi - w).max() > 2 ** -12 * np.abs(w).max()


def test_window_offsets_cover_the_window_once():
    ij, real = flrelu_cuda.mma_down_window_offsets()
    side = flrelu_cuda.MMA_WINDOW
    points = sorted(map(tuple, ij[real]))
    assert points == [(i, j) for i in range(side) for j in range(side)]
    assert (~real).sum() == flrelu_cuda.MMA_K - side * side
    assert (ij[~real, 0] == side - 1).all()  # padding reads a real row; W is zero there


def _emulate(x: torch.Tensor, b: torch.Tensor, s):
    """The kernel's arithmetic on a bf16 radial layer: the up grid in fp32,
    split into bf16 hi + lo; W split the same way; hi·hi + hi·lo + lo·hi
    with exact products (float64 here, fp32 sums on the card). Returns the
    fp32 output and the same with plain bf16 (hi·hi only)."""
    px0, px1, py0, py1 = s.padding
    a = upfirdn2d(bias_act(x, b), s.up_filter, up=s.up_factor,
                  padding=[px0, px1, py0, py1], gain=s.up_factor ** 2)
    a = bias_act(a, act="lrelu", alpha=0.2, gain=math.sqrt(2), clamp=s.conv_clamp)
    out_h, out_w = (a.shape[1] - 10) // 2, (a.shape[2] - 10) // 2
    t = 2 * flrelu_cuda.MMA_TILE
    side_h = t * -(-out_h // flrelu_cuda.MMA_TILE) + 10   # whole M-tiles; zeros past the grid
    side_w = t * -(-out_w // flrelu_cuda.MMA_TILE) + 10
    a = torch.nn.functional.pad(a, [0, 0, 0, side_w - a.shape[2], 0, side_h - a.shape[1]])
    a_hi = a.to(torch.bfloat16).float()
    a_lo = (a - a_hi).to(torch.bfloat16).float()
    hi, lo = (torch.from_numpy(flrelu_cuda.bf16_value(v)) for v in
              flrelu_cuda.bf16_split(flrelu_cuda.mma_down_operand(s.down_filter)))
    terms = [_mma_down(g.double(), m) for g, m in ((a_hi, hi), (a_lo, hi), (a_hi, lo))]
    crop = (slice(None), slice(0, out_h), slice(0, out_w))
    return (sum(terms)[crop].float(), terms[0][crop].float())


@pytest.mark.parametrize("name", ["L0_36_64", "L2_52_64"])
def test_emulated_split_arithmetic_matches_jax_and_fp32(name):
    """A slim bf16 radial layer (u=2 with padding, u=4 with a crop), on
    bf16-valued inputs scaled so that the clamp bites: the emulation,
    rounded to bf16 as the kernel stores it, agrees with the JAX composition
    ``filtered_lrelu(impl="xla")`` in fp32 within one bf16 rounding; before
    the rounding it agrees with the port's fp32 plain version to 2⁻¹⁴ of
    max |ref|, which plain bf16 products do not."""
    s = SLIM[name]
    assert s.use_bf16 and s.down_filter.ndim == 2
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 20, 23, 7).astype(np.float32) * 400)
    x = x.to(torch.bfloat16).float()
    b = torch.from_numpy(rng.randn(7).astype(np.float32) * 10).to(torch.bfloat16).float()
    kw = dict(fu=s.up_filter, fd=s.down_filter, up=s.up_factor, padding=s.padding,
              clamp=s.conv_clamp)
    got, plain_bf16 = _emulate(x, b, s)
    ref = filtered_lrelu_ref(x, b=b, down=2, **kw)
    want = np.asarray(jax_filtered_lrelu(jnp.asarray(x.numpy()), b=jnp.asarray(b.numpy()),
                                         down=2, impl="xla", **kw))
    assert got.shape == ref.shape == want.shape
    unclamped = filtered_lrelu_ref(x, b=b, down=2, **{**kw, "clamp": None})
    assert not torch.allclose(unclamped, ref, atol=1e-3), "the clamp is not exercised"
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(), want,
                               atol=BF16_TOL[0], rtol=BF16_TOL[1])
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= SPLIT_TOL * scale
    assert float((plain_bf16 - ref).abs().max()) > SPLIT_TOL * scale

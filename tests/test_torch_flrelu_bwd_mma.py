"""The backward kernel's tensor-core dy up pass, on the CPU.

On bf16 layers with a 12×12 fd the kernel computes dy's ×2 up-FIR as
products of a constant operand W (`flrelu_cuda.mma_up_operand`: 16 points of
a 4×4 M-tile of the up grid × the 64 pixels of the 8×8 dy window under it)
with dy, which is bf16 already; only W is split into bf16 hi + lo (two
products: hi·dy + lo·dy). The kernel needs a card; here the operand, its
window order, its split and its fragment layout are held against the plain
up-FIR, and an emulation of the split arithmetic inside a whole backward is
held against `jax.vjp` of the JAX composition and the fp32 plain version.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan3_editing_tpu.ops.filtered_lrelu import filtered_lrelu as jax_filtered_lrelu
from stylegan3_editing_tpu_torch.models.sg3 import build_synthesis_layout, sg3_r_config
from stylegan3_editing_tpu_torch.ops import flrelu_cuda
from stylegan3_editing_tpu_torch.ops.bias_act import bias_act
from stylegan3_editing_tpu_torch.ops.filtered_lrelu import filtered_lrelu_bwd_ref
from stylegan3_editing_tpu_torch.ops.upfirdn2d import upfirdn2d

torch.set_num_threads(1)

RADIAL = [s for s in build_synthesis_layout(sg3_r_config(1024)).layers
          if s.down_filter is not None and s.down_filter.ndim == 2]
SLIM = {s.name: s for s in build_synthesis_layout(
    sg3_r_config(64, channel_base=2048, channel_max=64, num_layers=6)).layers}
BF16_TOL = (1e-3, 2 ** -8)  # (atol, rtol): one bf16 rounding of dx
SPLIT_TOL = 2 ** -14        # of max |ref|: the two-product split against fp32
TILE = flrelu_cuda.UP_MMA_TILE


def _mma_up(dy: torch.Tensor, w: torch.Tensor, ppy0: int, ppx0: int, gh: int, gw: int):
    """W ``[16, K]`` applied to the dy window of every M-tile of a ``gh × gw``
    up grid whose first point sits at stuffed dy index ``(−ppy0, −ppx0)``, as
    the kernel lays its M-tiles (origins at multiples of 4): ``[1, gh, gw, C]``."""
    _, h, wd, c = dy.shape
    pad = 2 * flrelu_cuda.UP_MMA_WINDOW + max(ppy0, ppx0)
    dyp = torch.nn.functional.pad(dy, [0, 0, pad, pad + gw, pad, pad + gh])
    th, tw = -(-gh // TILE), -(-gw // TILE)
    ey, ex = ppy0 % 2, ppx0 % 2
    wv = flrelu_cuda.mma_up_window_offsets()
    row0 = (TILE * np.arange(th) - ppy0 - ey) // 2 + pad       # window origins in dy
    col0 = (TILE * np.arange(tw) - ppx0 - ex) // 2 + pad
    rows = torch.from_numpy(row0[:, None, None] + wv[None, None, :, 0])
    cols = torch.from_numpy(col0[None, :, None] + wv[None, None, :, 1])
    win = dyp[0][rows, cols]                                   # [th, tw, K, C]
    out = torch.einsum("mk,abkc->abmc", w.to(dy.dtype), win)
    out = out.reshape(th, tw, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    return out.reshape(1, th * TILE, tw * TILE, c)[:, :gh, :gw]


def test_radial_layers_are_l0_to_l11():
    assert [s.name.split("_")[0] for s in RADIAL] == [f"L{i}" for i in range(12)]


@pytest.mark.parametrize("s", RADIAL, ids=lambda s: s.name)
def test_up_operand_on_windows_is_the_x2_up_correlation(s):
    """fp64: W on the gathered dy windows equals the plain version's ×2 up
    pass ``upfirdn2d(dy, fd, up=2, flip_filter=True)`` (fd rounded to
    float32, as the kernel's) to 1e-12, for both stuffing parities per axis."""
    dy = torch.from_numpy(np.random.RandomState(0).randn(1, 14, 15, 3))
    for ppy0, ppx0 in ((11, 36), (36, 11)):
        ppy1, ppx1 = (-(28 + ppy0 - 11)) % 4 + 4, (-(30 + ppx0 - 11)) % 4
        ref = upfirdn2d(dy, s.down_filter, up=2, padding=[ppx0, ppx1, ppy0, ppy1],
                        flip_filter=True)
        w = torch.from_numpy(flrelu_cuda.mma_up_operand(s.down_filter, ppy0 % 2, ppx0 % 2))
        assert w.shape == (16, flrelu_cuda.UP_MMA_K)
        assert ((w != 0).sum(1) == 36).all(), "a point takes the 36 taps of its phase"
        got = _mma_up(dy, w, ppy0, ppx0, ref.shape[1], ref.shape[2])
        assert got.shape == ref.shape and ref.shape[1] % TILE == ref.shape[2] % TILE == 0
        assert float((got - ref).abs().max()) <= 1e-12


@pytest.mark.parametrize("s", RADIAL, ids=lambda s: s.name)
def test_up_operand_split_rebuilds_w(s):
    """hi + lo rebuilds W to 2⁻¹⁶ of each entry; hi alone (plain bf16 taps)
    is off by far more than that."""
    for ey, ex in ((0, 0), (1, 1)):
        w = flrelu_cuda.mma_up_operand(s.down_filter, ey, ex)
        hi, lo = flrelu_cuda.bf16_split(w)
        w_hi = flrelu_cuda.bf16_value(hi).astype(np.float64)
        rebuilt = w_hi + flrelu_cuda.bf16_value(lo)
        assert (np.abs(rebuilt - w) <= 2 ** -16 * np.abs(w)).all()
        assert np.abs(w_hi - w).max() > 2 ** -12 * np.abs(w).max()


def test_window_order_covers_the_window_once_in_row_pairs():
    wv = flrelu_cuda.mma_up_window_offsets()
    side = flrelu_cuda.UP_MMA_WINDOW
    assert sorted(map(tuple, wv)) == [(i, j) for i in range(side) for j in range(side)]
    # A B register holds k and k + 1 (k even): neighbours in one dy row.
    assert (wv[1::2, 0] == wv[0::2, 0]).all() and (wv[1::2, 1] == wv[0::2, 1] + 1).all()


def test_a_fragments_hold_each_entry_once_in_the_mma_layout():
    """Lane l, register r, step s: rows l // 4 (+ 8 for odd r), columns
    2·(l % 4) (+ 8 for r ≥ 2) and + 1 of the step's 16 columns, low half
    first; every entry of W lands in exactly one half-register."""
    w = np.arange(16 * 64, dtype=np.uint16).reshape(16, 64)
    frags = flrelu_cuda.mma_a_fragments(w)
    assert frags.shape == (4, 32, 4) and frags.dtype == np.uint32
    halves = np.concatenate([(frags & 0xFFFF).ravel(), (frags >> 16).ravel()])
    assert sorted(halves.tolist()) == list(range(16 * 64))
    s, lane, r = 2, 13, 3  # row 3 + 8, columns 2 + 8 and 11 of step 2
    assert frags[s, lane, r] == int(w[11, 32 + 10]) | (int(w[11, 32 + 11]) << 16)
    on = flrelu_cuda.mma_up_operand_on(RADIAL[5].down_filter, 1, 0, torch.device("cpu"))
    assert on.shape == (2, 4, 32, 4) and on.dtype == torch.int32
    hi, _ = flrelu_cuda.bf16_split(flrelu_cuda.mma_up_operand(RADIAL[5].down_filter, 1, 0))
    assert (on[0].numpy().view(np.uint32) == flrelu_cuda.mma_a_fragments(hi)).all()


def _bwd_with(g_fn, dy, x, b, s):
    """`filtered_lrelu_bwd_ref`'s arithmetic in fp32 with dy's up pass
    replaced by ``g_fn(ppy0, ppx0, gh, gw)``."""
    up, tu = s.up_factor, len(s.up_filter)
    px0, _, py0, _ = s.padding
    (_, xh, xw, _), (_, yh, yw, _) = x.shape, dy.shape
    ppy0 = flrelu_cuda.backward_padding(xh, yh, up, py0, tu, 12)[0]
    ppx0 = flrelu_cuda.backward_padding(xw, yw, up, px0, tu, 12)[0]
    a = upfirdn2d(bias_act(x, b), s.up_filter, up=up,
                  padding=[tu - 1, tu - up, tu - 1, tu - up], gain=up ** 2)
    g = g_fn(ppy0, ppx0, a.shape[1], a.shape[2]).float()
    factor = torch.where(a >= 0, 1.0, 0.2) * (math.sqrt(2) * up ** 2)
    pre = torch.where(a >= 0, a, a * 0.2) * math.sqrt(2)
    factor = torch.where(pre.abs() <= s.conv_clamp, factor, 0.0)
    return upfirdn2d(g * factor, s.up_filter, down=up, flip_filter=True)


@pytest.mark.parametrize("name", ["L0_36_64", "L2_52_64"])
def test_emulated_split_arithmetic_matches_jax_and_fp32(name):
    """A slim bf16 radial layer (u=2 with padding, u=4 with a crop), on
    bf16-valued inputs scaled so that the clamp bites: the emulation of the
    kernel (hi·dy + lo·dy, exact products, sums rounded to fp32), rounded
    to bf16 as the kernel stores dx, agrees with `jax.vjp` of the JAX
    composition ``filtered_lrelu(impl="xla")`` within one bf16 rounding;
    before the rounding it agrees with `filtered_lrelu_bwd_ref` in fp32 to
    2⁻¹⁴ of max |ref|, which plain bf16 taps do not."""
    s = SLIM[name]
    assert s.use_bf16 and s.down_filter.ndim == 2
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 20, 23, 7).astype(np.float32) * 400)
    x = x.to(torch.bfloat16).float()
    b = torch.from_numpy(rng.randn(7).astype(np.float32) * 10).to(torch.bfloat16).float()
    kw = dict(fu=s.up_filter, fd=s.down_filter, up=s.up_factor, padding=s.padding,
              clamp=s.conv_clamp)
    y, vjp = jax.vjp(lambda xc, bc: jax_filtered_lrelu(xc, b=bc, down=2, impl="xla", **kw),
                     jnp.asarray(x.numpy()), jnp.asarray(b.numpy()))
    dy = torch.from_numpy(rng.randn(*y.shape).astype(np.float32)).to(torch.bfloat16).float()
    want = np.asarray(vjp(jnp.asarray(dy.numpy()))[0])
    ref = filtered_lrelu_bwd_ref(dy, x, s.up_filter, s.down_filter, b, s.up_factor, s.padding,
                                 clamp=s.conv_clamp)
    unclamped = filtered_lrelu_bwd_ref(dy, x, s.up_filter, s.down_filter, b, s.up_factor,
                                       s.padding, clamp=None)
    assert not torch.allclose(unclamped, ref, atol=1e-3), "the clamp is not exercised"

    def split_g(hi_only):
        def g_fn(ppy0, ppx0, gh, gw):
            parts = flrelu_cuda.bf16_split(
                flrelu_cuda.mma_up_operand(s.down_filter, ppy0 % 2, ppx0 % 2))
            parts = parts[:1] if hi_only else parts
            return sum(_mma_up(dy.double(), torch.from_numpy(flrelu_cuda.bf16_value(p)),
                               ppy0, ppx0, gh, gw) for p in parts)
        return g_fn

    got = _bwd_with(split_g(False), dy, x, b, s)
    plain_bf16 = _bwd_with(split_g(True), dy, x, b, s)
    assert got.shape == ref.shape == want.shape == x.shape
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(), want,
                               atol=BF16_TOL[0], rtol=BF16_TOL[1])
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= SPLIT_TOL * scale
    assert float((plain_bf16 - ref).abs().max()) > SPLIT_TOL * scale

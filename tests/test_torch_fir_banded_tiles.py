"""The banded-FIR kernel's block schedule, emulated on the CPU.

`ops/csrc/fir_banded.cu` cuts J into column bands of at most 16 (one m-tile
of Mw), one block per (band, group of 8 channels); a block computes its
band's t = Mw·P row by row, then o = Mh·t per 16-row m-tile of Mh, each
product over the K steps that hold the m-tile's first to last non-zero
column (found on the device while the matrix is staged; a band fetches
only those columns of P, the rest of its K steps read zeros), with fp32
operands split into tf32 hi + lo. The kernel needs a
card; here a torch emulation of that schedule (bands, m-tiles, K ranges,
splits, an fp32 sum per K step) takes seeded numpy inputs and is held
against `fir_banded_ref` and the JAX probe's `kernel_mxu` in interpret mode,
at 1e-5 · max |ref| as on the card, on banded, dense, holed, zero-row and
single-entry matrices, with ragged last bands (J = 1, 17, 65).
"""

import importlib.util
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stylegan3_editing_tpu_torch.ops.banded_fir import banded, fir_banded_ref, hann_taps

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIR_TOL = 1e-5   # of max |ref|: sum order; the split tf32 products keep ~2^-22
BAND = 16        # fir_banded.cu kBand
REG_K = 4        # fir_banded.cu kRegK
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (J, I, taps): Qw = J + taps − 1, Qh = I + taps − 1; J = 65 is the probe's.
SHAPES = [(1, 3, 12), (17, 20, 12), (65, 65, 12)]
MATRICES = ["banded", "dense", "holed", "zero_row", "single"]
C = 10  # channels: one full group of 8 and a ragged one


def bands(j: int):
    """The kernel's column bands of J: ``[(j0, width), ...]``."""
    n = -(-j // BAND)
    width = -(-j // n)
    return [(j0, min(width, j - j0)) for j0 in range(0, j, width)]


def k_ranges(m: torch.Tensor, kk: int):
    """Per 16-row m-tile of ``m [rows, cols]``: (first, last) K step of width
    kk that holds a non-zero entry, or (None, None) for an all-zero tile."""
    out = []
    for r0 in range(0, m.shape[0], 16):
        cols = torch.nonzero(m[r0:r0 + 16].float().ne(0).any(0)).flatten()
        out.append((int(cols[0]) // kk, int(cols[-1]) // kk) if len(cols) else (None, None))
    return out


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 (cvt.rna: to nearest, ties away from zero)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x.float() - hi)


def _terms(a: torch.Tensor, b: torch.Tensor, eq: str, split_a: bool, split_b: bool):
    """One K step's product in float64 from the kernel's operands: each split
    operand as tf32 hi + lo, the lo·lo term dropped."""
    ah, al = split(a) if split_a else (a.float(), None)
    bh, bl = split(b) if split_b else (b.float(), None)
    out = torch.einsum(eq, ah.double(), bh.double())
    if split_b:
        out = out + torch.einsum(eq, ah.double(), bl.double())
    if split_a:
        out = out + torch.einsum(eq, al.double(), bh.double())
    return out


def emulate(p: torch.Tensor, mw: torch.Tensor, mh: torch.Tensor) -> torch.Tensor:
    """The kernel's schedule and arithmetic: fp32 ``[I, J, C]``."""
    f32 = p.dtype == torch.float32
    kk = 8 if f32 else 16
    qh, qw, c = p.shape
    i_out, j_out = mh.shape[0], mw.shape[0]
    kt1 = -(-qw // kk)
    pp = torch.nn.functional.pad(p, [0, 0, 0, kt1 * kk - qw])
    o = torch.zeros((i_out, j_out, c), dtype=torch.float32)
    mh_tiles = k_ranges(mh, 8)
    mh_pad = torch.nn.functional.pad(mh.float(), [0, -(-qh // 8) * 8 - qh])
    for j0, width in bands(j_out):
        a = torch.nn.functional.pad(mw[j0:j0 + width], [0, kt1 * kk - qw])
        (lo, hi), = k_ranges(a, kk)
        (w0, w1), = k_ranges(a, 1)  # the band's non-zero columns: the ones fetched
        pb = torch.zeros_like(pp)
        if w0 is not None:
            pb[:, w0:w1 + 1] = pp[:, w0:w1 + 1]
        t = torch.zeros((qh, width, c), dtype=torch.float32)
        for ks in range(lo, hi + 1) if lo is not None else ():
            cols = slice(ks * kk, (ks + 1) * kk)
            if f32:
                step = _terms(a[:, cols], pb[:, cols], "jk,qkc->qjc", True, True)
            else:  # bf16 products are exact
                step = torch.einsum("jk,qkc->qjc", a[:, cols].double(), pb[:, cols].double())
            t = (t.double() + step).float()
        tp = torch.nn.functional.pad(t, [0, 0, 0, 0, 0, mh_pad.shape[1] - qh])
        for m, (lo, hi) in enumerate(mh_tiles):
            rows = slice(16 * m, min(16 * m + 16, i_out))
            acc = torch.zeros((rows.stop - rows.start, width, c), dtype=torch.float32)
            for ks in range(lo, hi + 1) if lo is not None else ():
                k = slice(ks * 8, ks * 8 + 8)
                step = _terms(mh_pad[rows, k], tp[k], "iq,qjc->ijc", f32, True)
                acc = (acc.double() + step).float()
            o[rows, j0:j0 + width] = acc
    return o


def _matrix(kind: str, rows: int, cols: int, taps: np.ndarray, rng) -> np.ndarray:
    if kind == "dense":
        return rng.uniform(-1, 1, (rows, cols)).astype(np.float32)
    if kind == "single":  # one entry, at the last column of the second K step of 8
        m = np.zeros((rows, cols), np.float32)
        m[rows // 2, min(15, cols - 1)] = 0.75
        return m
    if kind == "holed":  # two taps, and one 40 columns on: all-zero K steps inside a range
        m = banded(rows, cols, taps[:2])
        r = np.arange(rows)[np.arange(rows) + 40 < cols]
        m[r, r + 40] = taps[-1]
        return m
    m = banded(rows, cols, taps)
    if kind == "zero_row":
        m[rows // 2] = 0
    return m


def _inputs(shape, kind, dtype, seed):
    j_out, i_out, n = shape
    qh, qw = i_out + n - 1, j_out + n - 1
    rng = np.random.RandomState(seed)
    p = rng.randn(qh, qw, C).astype(np.float32)
    mw = _matrix(kind, j_out, qw, hann_taps(n), rng)
    mh = _matrix(kind, i_out, qh, rng.uniform(0.1, 1.0, n).astype(np.float32), rng)
    dt = DTYPES[dtype][0]
    return tuple(torch.from_numpy(x).to(dt) for x in (p, mw, mh))


@pytest.fixture(scope="module")
def probe():
    """The JAX probe `scripts/exp_mxu_down.py`, its environment edits kept to copies
    (as in `test_torch_banded_fir.py`)."""
    spec = importlib.util.spec_from_file_location("jax_exp_mxu_down_tiles",
                                                  ROOT / "scripts" / "exp_mxu_down.py")
    module = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "environ", dict(os.environ))
        mp.setattr(sys, "path", list(sys.path))
        spec.loader.exec_module(module)
    return module


def _jax_mxu(probe, p, mw, mh):
    jdt = DTYPES[str(p.dtype)[6:]][1]
    p_j, mw_j, mh_j = (jnp.asarray(x.float().numpy(), jdt) for x in (p, mw, mh))

    def kernel(mw_ref, mh_ref, p_ref, o_ref):
        probe.kernel_mxu(p_ref, o_ref, mw=mw_ref[...], mh=mh_ref[...], acc_dtype=jnp.float32)

    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((mh.shape[0], mw.shape[0], p.shape[2]),
                                               jnp.float32),
        in_specs=[vmem] * 3, out_specs=vmem, interpret=True)(mw_j, mh_j, p_j))


def _assert_close(got, ref):
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= FIR_TOL * float(np.abs(ref).max()), err


def test_bands_partition_j():
    """For every J the kernel takes, the bands cover 0..J−1 once, at most 16
    wide, of equal width but the last, none empty."""
    for j in range(1, 129):
        bs = bands(j)
        assert [j0 for j0, _ in bs] == [sum(w for _, w in bs[:k]) for k in range(len(bs))]
        assert sum(w for _, w in bs) == j and all(1 <= w <= BAND for _, w in bs)
        assert len({w for _, w in bs[:-1]}) <= 1 and bs[-1][1] <= bs[0][1]
        assert len(bs) == -(-j // BAND)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_probe_k_ranges_fit_the_registers(dtype):
    """At the probe's [76, 76] with 12 taps, every band's Mw tile and every
    m-tile of Mh spans at most kRegK K steps, so a warp holds its A fragments
    in registers, and the products skip ~60 % of the dense steps."""
    taps = hann_taps(12)
    mw, mh = torch.from_numpy(banded(65, 76, taps)), torch.from_numpy(banded(65, 76, taps))
    kk = 8 if dtype == "float32" else 16
    first = [k_ranges(torch.nn.functional.pad(mw[j0:j0 + w], [0, -(-76 // kk) * kk - 76]), kk)[0]
             for j0, w in bands(65)]
    second = k_ranges(mh, 8)
    steps = [hi - lo + 1 for lo, hi in first + second]
    assert max(steps) <= REG_K
    dense = len(first) * -(-76 // kk) + len(second) * -(-76 // 8)
    assert sum(steps) <= 0.45 * dense


@pytest.mark.parametrize("kind", MATRICES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"J{s[0]}-I{s[1]}")
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_schedule_matches_plain_and_kernel_mxu(probe, shape, kind, dtype):
    p, mw, mh = _inputs(shape, kind, dtype, seed=MATRICES.index(kind) + 7 * shape[0])
    got = emulate(p, mw, mh).numpy()
    _assert_close(got, fir_banded_ref(p, mw, mh).numpy())
    _assert_close(got, _jax_mxu(probe, p, mw, mh))


def test_holed_matrices_have_all_zero_steps_inside_a_range():
    """The holed case skips nothing inside a range: its all-zero K steps lie
    between the first and the last, and are multiplied as zeros."""
    _, mw, _ = _inputs(SHAPES[2], "holed", "float32", seed=0)
    (lo, hi), = k_ranges(mw[:16], 8)
    inside = [bool(mw[:16, 8 * k:8 * k + 8].ne(0).any()) for k in range(lo, hi + 1)]
    assert inside[0] and inside[-1] and not all(inside)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_zero_tiles_give_zeros_and_skip_nonfinite_p(dtype):
    """An all-zero matrix has no K range: o is exactly 0. A NaN of P outside
    a band's non-zero columns stays out of its o, where the dense product
    spreads it everywhere."""
    p, mw, mh = _inputs(SHAPES[2], "banded", dtype, seed=3)
    assert float(emulate(p, torch.zeros_like(mw), mh).abs().max()) == 0
    p = p.clone()
    # Column 63 lies in a K step of the band at j 39..51 (columns 39..62) and
    # among the non-zero columns of the last band (j 52..64) only.
    p[0, 63, 0] = float("nan")
    got = emulate(p, mw, mh)
    assert bool(torch.isnan(fir_banded_ref(p, mw, mh)).all(dim=(0, 1))[0])
    assert bool(torch.isfinite(got[:, :52]).all()) and bool(torch.isnan(got[:, 52:, 0]).any())

"""The tap-chain kernel's plan and row schedule, emulated on the CPU.

`ops/csrc/fir_taps.cu` gives a block 64 bytes of each pixel (16 fp32 or 32
bf16 channels), one band of
output rows (with its Th − 1 halo of input rows) and one strip of at most
32 output columns (with its Tw − 1 halo of input columns), a thread per
(column, 16-byte slice of its pixels); the host narrows strips until a
block's ring of 128-byte-aligned row stages (and, for Th other than 12, the
threads' rings of t) fit a shared-memory target, and cuts bands where the
channel groups and strips alone would not fill the card. A block streams its input rows once, top to
bottom, through a ring of row stages; for each row a thread sums its
column's W chain into t and feeds t to the H chains of the Th output rows
that need it: with 12 taps as running sums in a ring of registers rotated by
q % Th, otherwise from its own ring of t at slot q % Th; output row i is
stored as soon as row i + Th − 1 has landed. Each chain runs in tap order
with one rounding per tap (fmaf). The kernel needs a card; here a torch
emulation of that plan and schedule (the rule and constants mirrored from
the `.cu` under the same names) takes seeded numpy inputs and is held
against `fir_taps_ref` and the JAX probe's `kernel_vpu` in interpret mode,
at 1e-5 · max |ref| as on the card, with 1, 4, 12 and 64 taps, Tw ≠ Th,
Tw = Qw, the probe's 76 × 76 at a small C, and ragged last bands and strips.
"""

import functools
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

from stylegan3_editing_tpu_torch.ops.banded_fir import fir_taps_ref, hann_taps

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FIR_TOL = 1e-5           # of max |ref|: the sum order of the chains
# fir_taps.cu's plan constants.
kThreads = 128           # at most, a block: a thread per (column, slice) of a strip
kPixelBytes = 64         # of a pixel, a block's channels: 16 fp32 or 32 bf16
kSlices = 4              # 16-byte slices of those: threads per column
kStages = 8              # input rows in the ring
kRegTh = 12              # H taps whose running sums stay in registers
kSmemTarget = 113_664    # bytes per block: two blocks share an SM
kFillBlocks = 4 * 132    # blocks that fill an H100 four deep
kMinBand = 4             # output rows of a band, at least (unless fewer)
kBarBytes = 128          # the stages' mbarriers, ahead of the 128-byte-aligned stages
DTYPES = {"float32": (torch.float32, jnp.float32, 4), "bfloat16": (torch.bfloat16, jnp.bfloat16, 2)}
PROBE = (76, 76, 16896)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_at(k: int, n: int, length: int) -> int:
    """First element of part k of n of [0, length): the parts differ by one at most."""
    return k * length // n


def pitch_for(strip_w: int, tw: int) -> int:
    """Bytes of a stage: strip_w + tw − 1 pixels of kPixelBytes, to 128 bytes."""
    return cdiv((strip_w + tw - 1) * kPixelBytes, 128) * 128


def smem_for(strip_w: int, tw: int, th: int, esize: int) -> int:
    """The stages' mbarriers, the stages, and the threads' rings of th values
    of t where the H chains do not run in registers."""
    ring = 0 if th == kRegTh else th * strip_w * (kPixelBytes // esize) * 4
    return kBarBytes + kStages * pitch_for(strip_w, tw) + ring


def make_plan(qh: int, qw: int, c: int, tw: int, th: int, esize: int) -> dict:
    """fir_taps.cu's `make_plan`: strips, their widest width, and bands."""
    out_h, out_w = qh - th + 1, qw - tw + 1
    widest = kThreads // kSlices
    while widest > 1 and smem_for(widest, tw, th, esize) > kSmemTarget:
        widest -= 1
    strips = cdiv(out_w, widest)
    cb = kPixelBytes // esize  # channels per block
    groups = cdiv(c, cb)
    bands = min(cdiv(kFillBlocks, groups * strips), cdiv(out_h, kMinBand))
    return dict(out_h=out_h, out_w=out_w, strips=strips, strip_w=cdiv(out_w, strips),
                bands=bands, groups=groups, cb=cb)


def blocks(g: dict, c: int):
    """Each block's (c0, channels, i0, output rows, j0, output columns), in
    the grid's order: strips fastest, then bands, then channel groups."""
    for x in range(g["groups"] * g["bands"] * g["strips"]):
        strip, band = x % g["strips"], x // g["strips"] % g["bands"]
        c0 = x // (g["strips"] * g["bands"]) * g["cb"]
        j0, i0 = split_at(strip, g["strips"], g["out_w"]), split_at(band, g["bands"], g["out_h"])
        yield (c0, min(g["cb"], c - c0), i0, split_at(band + 1, g["bands"], g["out_h"]) - i0,
               j0, split_at(strip + 1, g["strips"], g["out_w"]) - j0)


def fma_step(acc: torch.Tensor, tap, x: torch.Tensor) -> torch.Tensor:
    """fmaf(tap, x, acc) in fp32: the product of two fp32 values is exact in fp64."""
    return (acc.double() + float(tap) * x.double()).float()


def emulate(p: torch.Tensor, taps_w: np.ndarray, taps_h: np.ndarray) -> torch.Tensor:
    """The kernel's plan, rings and chains: fp32 ``[Qh − Th + 1, Qw − Tw + 1, C]``."""
    qh, qw, c = p.shape
    tw, th = len(taps_w), len(taps_h)
    g = make_plan(qh, qw, c, tw, th, p.element_size())
    o = torch.full((g["out_h"], g["out_w"], c), float("nan"))
    for c0, nch, i0, out_rows, j0, cols in blocks(g, c):
        rows, cols_in = out_rows + th - 1, cols + tw - 1
        assert i0 + rows <= qh and j0 + cols_in <= qw and cols <= kThreads // kSlices
        stage = [None] * kStages
        ring = torch.zeros((th, cols, nch))  # running sums (th = 12) or t (other th)

        def fetch(r):
            if r < rows:
                stage[r % kStages] = (r, p[i0 + r, j0:j0 + cols_in, c0:c0 + nch].float())

        for r in range(kStages - 1):
            fetch(r)
        for q in range(rows):
            r, row = stage[q % kStages]
            assert r == q  # the ring holds row q when its W chain runs
            fetch(q + kStages - 1)  # into row q - 1's stage, read by everyone before q
            t = torch.zeros((cols, nch))
            for k in range(tw):  # every thread's W chain at its column
                t = fma_step(t, taps_w[k], row[k:k + cols])
            i = q - th + 1
            if th == kRegTh:  # output row i' takes th[q - i'] * t in slot i' % th
                for k in range(th):
                    ring[(q - k) % th] = fma_step(ring[(q - k) % th], taps_h[k], t)
                done, ring[(q + 1) % th] = ring[(q + 1) % th].clone(), 0.0
            else:
                ring[q % th] = t
                if i >= 0:
                    done = torch.zeros((cols, nch))
                    for k in range(th):
                        done = fma_step(done, taps_h[k], ring[(i + k) % th])
            if i >= 0:
                o[i0 + i, j0:j0 + cols, c0:c0 + nch] = done
    return o


# (Qh, Qw, C, Tw, Th, what it exercises)
CASES = [
    (20, 21, 8, 12, 9, "Tw != Th"),
    (37, 29, 45, 4, 1, "ragged channel group, one H tap"),
    (12, 12, 6, 1, 1, "one tap each"),
    (76, 76, 20, 12, 12, "the probe's plane at a small C"),
    (66, 92, 8, 64, 64, "64 taps: strips of a ragged last width"),
    (66, 40, 17, 40, 3, "Tw = Qw: one output column"),
    (9, 30, 16, 5, 9, "Th = Qh: one output row"),
    (50, 23, 33, 4, 12, "ragged bands"),
]


@pytest.fixture(scope="module")
def probe():
    """The JAX probe `scripts/exp_mxu_down.py`, its environment edits kept to copies
    (as in `test_torch_banded_fir.py`)."""
    spec = importlib.util.spec_from_file_location("jax_exp_mxu_down_taps_tiles",
                                                  ROOT / "scripts" / "exp_mxu_down.py")
    module = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "environ", dict(os.environ))
        mp.setattr(sys, "path", list(sys.path))
        spec.loader.exec_module(module)
    return module


def _jax_vpu(probe, p: torch.Tensor, taps_w, taps_h) -> np.ndarray:
    i_out, j_out = p.shape[0] - len(taps_h) + 1, p.shape[1] - len(taps_w) + 1
    p_jax = jnp.asarray(p.float().numpy(), DTYPES[str(p.dtype)[6:]][1])
    kernel = functools.partial(probe.kernel_vpu, taps_w=taps_w, taps_h=taps_h, i_out=i_out,
                               j_out=j_out)
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((i_out, j_out, p.shape[2]), jnp.float32),
        in_specs=[vmem], out_specs=vmem, interpret=True)(p_jax))


def _assert_close(got, ref):
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= FIR_TOL * float(np.abs(ref).max()), err


def _covered(qh, qw, c, tw, th, esize) -> np.ndarray:
    g = make_plan(qh, qw, c, tw, th, esize)
    hits = np.zeros((g["out_h"], g["out_w"], g["groups"]), np.int32)
    for c0, nch, i0, rows, j0, cols in blocks(g, c):
        assert rows >= 1 and cols >= 1 and 1 <= nch <= g["cb"]
        hits[i0:i0 + rows, j0:j0 + cols, c0 // g["cb"]] += 1
    return hits


@pytest.mark.parametrize("shape", [PROBE, (76, 76, 128)], ids=["76x76x16896", "76x76x128"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bands_and_strips_cover_every_output_once(shape, dtype):
    """At the probe's planes every output of every channel group is one
    block's, exactly once. At [76, 76, 16896] a block holds a whole band of
    76 input rows (the plane crosses device memory once) and one of three
    strips of 22, 22 and 21 columns (a thread per column and 16-byte slice;
    64 bytes of a pixel a block: 1,056 groups of 16 fp32 channels, 528 of 32
    bf16); at [76, 76, 128] bands of 3 or 4 rows give 408 (fp32) or 204
    (bf16) blocks, where the channel groups alone would leave most of the 132
    SMs idle."""
    esize = DTYPES[dtype][2]
    assert (_covered(*shape, 12, 12, esize) == 1).all()
    g = make_plan(*shape, 12, 12, esize)
    assert smem_for(g["strip_w"], 12, 12, esize) <= kSmemTarget
    groups = 1056 if shape == PROBE else 8
    if esize == 2:
        groups //= 2
    bands = 1 if shape == PROBE else 17
    assert (g["bands"], g["strips"], g["groups"]) == (bands, 3, groups)


def test_plan_fits_and_covers_every_shape_the_kernel_takes():
    """Over a sweep of shapes and tap counts (1..64, Tw != Th, wide rows):
    every output once, stages and t ring within the target, bands and strips
    of even sizes (within one of each other)."""
    rng = np.random.RandomState(0)
    for _ in range(60):
        tw, th = rng.randint(1, 65, 2)
        qh, qw = th + rng.randint(0, 60), tw + rng.choice([0, 5, 100, 700])
        c = int(rng.choice([1, 8, 45, 200]))
        for esize in (4, 2):
            assert (_covered(qh, qw, c, tw, th, esize) == 1).all()
            g = make_plan(qh, qw, c, tw, th, esize)
            assert smem_for(g["strip_w"], tw, th, esize) <= kSmemTarget
            sizes = {split_at(k + 1, g["bands"], g["out_h"]) - split_at(k, g["bands"], g["out_h"])
                     for k in range(g["bands"])}
            assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("case", CASES, ids=[c[5] for c in CASES])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_schedule_matches_plain_and_kernel_vpu(probe, case, dtype):
    qh, qw, c, tw, th, _ = case
    rng = np.random.RandomState(qh * 31 + tw)
    p = torch.from_numpy(rng.randn(qh, qw, c).astype(np.float32)).to(DTYPES[dtype][0])
    taps_w = hann_taps(tw) if tw > 1 else np.ones(1, np.float32)
    taps_h = rng.uniform(0.1, 1.0, th).astype(np.float32)
    got = emulate(p, taps_w, taps_h).numpy()
    assert np.isfinite(got).all()
    _assert_close(got, fir_taps_ref(p, taps_w, taps_h).numpy())
    _assert_close(got, _jax_vpu(probe, p, taps_w, taps_h))


def test_ragged_cases_have_ragged_bands_and_strips():
    """The cases above reach what they are named for: strips at 64 taps, an
    uneven band split, and bands at the probe's plane at a small C."""
    for esize in (4, 2):
        g = make_plan(66, 92, 8, 64, 64, esize)
        assert g["strips"] > 1 and g["out_w"] % g["strips"] != 0
    g = make_plan(50, 23, 33, 4, 12, 2)
    assert g["bands"] > 1 and g["out_h"] % g["bands"] != 0
    assert make_plan(76, 76, 20, 12, 12, 4)["bands"] > 1

"""Parity of the port's banded-FIR probe with the JAX package's probe.

The same inputs, made with numpy from a seed, go through the TPU kernels of
`scripts/exp_mxu_down.py` (`kernel_vpu`, `kernel_mxu`) under
`pl.pallas_call(..., interpret=True)` and through the port's plain versions
(`fir_taps_ref`, `fir_banded_ref`), which the CUDA kernels are held against on
the card (`test_torch_kernels_gpu.py`). Tolerance: max abs err ≤ 1e-5 ·
max |ref| in fp32 and bf16 (sums in another order; TF32 alone, ~4.9e-4, or a
bf16-rounded intermediate, ~2e-3, would not meet it).
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

from stylegan3_editing_tpu_torch.ops.banded_fir import (banded, fir_banded_ref, fir_taps_ref,
                                                        hann_taps)
from stylegan3_editing_tpu_torch.scripts import exp_mxu_down

ROOT = Path(__file__).resolve().parents[1]
CACHE_KEY = "JAX_COMPILATION_CACHE_DIR"
CACHE_BEFORE = os.environ.get(CACHE_KEY)
FIR_TOL = 1e-5  # of max |ref|
# (Qh, Qw, C), taps: J = Qw − taps + 1 off the multiples of 8 and 16.
CASES = [((20, 20, 8), 12), ((24, 30, 16), 4)]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def probe():
    """`scripts/exp_mxu_down.py` as a module. Its import sets
    JAX_COMPILATION_CACHE_DIR (setdefault) and prepends to sys.path; both land
    on copies that are dropped afterwards, so the tests after these, in this
    worker, and the subprocesses they start do not inherit them."""
    spec = importlib.util.spec_from_file_location("jax_exp_mxu_down",
                                                  ROOT / "scripts" / "exp_mxu_down.py")
    module = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "environ", dict(os.environ))
        mp.setattr(sys, "path", list(sys.path))
        spec.loader.exec_module(module)
    return module


def _inputs(case, dtype, seed):
    """The plane (torch, and the same values in JAX) and distinct W and H taps."""
    (qh, qw, c), n = case
    rng = np.random.RandomState(seed)
    p = torch.from_numpy(rng.randn(qh, qw, c).astype(np.float32)).to(DTYPES[dtype][0])
    p_jax = jnp.asarray(p.float().numpy(), DTYPES[dtype][1])  # exact: the values are p's
    taps_w = hann_taps(n)
    taps_h = rng.uniform(0.1, 1.0, n).astype(np.float32)
    return p, p_jax, taps_w, taps_h


def _matrices(case, taps_w, taps_h, dtype):
    """Mw [J, Qw] and Mh [I, Qh] in the plane's dtype, for both frameworks."""
    (qh, qw, _), n = case
    mw = torch.from_numpy(banded(qw - n + 1, qw, taps_w)).to(DTYPES[dtype][0])
    mh = torch.from_numpy(banded(qh - n + 1, qh, taps_h)).to(DTYPES[dtype][0])
    return (mw, mh), tuple(jnp.asarray(m.float().numpy(), DTYPES[dtype][1]) for m in (mw, mh))


def _vmem():
    return pl.BlockSpec(memory_space=pltpu.VMEM)


def _jax_vpu(probe, p, taps_w, taps_h):
    i_out, j_out = p.shape[0] - len(taps_h) + 1, p.shape[1] - len(taps_w) + 1
    kernel = functools.partial(probe.kernel_vpu, taps_w=taps_w, taps_h=taps_h, i_out=i_out,
                               j_out=j_out)
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((i_out, j_out, p.shape[2]), jnp.float32),
        in_specs=[_vmem()], out_specs=_vmem(), interpret=True)(p))


def _jax_mxu(probe, p, mw, mh):
    # The matrices go in as inputs: as the script closes over them,
    # pallas_call refuses the captured constants.
    def kernel(mw_ref, mh_ref, p_ref, o_ref):
        probe.kernel_mxu(p_ref, o_ref, mw=mw_ref[...], mh=mh_ref[...], acc_dtype=jnp.float32)

    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((mh.shape[0], mw.shape[0], p.shape[2]),
                                               jnp.float32),
        in_specs=[_vmem()] * 3, out_specs=_vmem(), interpret=True)(mw, mh, p))


def _assert_close(got, ref):
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= FIR_TOL * float(np.abs(ref).max()), err


def test_loading_the_probe_leaves_the_environment(probe):
    assert callable(probe.kernel_mxu)
    assert os.environ.get(CACHE_KEY) == CACHE_BEFORE


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("n", [4, 12])
def test_banded_matches_probe(probe, stride, n):
    taps = hann_taps(n)
    for j_out, q_in in ((10, 21), (33, 76), (5, 9)):
        np.testing.assert_array_equal(banded(j_out, q_in, taps, stride),
                                      probe.banded(j_out, q_in, taps, stride))


def test_hann_taps_are_the_probes():
    np.testing.assert_array_equal(hann_taps(12), np.hanning(14)[1:-1].astype(np.float32))
    assert hann_taps(12).dtype == np.float32


@pytest.mark.parametrize("case", CASES, ids=["20x20x8-12", "24x30x16-4"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fir_taps_ref_matches_kernel_vpu(probe, case, dtype):
    p, p_jax, taps_w, taps_h = _inputs(case, dtype, seed=0)
    got = fir_taps_ref(p, taps_w, taps_h)
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), _jax_vpu(probe, p_jax, taps_w, taps_h))


@pytest.mark.parametrize("case", CASES, ids=["20x20x8-12", "24x30x16-4"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fir_banded_ref_matches_kernel_mxu(probe, case, dtype):
    p, p_jax, taps_w, taps_h = _inputs(case, dtype, seed=1)
    (mw, mh), (mw_jax, mh_jax) = _matrices(case, taps_w, taps_h, dtype)
    got = fir_banded_ref(p, mw, mh)
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), _jax_mxu(probe, p_jax, mw_jax, mh_jax))


@pytest.mark.parametrize("case", CASES, ids=["20x20x8-12", "24x30x16-4"])
def test_bf16_forms_differ_as_the_jax_kernels_do(probe, case):
    """In bf16 the chains take fp32 taps, the products bf16-rounded ones: the
    two forms differ by the taps' rounding, the same in both frameworks, and
    the probe's `rel err vpu vs mxu` agrees within a factor of 2."""
    p, p_jax, taps_w, taps_h = _inputs(case, "bfloat16", seed=2)
    (mw, mh), (mw_jax, mh_jax) = _matrices(case, taps_w, taps_h, "bfloat16")
    vpu, mxu = fir_taps_ref(p, taps_w, taps_h).numpy(), fir_banded_ref(p, mw, mh).numpy()
    jvpu, jmxu = _jax_vpu(probe, p_jax, taps_w, taps_h), _jax_mxu(probe, p_jax, mw_jax, mh_jax)
    # Each form is within FIR_TOL·max |ref| of its JAX kernel, so the gap is within twice that.
    assert np.abs((vpu - mxu) - (jvpu - jmxu)).max() <= 2 * FIR_TOL * np.abs(jvpu).max()
    rel = np.abs(vpu - mxu).max() / np.abs(vpu).max()
    rel_jax = np.abs(jvpu - jmxu).max() / np.abs(jvpu).max()
    assert rel_jax > 1e-4  # the forms really differ in bf16
    assert 0.5 <= rel / rel_jax <= 2


def test_fp32_forms_agree():
    p, _, taps_w, taps_h = _inputs(CASES[0], "float32", seed=3)
    (mw, mh), _ = _matrices(CASES[0], taps_w, taps_h, "float32")
    _assert_close(fir_banded_ref(p, mw, mh).numpy(), fir_taps_ref(p, taps_w, taps_h).numpy())


TINY = ["--qh", "20", "--qw", "21", "--c", "8", "--taps", "4", "--iters", "1"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_probe_cli_runs_on_cpu(capsys, dtype):
    y_vpu, y_mxu = exp_mxu_down.main(TINY + ["--dtype", dtype, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"planes [20,21,8] {dtype}, taps 4, out [17,18,8], device cpu"
    assert lines[1].startswith("vpu-chain ") and lines[1].endswith(" ms/call")
    assert lines[2].startswith("mxu-dot ") and lines[2].endswith(" ms/call")
    assert lines[3].startswith("rel err vpu vs mxu: ")
    assert y_vpu.shape == y_mxu.shape == (17, 18, 8) and y_vpu.dtype == torch.float32
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    p = torch.randn((20, 21, 8), generator=torch.Generator().manual_seed(0)).to(dt)
    taps = hann_taps(4)
    torch.testing.assert_close(y_vpu, fir_taps_ref(p, taps, taps), rtol=0, atol=0)
    rel = float(lines[3].split(":")[1])
    assert (rel <= FIR_TOL) if dtype == "f32" else (1e-4 < rel < 1e-2)


def test_probe_cli_without_a_card_raises_unless_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        exp_mxu_down.main(TINY)
    with pytest.raises(RuntimeError):
        exp_mxu_down.main(TINY + ["--device", "cuda"])
    assert capsys.readouterr().out == ""
    exp_mxu_down.main(TINY + ["--device", "cpu"])
    assert capsys.readouterr().out.startswith("planes [20,21,8] f32")

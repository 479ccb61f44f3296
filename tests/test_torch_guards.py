"""Guards of the PyTorch port: no JAX at run time, no quiet CPU or plain fallback."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stylegan3_editing_tpu_torch.models.sg3 import Generator, sg3_r_config
from stylegan3_editing_tpu_torch.models.sg3.config import build_synthesis_layout
from stylegan3_editing_tpu_torch.ops import cuda_build, fir_cuda, flrelu_cuda
from stylegan3_editing_tpu_torch.device import kernel_or_plain
from stylegan3_editing_tpu_torch.ops.banded_fir import (banded, fir_banded, fir_banded_ref,
                                                        fir_taps, fir_taps_ref, hann_taps)
from stylegan3_editing_tpu_torch.ops.filtered_lrelu import choose_impl

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "flax", "stylegan3_editing_tpu"}
PORT_FILES = sorted((ROOT / "stylegan3_editing_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_port_import_leaves_jax_unloaded():
    code = ("import sys, json; import stylegan3_editing_tpu_torch.models.sg3, "
            "stylegan3_editing_tpu_torch.ops, stylegan3_editing_tpu_torch.criteria, "
            "stylegan3_editing_tpu_torch.inversion, "
            "stylegan3_editing_tpu_torch.scripts.exp_mxu_down; "
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax', 'stylegan3_editing_tpu'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_generator_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = sg3_r_config(32, channel_base=1024, channel_max=32, num_layers=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Generator(cfg)
    with pytest.raises(RuntimeError):
        Generator(cfg, device="cuda")


def _specs():
    layers = build_synthesis_layout(sg3_r_config(1024)).layers
    return [s for s in layers if s.up_filter is not None], layers[-1]


@pytest.mark.parametrize("device_type,impl,expected", [
    ("cuda", "auto", "cuda"), ("cpu", "auto", "ref"), ("cuda", "ref", "ref"),
    ("cpu", "ref", "ref")])
def test_dispatch_by_device_type(device_type, impl, expected):
    flrelu_layers, torgb = _specs()
    assert len(flrelu_layers) == 14
    for s in flrelu_layers:
        assert choose_impl(device_type, s.up_filter, s.down_filter, s.up_factor,
                           s.down_factor, impl=impl) == expected, s.name
    # ToRGB (up = down = 1, no filters) is outside the kernel's envelope.
    assert choose_impl(device_type, torgb.up_filter, torgb.down_filter,
                       torgb.up_factor, torgb.down_factor, impl=impl) == "ref"


def test_dispatch_rejects_other_devices_and_impls():
    s = _specs()[0][0]
    with pytest.raises(ValueError):
        choose_impl("mps", s.up_filter, s.down_filter, 2, 2)
    with pytest.raises(ValueError):
        choose_impl("cuda", s.up_filter, s.down_filter, 2, 2, impl="xla")


def test_kernel_wrapper_refuses_cpu_tensors():
    s = _specs()[0][0]
    x = torch.zeros((1, 36, 36, 4))
    with pytest.raises(ValueError, match="CUDA"):
        flrelu_cuda.filtered_lrelu_cuda(x, s.up_filter, s.down_filter, None, 2,
                                        s.padding, 2 ** 0.5, 0.2, 256.0)


def test_bwd_kernel_wrapper_refuses_cpu_tensors():
    s = _specs()[0][0]
    x = torch.zeros((1, 36, 36, 4))
    with pytest.raises(ValueError, match="CUDA"):
        flrelu_cuda.filtered_lrelu_bwd_cuda(x, x, s.up_filter, s.down_filter, None, 2,
                                            s.padding, 2 ** 0.5, 0.2, 256.0)


def test_kernel_output_size_matches_layout():
    for s in _specs()[0]:
        tu, td = len(s.up_filter), s.down_filter.shape[0]
        px0, px1, py0, py1 = s.padding
        assert flrelu_cuda.output_size(s.in_size[1], s.up_factor, py0, py1, tu, td) \
            == s.out_size[1]
        assert flrelu_cuda.output_size(s.in_size[0], s.up_factor, px0, px1, tu, td) \
            == s.out_size[0]
        assert np.ndim(s.down_filter) == (2 if s.down_radial else 1)


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Without a card it exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_fir_kernel_wrappers_refuse_cpu_tensors():
    p, taps = torch.zeros((20, 21, 8)), hann_taps(4)
    with pytest.raises(ValueError, match="CUDA"):
        fir_cuda.fir_taps_cuda(p, taps, taps)
    with pytest.raises(ValueError, match="CUDA"):
        fir_cuda.fir_banded_cuda(p, torch.zeros((18, 21)), torch.zeros((17, 20)))


@pytest.mark.parametrize("device_type,impl,expected", [
    ("cuda", "auto", "cuda"), ("cpu", "auto", "ref"), ("cuda", "ref", "ref"),
    ("cpu", "ref", "ref")])
def test_fir_dispatch_by_device_type(device_type, impl, expected):
    assert kernel_or_plain(device_type, impl) == expected


def test_fir_dispatch_rejects_other_devices_and_impls():
    with pytest.raises(ValueError):
        kernel_or_plain("mps")
    with pytest.raises(ValueError):
        kernel_or_plain("cuda", impl="xla")


def test_fir_dispatch_sends_cpu_tensors_to_the_plain_versions():
    """On the CPU both dispatchers return their plain version's result and
    launch nothing."""
    p = torch.from_numpy(np.random.RandomState(0).randn(20, 21, 8).astype(np.float32))
    taps = hann_taps(4)
    mw, mh = (torch.from_numpy(banded(n, q, taps)) for n, q in ((18, 21), (17, 20)))
    before = dict(cuda_build.launches)
    torch.testing.assert_close(fir_taps(p, taps, taps), fir_taps_ref(p, taps, taps),
                               rtol=0, atol=0)
    torch.testing.assert_close(fir_banded(p, mw, mh), fir_banded_ref(p, mw, mh), rtol=0, atol=0)
    assert cuda_build.launches == before
    assert set(cuda_build.launches) == {"filtered_lrelu_fwd", "filtered_lrelu_bwd", "fir_taps",
                                        "fir_banded"}
    assert flrelu_cuda.launches is cuda_build.launches and fir_cuda.launches is cuda_build.launches


def test_library_key_covers_included_headers(tmp_path, monkeypatch):
    """An edit to a local header a kernel includes changes its library's
    key, so no stale library is loaded; system headers are not followed."""
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    monkeypatch.setitem(cuda_build.KERNELS, "probe", cuda_build.Kernel(tmp_path / "k.cu", {}))
    assert [p.name for p in cuda_build.source_files(tmp_path / "k.cu")] == \
        ["k.cu", "a.cuh", "b.cuh"]
    before = cuda_build.library_path("probe")
    (tmp_path / "b.cuh").write_text("// v2\n")
    assert cuda_build.library_path("probe") != before
    assert [p.name for p in cuda_build.source_files(cuda_build.KERNELS["fir_banded"].source)] \
        == ["fir_banded.cu", "mma.cuh"]

"""Build, bind and launch the hand-written CUDA filtered-lrelu forward kernel.

The kernel (`csrc/filtered_lrelu_fwd.cu`) replaces the TPU kernel
`_flrelu_kernel` behind `fused_filtered_lrelu`
(stylegan3_editing_tpu/ops/pallas_flrelu.py). Its bound on the card is the
larger of bytes(input + output) / HBM rate and its fp32 operations / CUDA-core
rate; the design keeps the x`up` intermediate grid in shared memory so only
the input and output cross device memory (see the note in the source).

The shared library is compiled with ``nvcc`` from the source in this
package at first use, into ``_build/`` beside the package (listed in
``.gitignore``), and loaded with ``ctypes``. The launch goes on PyTorch's
current stream. There is no fallback: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

_SRC = Path(__file__).resolve().parent / "csrc" / "filtered_lrelu_fwd.cu"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = 0       # kernel launches since the last `reset_launches()`
build_log = ""     # nvcc's output (ptxas register and shared-memory report)
_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the filtered-lrelu kernel")


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    so = _BUILD_DIR / f"libflrelu_fwd_{tag}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, so)  # atomic: concurrent builders see a whole file
    lib = ctypes.CDLL(str(so))
    lib.sg3_flrelu_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_float] * 3
        + [ctypes.c_void_p])
    lib.sg3_flrelu_fwd.restype = ctypes.c_int
    lib.sg3_flrelu_fwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.sg3_flrelu_fwd_smem_bytes.restype = ctypes.c_size_t
    _lib = lib
    return lib


def output_size(length: int, up: int, pad0: int, pad1: int, tu: int, td: int) -> int:
    """Output length of one axis: (in·up + p0 + p1 − (tu−1) − (td−1) + 1) // 2."""
    return (length * up + pad0 + pad1 - (tu - 1) - (td - 1) + 1) // 2


def in_envelope(fu, fd, up: int, down: int, flip_filter: bool) -> bool:
    """Whether the kernel computes this configuration: down 2, convolution
    order, numpy filters, fu 1-D with 6·up taps (12 at up 2, 24 at up 4),
    fd 12 taps, 1-D or 12×12 — every filtered layer of SG3-R and SG3-T."""
    return (isinstance(fu, np.ndarray) and isinstance(fd, np.ndarray)
            and down == 2 and up in (2, 4) and not flip_filter
            and fu.shape == (6 * up,) and fd.shape in ((12,), (12, 12)))


def filtered_lrelu_cuda(
    x: torch.Tensor,
    fu: np.ndarray,
    fd: np.ndarray,
    b: Optional[torch.Tensor],
    up: int,
    padding: Tuple[int, int, int, int],
    gain: float,
    slope: float,
    clamp: Optional[float],
) -> torch.Tensor:
    """Launch the fused kernel on a CUDA NHWC tensor (fp32 or bf16).

    ``padding`` is ``(px0, px1, py0, py1)`` on the up grid (negative crops);
    down is 2. Raises on any input the kernel does not take.
    """
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"filtered_lrelu_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    if not in_envelope(fu, fd, up, 2, False):
        raise ValueError("configuration outside the kernel's envelope")
    if torch.is_grad_enabled() and (x.requires_grad or (b is not None and b.requires_grad)):
        raise RuntimeError("the forward kernel has no backward yet: run under "
                           "torch.no_grad() / inference_mode, or pass impl='ref'")
    n, h, w, c = x.shape
    px0, px1, py0, py1 = (int(p) for p in padding)
    tu, td = int(fu.shape[0]), int(fd.shape[0])
    out_h = output_size(h, up, py0, py1, tu, td)
    out_w = output_size(w, up, px0, px1, tu, td)
    if out_h < 1 or out_w < 1:
        raise ValueError(f"empty output {out_h}x{out_w}")
    bias = (torch.zeros(c, dtype=torch.float32, device=x.device) if b is None
            else b.to(device=x.device, dtype=torch.float32).contiguous())
    if bias.shape != (c,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({c},)")
    radial = int(fd.ndim == 2)
    fu_c = np.ascontiguousarray(fu[::-1] * up, np.float32)
    fd_c = np.ascontiguousarray(fd[::-1] if fd.ndim == 1 else fd[::-1, ::-1], np.float32)

    lib = build()
    out = torch.empty((n, out_h, out_w, c), dtype=x.dtype, device=x.device)
    err = lib.sg3_flrelu_fwd(
        x.data_ptr(), bias.data_ptr(), fu_c.ctypes.data, fd_c.ctypes.data,
        out.data_ptr(), 0 if x.dtype == torch.float32 else 1,
        n, h, w, c, out_h, out_w, up, tu, td, radial, py0, px0,
        float(gain), float(slope), math.inf if clamp is None else float(clamp),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"filtered-lrelu kernel launch failed: cudaError {err}")
    launches += 1
    return out


"""Launch the hand-written CUDA kernels of the banded-FIR probe.

Two kernels, one source each in ``csrc/``, replacing the two TPU kernels of
the probe `scripts/exp_mxu_down.py`:

- ``fir_taps`` (`fir_taps.cu`, CUDA cores) replaces `kernel_vpu`: the
  two-axis valid FIR as tap chains, W then H;
- ``fir_banded`` (`fir_banded.cu`, tensor cores, ``mma.sync``) replaces
  `kernel_mxu`: the same contraction as two dense products, ``Mw·P`` then
  ``Mh·t``, for any matrices.

Both take a contiguous ``[Qh, Qw, C]`` plane (fp32 or bf16) and write an fp32
output; both are bound by bytes(inputs + output) / HBM rate. The libraries
are built by `cuda_build`. Launches go on PyTorch's current stream and are
counted in ``launches``. There is no fallback: an input the kernel does not
take, or a failed launch, raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_build import build, launches

MAX_TAPS = 64                 # fir_taps.cu kMaxTaps
MAX_QW = 128                  # fir_banded.cu kMaxQw
MAX_ROWS = 128                # fir_banded.cu kMaxRows: J and I
SMEM_PER_BLOCK = 232_448      # H100: the most dynamic shared memory a block can have


def _check_plane(p: torch.Tensor, who: str) -> None:
    if p.device.type != "cuda":
        raise ValueError(f"{who} needs a CUDA tensor, got {p.device}")
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {p.dtype}")
    if p.ndim != 3 or not p.is_contiguous():
        raise ValueError("p must be a contiguous [Qh, Qw, C] tensor")


def _dtype_code(p: torch.Tensor) -> int:
    return 0 if p.dtype == torch.float32 else 1


def fir_taps_cuda(p: torch.Tensor, taps_w: np.ndarray, taps_h: np.ndarray) -> torch.Tensor:
    """The valid FIR of ``p [Qh, Qw, C]`` with 1-D fp32 taps along W, then H:
    fp32 ``[Qh − Th + 1, Qw − Tw + 1, C]``."""
    _check_plane(p, "fir_taps_cuda")
    tw = np.ascontiguousarray(taps_w, np.float32)
    th = np.ascontiguousarray(taps_h, np.float32)
    qh, qw, c = p.shape
    if tw.ndim != 1 or th.ndim != 1 or not (1 <= len(tw) <= min(qw, MAX_TAPS)) \
            or not (1 <= len(th) <= min(qh, MAX_TAPS)):
        raise ValueError(f"taps must be 1-D with 1..{MAX_TAPS} entries and fit the plane "
                         f"{tuple(p.shape)}, got {tw.shape} and {th.shape}")
    lib = build()["fir_taps"]
    out = torch.empty((qh - len(th) + 1, qw - len(tw) + 1, c), dtype=torch.float32,
                      device=p.device)
    err = lib.sg3_fir_taps(p.data_ptr(), tw.ctypes.data, th.ctypes.data, out.data_ptr(),
                           _dtype_code(p), qh, qw, c, len(tw), len(th),
                           torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fir_taps kernel launch failed: cudaError {err}")
    launches["fir_taps"] += 1
    return out


def fir_banded_cuda(p: torch.Tensor, mw: torch.Tensor, mh: torch.Tensor) -> torch.Tensor:
    """``o[i, j, c] = Σ_q Mh[i, q] · Σ_w Mw[j, w] · P[q, w, c]`` in fp32 for
    ``p [Qh, Qw, C]``, ``mw [J, Qw]`` and ``mh [I, Qh]`` of p's dtype on its
    device: fp32 ``[I, J, C]``."""
    _check_plane(p, "fir_banded_cuda")
    qh, qw, c = p.shape
    for name, m, k in (("mw", mw, qw), ("mh", mh, qh)):
        if m.device != p.device or m.dtype != p.dtype:
            raise TypeError(f"{name} ({m.dtype}, {m.device}) must match p ({p.dtype}, {p.device})")
        if m.ndim != 2 or m.shape[1] != k or m.shape[0] < 1 or not m.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [rows, {k}] matrix, got "
                             f"{tuple(m.shape)}")
    j, i = mw.shape[0], mh.shape[0]
    if qw > MAX_QW or max(j, i) > MAX_ROWS:
        raise ValueError(f"Qw = {qw}, J = {j}, I = {i}: the kernel takes Qw <= {MAX_QW} and "
                         f"J, I <= {MAX_ROWS} (8 MMA tiles)")
    lib = build()["fir_banded"]
    smem = lib.sg3_fir_banded_smem_bytes(qh, qw, j, i, _dtype_code(p))
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"[{qh}, {qw}] -> [{i}, {j}] needs {smem} B of shared memory per "
                         f"block (t of one band of at most 16 columns and 8 channels, Qh rows "
                         f"deep, and the matrices); the card has {SMEM_PER_BLOCK}")
    out = torch.empty((i, j, c), dtype=torch.float32, device=p.device)
    err = lib.sg3_fir_banded(p.data_ptr(), mw.data_ptr(), mh.data_ptr(), out.data_ptr(),
                             _dtype_code(p), qh, qw, c, j, i,
                             torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fir_banded kernel launch failed: cudaError {err}")
    launches["fir_banded"] += 1
    return out

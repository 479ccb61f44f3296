"""Launch the hand-written CUDA filtered-lrelu kernels.

Two kernels, one source each in ``csrc/``:

- ``filtered_lrelu_fwd`` (`filtered_lrelu_fwd.cu`) replaces the TPU kernel
  `_flrelu_kernel` behind `fused_filtered_lrelu`;
- ``filtered_lrelu_bwd`` (`filtered_lrelu_bwd.cu`) replaces
  `_flrelu_bwd_kernel` behind `fused_filtered_lrelu_bwd`
  (both in stylegan3_editing_tpu/ops/pallas_flrelu.py).

Each is bound by the larger of bytes(inputs + output) / HBM rate and its
fp32 operations / CUDA-core rate; each keeps the ×up intermediate grid in
shared memory, so only its inputs and output cross device memory (see the
notes in the sources).

The shared libraries are built and loaded by `cuda_build` (``nvcc`` at
first use, all sources in parallel); `build`, `launches`, `build_log` and
`reset_launches` are its own, named here too. Launches go on PyTorch's
current stream. There is no fallback: a build or launch failure, or an
input outside the envelope, raises.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .cuda_build import build, build_log, launches, reset_launches  # noqa: F401

# The forward's down pass on bf16 layers with a 12×12 fd runs on the tensor
# cores as out[m, c] = Σ_k W[m, k] · A[window(k), c]: m is one of the 16
# outputs of a 4×4 M-tile (the MMA's M), c one of a block's 8 channels (its
# N), k one of K = 21 steps × 16 points of the M-tile's 18×18 window on the
# activated up grid A. W is the same for every M-tile, so it is built once
# per filter (`mma_down_operand`) and split into bf16 hi + lo.
MMA_TILE = 4                         # M-tile side
MMA_WINDOW = 2 * (MMA_TILE - 1) + 12  # its window's side on the up grid: 18
MMA_K = 16 * 21                      # W's columns: 21 k16 steps


def mma_down(dtype: torch.dtype, fd: np.ndarray) -> bool:
    """Whether the forward kernel's down pass runs on the tensor cores (bf16
    input, 12×12 fd) or on the CUDA cores (fp32, or a separable fd)."""
    return dtype == torch.bfloat16 and fd.ndim == 2


def mma_down_window_offsets() -> Tuple[np.ndarray, np.ndarray]:
    """``(ij, real)``: the window position (row, column) of each of W's K
    columns in the kernel's order, and whether it is a point of the window.

    Steps 0–17 take window row s, columns 0–15. Steps 18–20 take columns 16
    and 17 of rows 8t … 8t + 7 as (row, column) pairs, k = 2·(row − 8t) +
    column − 16; rows past 17 are padding, clamped to row 17 (W is zero
    there, the data only has to be finite).
    """
    k = np.arange(MMA_K)
    step, kk = k // 16, k % 16
    first = step < MMA_WINDOW
    row = np.where(first, step, 8 * (step - MMA_WINDOW) + kk // 2)
    col = np.where(first, kk, 16 + kk % 2)
    real = row < MMA_WINDOW
    return np.stack([np.minimum(row, MMA_WINDOW - 1), col], axis=1), real


def mma_down_operand(fd: np.ndarray) -> np.ndarray:
    """W ``[16, MMA_K]`` (float64 holding float32 taps) for a 12×12 fd:
    ``W[m, k] = fd_c[i_k − 2·dy, j_k − 2·dx]`` for output m = 4·dy + dx of the
    M-tile and window point (i_k, j_k), zero outside the taps. ``fd_c`` is the
    kernel's correlation-order fd in float32, untruncated."""
    fd_c = np.asarray(fd, np.float32)[::-1, ::-1].astype(np.float64)
    td = fd_c.shape[0]
    assert fd_c.shape == (td, td) and 2 * (MMA_TILE - 1) + td == MMA_WINDOW, fd_c.shape
    ij, real = mma_down_window_offsets()
    dy, dx = np.divmod(np.arange(MMA_TILE * MMA_TILE), MMA_TILE)
    ky = ij[None, :, 0] - 2 * dy[:, None]
    kx = ij[None, :, 1] - 2 * dx[:, None]
    inside = real[None] & (ky >= 0) & (ky < td) & (kx >= 0) & (kx < td)
    return np.where(inside, fd_c[ky.clip(0, td - 1), kx.clip(0, td - 1)], 0.0)


def bf16_value(bits: np.ndarray) -> np.ndarray:
    """float32 values of bf16 bit patterns (uint16)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def bf16_split(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """bf16 bit patterns (uint16) of ``hi = rn(w)`` and ``lo = rn(w − hi)`` for
    finite float32 ``w``, rounding to nearest even: hi + lo keeps ~2⁻¹⁷ of
    |w|, where hi alone keeps 2⁻⁹."""
    def rn(v):
        bits = np.ascontiguousarray(v, np.float32).view(np.uint32).astype(np.uint64)
        return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)

    w = np.asarray(w, np.float32)
    assert np.isfinite(w).all()
    hi = rn(w)
    return hi, rn(w - bf16_value(hi))


_mma_operands: Dict[Tuple[bytes, str], torch.Tensor] = {}


def mma_down_operand_on(fd: np.ndarray, device: torch.device) -> torch.Tensor:
    """W of `mma_down_operand` as bf16 ``[2 (hi, lo), 16, MMA_K]`` on
    ``device``, built once per (fd, device)."""
    key = (np.asarray(fd, np.float32).tobytes(), str(device))
    if key not in _mma_operands:
        hi, lo = bf16_split(mma_down_operand(fd))
        bits = torch.from_numpy(np.stack([hi, lo]).view(np.int16))
        _mma_operands[key] = bits.to(device).view(torch.bfloat16)
    return _mma_operands[key]


# The backward's ×2 up pass of dy on bf16 layers with a 12×12 fd runs on the
# tensor cores as G[m, n] = Σ_k W[m, k] · dy[window(k), n]: m is one of the
# 16 points of a 4×4 M-tile of the up grid (the MMA's M), n one of a block's
# 4 channels in one of two M-tiles (its N = 8), k one of the 64 pixels of the
# 8×8 window of dy under the M-tile (K = 4 k16 steps). A point uses 36 of
# them, the taps of its stuffing phase. W depends only on fd and on the
# stuffing parity (ey, ex) of the M-tiles' first points, which is one per
# launch, so it is built once per (fd, parity) and split into bf16 hi + lo;
# dy is bf16 already, so hi·dy + lo·dy keep ~2⁻¹⁷ of the fp32 sum.
UP_MMA_TILE = 4    # M-tile side
UP_MMA_WINDOW = 8  # its dy window's side
UP_MMA_K = UP_MMA_WINDOW * UP_MMA_WINDOW


def mma_up(dtype: torch.dtype, fd: np.ndarray) -> bool:
    """Whether the backward kernel's dy up pass runs on the tensor cores
    (bf16 input, 12×12 fd) or on the CUDA cores (fp32, or a separable fd)."""
    return dtype == torch.bfloat16 and fd.ndim == 2


def mma_up_window_offsets() -> np.ndarray:
    """``[UP_MMA_K, 2]``: the dy window pixel (row, column) of each of W's
    columns in the kernel's order. Step s = k // 16 takes window rows 2s
    (k % 16 < 8) and 2s + 1, column k % 8, so the two dy values of a B
    register (k and k + 1, k even) are neighbours in a row of one channel."""
    k = np.arange(UP_MMA_K)
    step, kk = k // 16, k % 16
    return np.stack([2 * step + kk // 8, kk % 8], axis=1)


def mma_up_operand(fd: np.ndarray, ey: int, ex: int) -> np.ndarray:
    """W ``[16, UP_MMA_K]`` (float64 holding float32 taps) for a 12×12 fd:
    ``W[m, k] = fd[2·w − a − ey, 2·v − b − ex]`` for point m = 4·a + b of the
    M-tile and window pixel (w, v), zero outside the taps. The window's
    first row and column sit on the last even stuffed index at or before the
    M-tile's first point, whose stuffing parity is (ey, ex). fd is used as
    given: dy's up pass correlates with it."""
    f = np.asarray(fd, np.float32).astype(np.float64)
    td = f.shape[0]
    assert f.shape == (td, td) and ey in (0, 1) and ex in (0, 1), (f.shape, ey, ex)
    assert 2 * (UP_MMA_WINDOW - 1) >= UP_MMA_TILE + td - 2  # the last even offset a point reaches
    wv = mma_up_window_offsets()
    a, b = np.divmod(np.arange(UP_MMA_TILE * UP_MMA_TILE), UP_MMA_TILE)
    ky = 2 * wv[None, :, 0] - a[:, None] - ey
    kx = 2 * wv[None, :, 1] - b[:, None] - ex
    inside = (ky >= 0) & (ky < td) & (kx >= 0) & (kx < td)
    return np.where(inside, f[ky.clip(0, td - 1), kx.clip(0, td - 1)], 0.0)


def mma_a_fragments(w: np.ndarray) -> np.ndarray:
    """A ``[16, 16·S]`` matrix of bf16 bit patterns (uint16) as m16n8k16 A
    fragments, ``[S, 32, 4]`` uint32: register r of lane l at step s holds
    ``w[row, 16s + col]`` in its low half and ``w[row, 16s + col + 1]`` in
    its high half, row = l // 4 + 8·(r % 2), col = 2·(l % 4) + 8·(r // 2)."""
    steps = w.shape[1] // 16
    assert w.shape == (16, 16 * steps) and w.dtype == np.uint16
    lane, r = np.arange(32)[:, None], np.arange(4)[None, :]
    row = lane // 4 + 8 * (r % 2)
    col = 16 * np.arange(steps)[:, None, None] + 2 * (lane % 4) + 8 * (r // 2)
    low, high = w[row, col].astype(np.uint32), w[row, col + 1].astype(np.uint32)
    return low | (high << 16)


_mma_up_operands: Dict[Tuple[bytes, int, int, str], torch.Tensor] = {}


def mma_up_operand_on(fd: np.ndarray, ey: int, ex: int, device: torch.device) -> torch.Tensor:
    """W of `mma_up_operand`, split into bf16 hi and lo, as the kernel's A
    fragments: int32 ``[2 (hi, lo), 4 steps, 32 lanes, 4]`` on ``device``,
    built once per (fd, parity, device)."""
    key = (np.asarray(fd, np.float32).tobytes(), ey, ex, str(device))
    if key not in _mma_up_operands:
        frags = np.stack([mma_a_fragments(part)
                          for part in bf16_split(mma_up_operand(fd, ey, ex))])
        _mma_up_operands[key] = torch.from_numpy(frags.view(np.int32)).to(device)
    return _mma_up_operands[key]


def output_size(length: int, up: int, pad0: int, pad1: int, tu: int, td: int) -> int:
    """Output length of one axis: (in·up + p0 + p1 − (tu−1) − (td−1) + 1) // 2."""
    return (length * up + pad0 + pad1 - (tu - 1) - (td - 1) + 1) // 2


def backward_padding(x_len: int, y_len: int, up: int, pad0: int, tu: int,
                     td: int) -> Tuple[int, int]:
    """(pp0, pp1) of dy's ×2 up pass in the backward, on one axis (reference
    filtered_lrelu.py:255-260): ``pp0 = (tu−1) + (td−1) − p0`` and
    ``pp1 = x_len·up − y_len·2 + p0 − (up−1)``."""
    return (tu - 1) + (td - 1) - pad0, x_len * up - y_len * 2 + pad0 - (up - 1)


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
    down is 2. On bf16 with a 12×12 fd the down pass runs on the tensor
    cores, with W from `mma_down_operand_on`. Raises on any input the kernel
    does not take.
    """
    if x.device.type != "cuda":
        raise ValueError(f"filtered_lrelu_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtype {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    if not in_envelope(fu, fd, up, 2, False):
        raise ValueError("configuration outside the kernel's envelope")
    if torch.is_grad_enabled() and (x.requires_grad or (b is not None and b.requires_grad)):
        raise RuntimeError("filtered_lrelu_cuda records no graph: call "
                           "ops.filtered_lrelu, whose autograd Function runs the "
                           "backward kernel")
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

    wmma = mma_down_operand_on(fd, x.device).data_ptr() if mma_down(x.dtype, fd) else None

    lib = build()["filtered_lrelu_fwd"]
    out = torch.empty((n, out_h, out_w, c), dtype=x.dtype, device=x.device)
    err = lib.sg3_flrelu_fwd(
        x.data_ptr(), bias.data_ptr(), fu_c.ctypes.data, fd_c.ctypes.data, wmma,
        out.data_ptr(), 0 if x.dtype == torch.float32 else 1,
        n, h, w, c, out_h, out_w, up, tu, td, radial, py0, px0,
        float(gain), float(slope), math.inf if clamp is None else float(clamp),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"filtered-lrelu kernel launch failed: cudaError {err}")
    launches["filtered_lrelu_fwd"] += 1
    return out


def filtered_lrelu_bwd_cuda(
    dy: torch.Tensor,
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
    """Launch the backward kernel: dx of `filtered_lrelu_cuda` for the
    gradient ``dy`` of its output, recomputing the pre-activation from the
    forward's input ``x`` and bias ``b``. Both CUDA, contiguous NHWC, of one
    dtype (fp32 or bf16); dx comes in that dtype. On bf16 with a 12×12 fd
    dy's up pass runs on the tensor cores, with W from `mma_up_operand_on`
    for the launch's stuffing parity. Raises on any input the kernel does
    not take.
    """
    for name, t in (("dy", dy), ("x", x)):
        if t.device.type != "cuda":
            raise ValueError(f"filtered_lrelu_bwd_cuda needs CUDA tensors, {name} is on "
                             f"{t.device}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"unsupported dtype {t.dtype} of {name}")
        if t.ndim != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous NHWC tensor")
    if dy.dtype != x.dtype or dy.device != x.device:
        raise TypeError(f"dy ({dy.dtype}, {dy.device}) and x ({x.dtype}, {x.device}) differ")
    if not in_envelope(fu, fd, up, 2, False):
        raise ValueError("configuration outside the kernel's envelope")
    n, h, w, c = x.shape
    px0, px1, py0, py1 = (int(p) for p in padding)
    tu, td = int(fu.shape[0]), int(fd.shape[0])
    yh = output_size(h, up, py0, py1, tu, td)
    yw = output_size(w, up, px0, px1, tu, td)
    if tuple(dy.shape) != (n, yh, yw, c):
        raise ValueError(f"dy shape {tuple(dy.shape)} != the forward's output "
                         f"{(n, yh, yw, c)}")
    bias = (torch.zeros(c, dtype=torch.float32, device=x.device) if b is None
            else b.detach().to(device=x.device, dtype=torch.float32).contiguous())
    if bias.shape != (c,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({c},)")
    ppy0 = backward_padding(h, yh, up, py0, tu, td)[0]
    ppx0 = backward_padding(w, yw, up, px0, tu, td)[0]
    fu_c = np.ascontiguousarray(fu, np.float32)
    fd_c = np.ascontiguousarray(fd, np.float32)
    wmma = (mma_up_operand_on(fd, ppy0 % 2, ppx0 % 2, x.device).data_ptr()
            if mma_up(x.dtype, fd) else None)

    lib = build()["filtered_lrelu_bwd"]
    dx = torch.empty_like(x)
    err = lib.sg3_flrelu_bwd(
        dy.data_ptr(), x.data_ptr(), bias.data_ptr(), fu_c.ctypes.data, fd_c.ctypes.data,
        wmma, dx.data_ptr(), 0 if x.dtype == torch.float32 else 1,
        n, h, w, c, yh, yw, up, tu, td, int(fd.ndim == 2), ppy0, ppx0,
        float(gain), float(slope), math.inf if clamp is None else float(clamp),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"filtered-lrelu backward kernel launch failed: cudaError {err}")
    launches["filtered_lrelu_bwd"] += 1
    return dx


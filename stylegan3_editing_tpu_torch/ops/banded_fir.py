"""The two-axis valid FIR of the banded-FIR probe, as tap chains and as banded products.

The probe (`scripts/exp_mxu_down.py` in the JAX package) computes one FIR
over a ``[Qh, Qw, C]`` plane two ways, each a TPU kernel:

- `kernel_vpu`, tap chains: p upcast to fp32, fp32 taps, the W chain then the
  H chain, fp32 out. Here `fir_taps_ref` (plain) and `fir_taps` (dispatch).
- `kernel_mxu`, two dense products with the banded matrices ``Mw [J, Qw]``
  and ``Mh [I, Qh]`` in p's dtype: ``t = Mw·P`` in fp32 from exact products,
  then ``o = Mh·t``, an fp32 contraction over fp32 t. Here
  `fir_banded_ref` and `fir_banded`.

In bf16 the two are different functions: the chains multiply by fp32 taps,
the products by the bf16-rounded taps the matrices hold.

The dispatchers send CPU tensors, and ``impl="ref"``, to the plain version,
and CUDA tensors to the hand-written kernel (`fir_cuda`), which launches or
raises. The plain products run in fp32 only where TF32 is off for matmuls
(`torch.backends.cuda.matmul.allow_tf32`, off by default).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import kernel_or_plain
from . import fir_cuda


def banded(j_out: int, q_in: int, taps: np.ndarray, stride: int = 1) -> np.ndarray:
    """M[j, q] = taps[t] where q = j*stride + t (the JAX probe's `banded`)."""
    m = np.zeros((j_out, q_in), np.float32)
    for j in range(j_out):
        for t, v in enumerate(taps):
            q = j * stride + t
            if q < q_in:
                m[j, q] = v
    return m


def hann_taps(n: int) -> np.ndarray:
    """The probe's n taps: a Hann window without its zero ends, float32."""
    return np.hanning(n + 2)[1:-1].astype(np.float32)


def fir_taps_ref(p: torch.Tensor, taps_w: np.ndarray, taps_h: np.ndarray) -> torch.Tensor:
    """`kernel_vpu`: p [Qh, Qw, C] upcast to fp32, the W chain then the H chain
    over fp32 taps, each summed in tap order: fp32 [Qh − Th + 1, Qw − Tw + 1, C]."""
    p = p.float()
    j_out, i_out = p.shape[1] - len(taps_w) + 1, p.shape[0] - len(taps_h) + 1
    acc = None
    for t, v in enumerate(np.asarray(taps_w, np.float32)):
        term = p[:, t:t + j_out, :] * float(v)
        acc = term if acc is None else acc + term
    out = None
    for t, v in enumerate(np.asarray(taps_h, np.float32)):
        term = acc[t:t + i_out, :, :] * float(v)
        out = term if out is None else out + term
    return out


def fir_banded_ref(p: torch.Tensor, mw: torch.Tensor, mh: torch.Tensor) -> torch.Tensor:
    """`kernel_mxu`: ``t = Mw·P`` in fp32 from operands in p's dtype, then
    ``o = Mh·t`` in fp32: fp32 [I, J, C] for mw [J, Qw] and mh [I, Qh]."""
    qh, _, c = p.shape
    t = torch.matmul(mw.float(), p.float())  # [Qh, J, C]
    return torch.matmul(mh.float(), t.reshape(qh, -1)).reshape(mh.shape[0], -1, c)


def fir_taps(p: torch.Tensor, taps_w: np.ndarray, taps_h: np.ndarray,
             impl: str = "auto") -> torch.Tensor:
    if kernel_or_plain(p.device.type, impl) == "ref":
        return fir_taps_ref(p, taps_w, taps_h)
    return fir_cuda.fir_taps_cuda(p, taps_w, taps_h)


def fir_banded(p: torch.Tensor, mw: torch.Tensor, mh: torch.Tensor,
               impl: str = "auto") -> torch.Tensor:
    if kernel_or_plain(p.device.type, impl) == "ref":
        return fir_banded_ref(p, mw, mh)
    return fir_cuda.fir_banded_cuda(p, mw, mh)

"""FIR low-pass filter design for alias-free synthesis (NumPy/SciPy).

Host-side code that produces the static filter constants of each synthesis
layer. The filters are never trained, so they are numpy arrays handed to the
filtering ops. Semantics follow the reference StyleGAN3
`SynthesisLayer.design_lowpass_filter` and `upfirdn2d.setup_filter`; the
values equal the JAX package's `ops/filter_design.py` exactly.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np


def design_lowpass_filter(
    numtaps: int,
    cutoff: float,
    width: float,
    fs: float,
    radial: bool = False,
) -> Optional[np.ndarray]:
    """Design the per-layer low-pass filter of the alias-free generator.

    Returns a 1-D separable Kaiser-windowed sinc (`numtaps` taps), a 2-D
    radially symmetric jinc filter (`numtaps`×`numtaps`), or ``None`` for the
    identity (numtaps == 1). SciPy is imported here, when a generator is
    built, so that modules importing the ops package need no SciPy.
    """
    import scipy.signal
    import scipy.special

    assert numtaps >= 1
    if numtaps == 1:
        return None

    if not radial:
        f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
        return np.asarray(f, dtype=np.float32)

    # Radially symmetric jinc-based filter, Kaiser-windowed, DC-normalized.
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(divide="ignore", invalid="ignore"):
        f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    # j1(z)/z -> 1/2 as z -> 0, so f -> cutoff at r == 0.
    f = np.where(r == 0, np.float64(cutoff), f)
    beta = scipy.signal.kaiser_beta(scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    w = np.kaiser(numtaps, beta)
    f = f * np.outer(w, w)
    f = f / np.sum(f)
    return np.asarray(f, dtype=np.float32)


def setup_filter(
    f: Union[None, int, float, list, np.ndarray],
    normalize: bool = True,
    flip_filter: bool = False,
    gain: float = 1,
    separable: Optional[bool] = None,
) -> np.ndarray:
    """Normalize/flip/scale a FIR filter for `upfirdn2d`.

    Accepts a scalar (impulse), 1-D taps, 2-D kernel, or ``None`` (identity).
    1-D filters with >= 8 taps stay separable; shorter 1-D filters become
    their 2-D outer product.
    """
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (0, 1, 2)
    assert f.size > 0
    if f.ndim == 0:
        f = f[np.newaxis]

    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    assert f.ndim == (1 if separable else 2)

    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[::-1] if f.ndim == 1 else f[::-1, ::-1]
    f = f * (gain ** (f.ndim / 2))
    return np.ascontiguousarray(f, dtype=np.float32)

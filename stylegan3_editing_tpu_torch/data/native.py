"""ctypes binding of the native (C++) host-side batch preprocessor.

Counterpart of the JAX package's `data/native.py`, on the same unchanged
source, ``native/batch_preprocess.cpp``: uint8 NHWC batches → float32 in
[−1, 1] with an optional mirror per image, on host threads. The library
builds with ``g++`` at first use into ``stylegan3_editing_tpu_torch/_build/``,
keyed by the source's hash, and a failed build raises (the JAX package
falls back to numpy unnoticed; here the numpy path runs only when asked
for, ``impl="numpy"``, as the plain version).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "batch_preprocess.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return _BUILD_DIR / f"libbatch_preprocess_{digest.hexdigest()[:12]}.so"


def get_library() -> ctypes.CDLL:
    """The built library (built once a process; raises if ``g++`` fails)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not path.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
                os.close(fd)
                proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(_SRC)],
                                      capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    os.unlink(tmp)
                    raise RuntimeError(f"g++ failed to build {_SRC.name} ({proc.returncode}):\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, path)  # atomic: a concurrent build sees a whole file
            lib = ctypes.CDLL(str(path))
            lib.normalize_batch.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            lib.normalize_batch.restype = None
            _LIB = lib
    return _LIB


def normalize_batch_ref(images: np.ndarray, flip: Optional[np.ndarray] = None) -> np.ndarray:
    """The plain numpy version of `normalize_batch`."""
    out = images.astype(np.float32) * np.float32(2.0 / 255.0) - np.float32(1.0)
    if flip is not None:
        mirror = np.asarray(flip).astype(bool)
        out[mirror] = out[mirror][:, :, ::-1]
    return out


def normalize_batch(images: np.ndarray, flip: Optional[np.ndarray] = None,
                    num_threads: int = 4, impl: str = "native") -> np.ndarray:
    """uint8 NHWC batch → float32 [−1, 1] NHWC, each image with a nonzero
    ``flip`` entry mirrored left to right. ``impl``: ``"native"`` (the C++
    library) or ``"numpy"`` (the plain version)."""
    if impl not in ("native", "numpy"):
        raise ValueError(f"impl must be 'native' or 'numpy', got {impl!r}")
    assert images.dtype == np.uint8 and images.ndim == 4
    images = np.ascontiguousarray(images)
    if impl == "numpy":
        return normalize_batch_ref(images, flip)
    n, h, w, c = images.shape
    out = np.empty((n, h, w, c), np.float32)
    flip_arr = None if flip is None else np.ascontiguousarray(np.asarray(flip).astype(np.uint8))
    u8 = ctypes.POINTER(ctypes.c_uint8)
    get_library().normalize_batch(
        images.ctypes.data_as(u8), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        flip_arr.ctypes.data_as(u8) if flip_arr is not None else ctypes.cast(None, u8),
        n, h, w, c, int(num_threads))
    return out

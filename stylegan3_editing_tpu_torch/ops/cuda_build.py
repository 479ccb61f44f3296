"""Build and load the port's hand-written CUDA kernels.

One registry, `KERNELS`, names each kernel's source in ``csrc/`` and the C
functions its shared library exports, with their ctypes signatures. `build()`
compiles every source with ``nvcc`` for ``sm_90a`` at first use, one ``nvcc``
per source, all started together, into ``_build/`` beside the package
(listed in ``.gitignore``). Each library is keyed by the hash of its source,
the local headers it includes (``#include "..."``, such as ``mma.cuh``) and
the flags, written to a temporary file and moved into place atomically,
then loaded with ``ctypes``. ptxas' report (registers, spills) is kept in
`build_log`; `sass_mma_counts` reads the tensor-core instructions of a built
library. `build_versions` and `swapped` build other versions of a source and
launch them through the same wrapper, to compare versions on one card. The
wrappers (`flrelu_cuda`, `fir_cuda`) count their launches in `launches`.
There is no fallback: a failed build raises.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F, _SIZE = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_size_t


class Kernel(NamedTuple):
    source: Path
    # C function name -> (restype, argtypes)
    functions: Dict[str, Tuple[type, List[type]]]


KERNELS: Dict[str, Kernel] = {
    "filtered_lrelu_fwd": Kernel(_CSRC / "filtered_lrelu_fwd.cu", {
        "sg3_flrelu_fwd": (_I, [_P] * 6 + [_I] * 13 + [_F] * 3 + [_P]),
        "sg3_flrelu_fwd_smem_bytes": (_SIZE, [_I])}),
    "filtered_lrelu_bwd": Kernel(_CSRC / "filtered_lrelu_bwd.cu", {
        "sg3_flrelu_bwd": (_I, [_P] * 7 + [_I] * 13 + [_F] * 3 + [_P]),
        "sg3_flrelu_bwd_smem_bytes": (_SIZE, [_I] * 3)}),
    "fir_taps": Kernel(_CSRC / "fir_taps.cu", {
        "sg3_fir_taps": (_I, [_P] * 4 + [_I] * 6 + [_P]),
        "sg3_fir_taps_smem_bytes": (_SIZE, [_I] * 6),
        "sg3_fir_taps_blocks_per_sm": (_I, [_I] * 6)}),
    "fir_banded": Kernel(_CSRC / "fir_banded.cu", {
        "sg3_fir_banded": (_I, [_P] * 4 + [_I] * 6 + [_P]),
        "sg3_fir_banded_smem_bytes": (_SIZE, [_I] * 5),
        "sg3_fir_banded_blocks_per_sm": (_I, [_I] * 5)}),
}

# Launches of each kernel since the last `reset_launches()`.
launches: Dict[str, int] = {name: 0 for name in KERNELS}
build_log: Dict[str, str] = {}  # nvcc's output per kernel (ptxas registers, spills)
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def source_files(source: Path) -> List[Path]:
    """A kernel's source and the local headers it includes, transitively."""
    files = [source]
    for path in files:  # grows while it is walked
        for name in _LOCAL_INCLUDE.findall(path.read_bytes()):
            header = path.parent / name.decode()
            if header not in files:
                files.append(header)
    return files


def library_path(name: str, source: Optional[Path] = None) -> Path:
    """Where the shared library of kernel ``name`` (or of another version of
    its source, ``source``) is (or will be) built: keyed by the source, its
    local headers and the flags."""
    digest = hashlib.sha256()
    for path in source_files(source or KERNELS[name].source):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def _compile(jobs: Dict[str, Tuple[Path, Path]]) -> None:
    """Run ``nvcc`` on every ``label: (source, library)`` at once, each into
    a temporary file moved into place when it is whole; nvcc's output goes
    to ``build_log[label]``."""
    procs = {}
    for label, (source, path) in jobs.items():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        procs[label] = (tmp, path, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for label, (tmp, path, proc) in procs.items():
        build_log[label] = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{label}: nvcc failed ({proc.returncode}):\n{build_log[label]}")
        else:
            os.replace(tmp, path)  # atomic: concurrent builders see a whole file
    if failed:
        raise RuntimeError("\n".join(failed))


def _load(name: str, path: Path, require: bool = True) -> ctypes.CDLL:
    """Load a library and set the registry's signatures; a function the
    library lacks raises, unless ``require`` is False (an older version)."""
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in KERNELS[name].functions.items():
        if not require and not hasattr(lib, fn):
            continue
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def build() -> Dict[str, ctypes.CDLL]:
    """Compile (once per source version, all sources at once) and load the
    kernel libraries, by kernel name."""
    if _libs:
        return _libs
    paths = {name: library_path(name) for name in KERNELS}
    _compile({name: (KERNELS[name].source, path) for name, path in paths.items()
              if not path.exists()})
    _libs.update({name: _load(name, path) for name, path in paths.items()})
    return _libs


def build_versions(name: str, sources: Dict[str, Path]) -> Dict[str, ctypes.CDLL]:
    """Libraries of other versions of kernel ``name``'s source, by label,
    all compiled at once (nvcc's output in ``build_log[label]``), with the
    registry's signatures: a version must keep the kernel's launch entry,
    and may lack entries added after it (an older version). Each takes its
    local headers from its own directory."""
    paths = {label: library_path(name, Path(src)) for label, src in sources.items()}
    _compile({label: (Path(sources[label]), path) for label, path in paths.items()
              if not path.exists()})
    return {label: _load(name, path, require=False) for label, path in paths.items()}


@contextlib.contextmanager
def swapped(name: str, lib: ctypes.CDLL) -> Iterator[None]:
    """Inside the block, kernel ``name``'s wrapper launches ``lib`` (from
    `build_versions`) in place of the built library."""
    libs = build()
    kept, libs[name] = libs[name], lib
    try:
        yield
    finally:
        libs[name] = kept


def sass_mma_counts(name: str) -> Optional[collections.Counter]:
    """Tensor-core (HMMA) instructions in the SASS of kernel ``name``'s built
    library, by opcode, or None where ``cuobjdump`` is not installed."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(library_path(name))], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return collections.Counter(word for line in sass.splitlines() for word in line.split()
                               if word.startswith("HMMA."))

"""What the kernel-version scripts share (`bwd_versions`, `fir_versions`):
their command line, the build of the versions, and the timing turns.

Versions of one kernel's source are built at once by
`cuda_build.build_versions`, each launched through the kernel's own wrapper
with its library swapped in, and timed with CUDA events in turns, in
mirrored order by default, since the card's speed drifts within a call.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import cuda_build


def parse(argv: Optional[Sequence[str]], description: str, source: str, iters: int,
          extra: Optional[Callable[[argparse.ArgumentParser], None]] = None
          ) -> Tuple[argparse.Namespace, Dict[str, Path], List[str]]:
    """The arguments, the sources by label and the timing order of a versions
    script: ``LABEL=PATH`` of each version of `source`, ``--order`` (default:
    each label, then the same in reverse) and ``--iters``, and what `extra`
    adds."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("versions", nargs="+", help=f"LABEL=PATH of a {source}")
    ap.add_argument("--order", default="", help="labels in timing order (default: each "
                    "label, then the same in reverse)")
    ap.add_argument("--iters", type=int, default=iters)
    if extra is not None:
        extra(ap)
    args = ap.parse_args(argv)
    sources = {label: Path(path) for label, path in (v.split("=", 1) for v in args.versions)}
    order = args.order.split(",") if args.order else list(sources) + list(sources)[::-1]
    assert set(order) <= set(sources), (order, list(sources))
    return args, sources, order


def build(name: str, sources: Dict[str, Path]
          ) -> Tuple[torch.device, Dict[str, ctypes.CDLL], str]:
    """The card (raises without one), every version's library of kernel
    `name` with ptxas' registers and spills printed, and the card's name and
    power limit as `nvidia-smi` gives them."""
    dev = resolve_device("cuda")
    libs = cuda_build.build_versions(name, sources)
    for label in libs:
        for line in cuda_build.build_log.get(label, "(built earlier)").splitlines():
            if "Used" in line or "spill" in line or "built" in line:
                print(f"{label} ptxas: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[{smi}] torch {torch.__version__}, CUDA {torch.version.cuda}")
    return dev, libs, smi


def turns(call: Callable[[str], object], order: Sequence[str], iters: int) -> List[float]:
    """ms per call of each turn in `order`: CUDA events over `iters` calls of
    ``call(label)`` after two."""
    times = []
    for label in order:
        for _ in range(2):
            call(label)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            call(label)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return times


def means(order: Sequence[str], times: Sequence[float]) -> Dict[str, float]:
    """Each label's mean over its turns."""
    return {label: float(np.mean([t for lab, t in zip(order, times) if lab == label]))
            for label in dict.fromkeys(order)}

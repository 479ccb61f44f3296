"""Versions of a banded-FIR probe kernel's source, checked and timed in turns on one card.

    python -m stylegan3_editing_tpu_torch.scripts.fir_versions \\
        parent=path/a.cu new=path/b.cu [--kernel fir_banded|fir_taps]
        [--order parent,new,new,parent] [--iters 20]

Each ``LABEL=PATH`` names a version of the kernel's source,
`ops/csrc/fir_banded.cu` (the default) or `ops/csrc/fir_taps.cu`, with its C
launch entry; its local headers come from PATH's directory. All versions are
built at once by `cuda_build.build_versions`, and ptxas' registers and
spills are printed, with each version's resident blocks per SM where it
exports `sg3_fir_banded_blocks_per_sm` or `sg3_fir_taps_blocks_per_sm`.
Then, at the probe's two planes (`[76, 76, 128]` and `[76, 76, 16896]`, 12
Hann taps, fp32 and bf16, P standard normal from seed 400 + C as
`chip_smoke.py` phase 9), every version is launched through its wrapper,
`fir_cuda.fir_banded_cuda` or `fir_cuda.fir_taps_cuda`, with its library
swapped in (`cuda_build.swapped`): its output is checked against the plain
version (`fir_banded_ref`, `fir_taps_ref`) at 1e-5 · max |ref|, compared
with the first version's, and timed with CUDA events (``--iters`` calls
after two) in ``--order``. Versions are compared inside one call only, in
mirrored order, since the card's speed drifts within a call.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops import cuda_build, fir_cuda
from ..ops.banded_fir import banded, fir_banded_ref, fir_taps_ref, hann_taps
from . import version_turns

SHAPES = [(76, 76, 128), (76, 76, 16896)]  # the probe's plane; 132 SMs x 128 channels
TAPS = 12
FIR_TOL = 1e-5  # of max |ref|, as chip_smoke.py phase 9


def main(argv: Optional[Sequence[str]] = None) -> Dict[Tuple, Dict[str, float]]:
    """Check and time the versions; return, per (shape, dtype), each label's
    ms per call (the mean of its turns)."""
    args, sources, order = version_turns.parse(
        argv, __doc__.splitlines()[0], "fir_banded.cu or fir_taps.cu", iters=20,
        extra=lambda ap: ap.add_argument("--kernel", default="fir_banded",
                                         choices=("fir_banded", "fir_taps")))
    name = args.kernel
    dev, libs, smi = version_turns.build(name, sources)
    taps = hann_taps(TAPS)
    results = {}
    for shape in SHAPES:
        qh, qw, c = shape
        j, i = qw - TAPS + 1, qh - TAPS + 1
        for dtype in (torch.float32, torch.bfloat16):
            code = 0 if dtype == torch.float32 else 1
            entry = f"sg3_{name}_blocks_per_sm"
            occupancy = {label: (getattr(lib, entry)(qh, qw, j, i, code) if name == "fir_banded"
                                 else getattr(lib, entry)(qh, qw, c, TAPS, TAPS, code))
                         for label, lib in libs.items() if hasattr(lib, entry)}
            gen = torch.Generator(device=dev).manual_seed(400 + c)
            p = torch.randn(shape, generator=gen, device=dev).to(dtype)
            mw = torch.from_numpy(banded(j, qw, taps)).to(dev, dtype)
            mh = torch.from_numpy(banded(i, qh, taps)).to(dev, dtype)

            def call(label: str) -> torch.Tensor:
                with cuda_build.swapped(name, libs[label]):
                    if name == "fir_taps":
                        return fir_cuda.fir_taps_cuda(p, taps, taps)
                    return fir_cuda.fir_banded_cuda(p, mw, mh)

            outs = {label: call(label) for label in libs}
            ref = fir_taps_ref(p, taps, taps) if name == "fir_taps" else fir_banded_ref(p, mw, mh)
            torch.cuda.synchronize()
            errs = {}
            for label, out in outs.items():
                errs[label] = float((out - ref).abs().max())
                if not errs[label] <= FIR_TOL * float(ref.abs().max()):
                    raise SystemExit(f"{label} at {shape} {dtype}: max abs err {errs[label]:.3e} "
                                     f"against the plain version")
            first = next(iter(outs))
            same = {label: torch.equal(outs[first], o) for label, o in outs.items()
                    if label != first}
            times = version_turns.turns(call, order, args.iters)
            print(f"{name} {list(shape)} {str(dtype)[6:]}: "
                  + " / ".join(f"{label} {t:.4f}" for label, t in zip(order, times))
                  + f" ms; blocks per SM {occupancy}; equal to {first}'s: {same}; max abs err "
                  + ", ".join(f"{label} {e:.3e}" for label, e in errs.items())
                  + f" (tol {FIR_TOL:g}·{float(ref.abs().max()):.3g}) [{smi}]", flush=True)
            results[shape, str(dtype)[6:]] = version_turns.means(order, times)
            del p, mw, mh, outs, ref
            torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()

"""Banded-FIR probe: one two-axis FIR as tap chains and as two banded products.

The port of the JAX package's probe `scripts/exp_mxu_down.py`, with its
flags and its lines. On the card the tap chains run on the CUDA cores
(`csrc/fir_taps.cu`) and the banded products on the tensor cores
(`csrc/fir_banded.cu`); with ``--device cpu`` both take their plain
versions. P is standard normal from a seeded ``torch.Generator`` (seed 0),
made on the CPU and moved, so both devices see the same plane; the taps are
the probe's Hann window. Times come from CUDA events over ``--iters`` calls
after warm-up (the host clock on the CPU).

    python -m stylegan3_editing_tpu_torch.scripts.exp_mxu_down [--dtype f32|bf16]
        [--iters 32] [--qh 76] [--qw 76] [--c 128] [--taps 12] [--device cuda|cpu]

In bf16 the ``rel err vpu vs mxu`` line measures the rounding of the taps to
bf16 in the matrices (about 2e-3), not the tensor cores.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..device import resolve_device
from ..ops.banded_fir import banded, fir_banded, fir_taps, hann_taps

WARMUP = 2  # calls before the timed ones; each call is one launch of its kernel


def time_ms(fn: Callable[[], torch.Tensor], iters: int, device: torch.device) -> float:
    """Mean ms per call over ``iters`` calls after `WARMUP` calls."""
    for _ in range(WARMUP):
        fn()
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def main(argv: Optional[Sequence[str]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the probe; return the tap-chain and the banded-product outputs."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--qh", type=int, default=76)
    ap.add_argument("--qw", type=int, default=76)
    ap.add_argument("--c", type=int, default=128)
    ap.add_argument("--taps", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.iters < 1:
        ap.error("--iters must be at least 1")
    device = resolve_device(args.device)

    dt_in = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    taps = hann_taps(args.taps)
    i_out = args.qh - args.taps + 1
    j_out = args.qw - args.taps + 1
    mw = torch.from_numpy(banded(j_out, args.qw, taps)).to(device, dt_in)
    mh = torch.from_numpy(banded(i_out, args.qh, taps)).to(device, dt_in)
    p = torch.randn((args.qh, args.qw, args.c),
                    generator=torch.Generator().manual_seed(0)).to(device, dt_in)

    print(f"planes [{args.qh},{args.qw},{args.c}] {args.dtype}, "
          f"taps {args.taps}, out [{i_out},{j_out},{args.c}], device {device.type}")
    outputs = []
    for name, fn in (("vpu-chain", lambda: fir_taps(p, taps, taps)),
                     ("mxu-dot", lambda: fir_banded(p, mw, mh))):
        outputs.append(fn())
        print(f"{name:10s} {time_ms(fn, args.iters, device):8.3f} ms/call")
    y_vpu, y_mxu = outputs
    err = float((y_vpu - y_mxu).abs().max()) / (float(y_vpu.abs().max()) + 1e-9)
    print(f"rel err vpu vs mxu: {err:.2e}")
    return y_vpu, y_mxu


if __name__ == "__main__":
    main()

"""Versions of the backward kernel's source, checked and timed in turns on one card.

    python -m stylegan3_editing_tpu_torch.scripts.bwd_versions \\
        parent=path/a.cu new=path/b.cu [--order parent,new,new,parent] \\
        [--layers L10,L11] [--iters 10]

Each ``LABEL=PATH`` names a version of `ops/csrc/filtered_lrelu_bwd.cu` with
its C interface; its local headers come from PATH's directory. All versions
are built at once by `cuda_build.build_versions`, and ptxas' registers and
spills are printed. Then, on each filtered-lrelu layer of SG3-R 1024 at
batch 4 (random inputs from seed 300, in the layer's dtype), every version
is launched through `flrelu_cuda.filtered_lrelu_bwd_cuda` with its library
swapped in (`cuda_build.swapped`): its dx is checked on images 0 and 3
against `filtered_lrelu_bwd_ref` at the tolerance of `chip_smoke.py` phase
6, compared with the first version's, and timed with CUDA events
(``--iters`` calls after two) in ``--order``. Versions are compared inside
one call only, in mirrored order, since the card's speed drifts within a
call.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..models.sg3 import build_synthesis_layout, sg3_r_config
from ..ops import cuda_build, flrelu_cuda
from ..ops.filtered_lrelu import filtered_lrelu_bwd_ref
from . import version_turns


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Check and time the versions; return each label's total ms over the
    layers (the mean of its turns)."""
    args, sources, order = version_turns.parse(
        argv, __doc__.splitlines()[0], "filtered_lrelu_bwd.cu", iters=10,
        extra=lambda ap: ap.add_argument("--layers", default="", help="layer name prefixes, "
                                         "e.g. L10,L11 (all)"))
    dev, libs, smi = version_turns.build("filtered_lrelu_bwd", sources)
    layers = [s for s in build_synthesis_layout(sg3_r_config(1024)).layers
              if s.up_filter is not None]
    if args.layers:
        layers = [s for s in layers if s.name.split("_")[0] in args.layers.split(",")]
    totals = [0.0] * len(order)
    for s in layers:
        gen = torch.Generator(device=dev).manual_seed(300)
        dt = torch.bfloat16 if s.use_bf16 else torch.float32
        x = (torch.randn((4, s.in_size[1], s.in_size[0], s.out_channels), generator=gen,
                         device=dev) * 60).to(dt)
        b = torch.randn((s.out_channels,), generator=gen, device=dev)
        dy = torch.randn((4, s.out_size[1], s.out_size[0], s.out_channels), generator=gen,
                         device=dev).to(dt)

        def call(label: str) -> torch.Tensor:
            with cuda_build.swapped("filtered_lrelu_bwd", libs[label]):
                return flrelu_cuda.filtered_lrelu_bwd_cuda(
                    dy, x, s.up_filter, s.down_filter, b, s.up_factor, s.padding,
                    2 ** 0.5, 0.2, s.conv_clamp)

        outs = {label: call(label) for label in libs}
        torch.cuda.synchronize()
        checks = []
        atol, rtol = (1e-3, 2 ** -8) if s.use_bf16 else (1e-4, 1e-4)
        for k in (0, 3):
            ref = filtered_lrelu_bwd_ref(dy[k:k + 1].float(), x[k:k + 1].float(), s.up_filter,
                                         s.down_filter, b, s.up_factor, s.padding,
                                         clamp=s.conv_clamp)
            for label, dx in outs.items():
                err = (dx[k:k + 1].float() - ref).abs()
                checks.append(f"{label}[{k}] {float(err.max()):.3e}")
                if not bool((err <= atol + rtol * ref.abs()).all()):
                    raise SystemExit(f"{label} on {s.name}: dx off its plain version")
        first = next(iter(outs))
        same = {label: torch.equal(outs[first], dx) for label, dx in outs.items() if label != first}
        times = version_turns.turns(call, order, args.iters)
        totals = [total + t for total, t in zip(totals, times)]
        print(f"{s.name} {str(dt)[6:]} u{s.up_factor} batch 4: "
              + " / ".join(f"{label} {t:.4f}" for label, t in zip(order, times))
              + f" ms; dx equal to {first}'s: {same}; max abs err vs plain: {', '.join(checks)}",
              flush=True)
        del x, dy, outs
        torch.cuda.empty_cache()
    print("all layers: " + " / ".join(f"{label} {t:.4f}" for label, t in zip(order, totals))
          + f" ms [{smi}]")
    return version_turns.means(order, totals)


if __name__ == "__main__":
    main()

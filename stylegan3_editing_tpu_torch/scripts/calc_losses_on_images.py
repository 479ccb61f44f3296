"""Reconstruction metrics (LPIPS, L2 or MS-SSIM) over output directories.

The port of the JAX package's `scripts/calc_losses_on_images.py` (reference
inversion/scripts/calc_losses_on_images.py): each ``step_*`` directory
under ``--output_path`` (or the directory itself) is scored image by image
against the same names under ``--gt_path``, both resized to 256², and
``<output_path>/<mode>_scores.json`` gets the mean, std and count per
directory. LPIPS is AlexNet's (``--lpips_variables``: a converted ``.npz``
of the criterion's variables); MS-SSIM takes L = 2. It runs on the CUDA
card unless ``--device cpu`` is given. `make_metric` is the device part, a
function of NHWC arrays.

    python -m stylegan3_editing_tpu_torch.scripts.calc_losses_on_images \\
        --mode lpips --output_path OUT --gt_path GT [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..criteria import LPIPS, msssim
from ..data.transforms import compose, pil_to_array, resize
from ..device import DeviceLike, resolve_device
from ..utils.cli import parse_dataclass

MODES = ("lpips", "l2", "msssim")
IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg")


@dataclasses.dataclass
class LossCalcOptions:
    """Score reconstructions against ground-truth images."""

    mode: str = "lpips"  # 'lpips' | 'l2' | 'msssim'
    output_path: str = "./inference_results"
    gt_path: str = "./gt_images"
    batch_size: int = 4
    lpips_variables: Optional[str] = None  # converted LPIPS variables (.npz)
    device: Optional[str] = None  # cuda unless "cpu"


def make_metric(mode: str, device: DeviceLike = None,
                lpips_variables: Optional[str] = None
                ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``metric(a, b)`` → one score per image pair, ``[N]``, for NHWC images
    in [-1, 1] on ``device``; each image scored alone, as the JAX CLI's
    batch-1 calls do."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    device = resolve_device(device)
    if mode == "l2":
        return lambda a, b: (a - b).square().mean((1, 2, 3))
    if mode == "msssim":
        return lambda a, b: msssim(a, b, size_average=False, val_range=2.0)
    lpips = LPIPS(net_type="alex", device=device).eval()
    if lpips_variables:
        from ..models.sg3 import load_jax_variables
        from ..models.sg3.convert import npz_to_variables

        load_jax_variables(lpips, npz_to_variables(lpips_variables))
    return lpips.per_image


def run(opts: LossCalcOptions) -> dict:
    from PIL import Image

    device = resolve_device(opts.device)
    metric = make_metric(opts.mode, device, opts.lpips_variables)
    prep = compose(resize(256), pil_to_array)
    out_root = Path(opts.output_path)
    step_dirs = sorted(out_root.glob("step_*")) or [out_root]

    def batch(paths):
        return torch.from_numpy(np.stack([prep(Image.open(p)) for p in paths])).to(device)

    results = {}
    for step_dir in step_dirs:
        scores = []
        names = sorted(p.name for p in step_dir.iterdir() if p.suffix.lower() in IMAGE_SUFFIXES)
        for start in range(0, len(names), opts.batch_size):
            chunk = names[start:start + opts.batch_size]
            with torch.inference_mode():
                s = metric(batch(step_dir / n for n in chunk),
                           batch(Path(opts.gt_path) / n for n in chunk))
            scores.extend(s.cpu().numpy().tolist())
        results[step_dir.name] = {"mean": float(np.mean(scores)), "std": float(np.std(scores)),
                                  "n": len(scores)}
        print(f"{opts.mode} {step_dir.name}: {results[step_dir.name]['mean']:.4f} "
              f"± {results[step_dir.name]['std']:.4f}")
    with open(out_root / f"{opts.mode}_scores.json", "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return run(parse_dataclass(LossCalcOptions, argv))


if __name__ == "__main__":
    main()

"""Batch ReStyle inversion: per-step reconstructions, latents.npy and stats.

The port of the JAX package's `scripts/inference_iterative.py` (reference
inversion/scripts/inference_iterative.py), with its options and outputs:
``<exp_dir>/inference_results/step_<i>/<image>``, ``latents.npy`` (name →
``[n_iters, n_styles, 512]``) and ``stats.txt``. It runs on the CUDA card
unless ``--device cpu`` is given, under `torch.inference_mode`; the per-batch
times end in a device synchronise.

    python -m stylegan3_editing_tpu_torch.scripts.inference_iterative \\
        --checkpoint_path CKPT --data_path DIR --exp_dir OUT [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..data import BatchIterator, ImagesDataset, encode_transforms
from ..device import resolve_device
from ..models.encoders import get_average_image, run_restyle_iterations
from ..utils.cli import parse_dataclass
from ..utils.common import tensor2im
from ..utils.inference_utils import load_encoder


@dataclasses.dataclass
class TestOptions:
    """ReStyle inversion of a folder of images (reference test_options.py)."""

    exp_dir: str = "./experiments/inference"
    checkpoint_path: Optional[str] = None
    data_path: str = "./data"
    resize_outputs: bool = True
    test_batch_size: int = 2
    n_iters_per_batch: int = 3
    n_images: Optional[int] = None
    landmarks_transforms_path: Optional[str] = None
    device: Optional[str] = None  # cuda unless "cpu"


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def run(opts: TestOptions) -> dict:
    device = resolve_device(opts.device)
    out_dir = Path(opts.exp_dir) / "inference_results"
    out_dir.mkdir(parents=True, exist_ok=True)

    model, _ = load_encoder(opts.checkpoint_path, device=device)
    avg_image, latent_avg = get_average_image(model)

    transforms = None
    if opts.landmarks_transforms_path:
        transforms = np.load(opts.landmarks_transforms_path, allow_pickle=True).item()

    t = encode_transforms()["transform_inference"]
    dataset = ImagesDataset(opts.data_path, opts.data_path, target_transform=t)
    names = [p.name for p in dataset.source_paths]
    if opts.n_images:
        names = names[:opts.n_images]

    all_latents = {}
    times = []
    it = BatchIterator(dataset, opts.test_batch_size, shuffle=False)
    count = 0
    for x, _ in it.epoch_batches():
        if opts.n_images and count >= opts.n_images:
            break
        batch_names = names[count:count + x.shape[0]]
        lm = None
        if transforms is not None:
            lm = torch.as_tensor(np.stack([
                transforms[n][-2] if isinstance(transforms[n], tuple) else transforms[n]
                for n in batch_names]), dtype=torch.float32, device=device)
        tic = time.time()
        results = run_restyle_iterations(
            model, torch.from_numpy(x).to(device), avg_image, latent_avg,
            n_iters=opts.n_iters_per_batch, landmarks_transform=lm,
            resize=opts.resize_outputs)
        _synchronize(device)
        times.append(time.time() - tic)

        for bi, name in enumerate(batch_names):
            all_latents[name] = np.stack([codes[bi].cpu().numpy() for _, _, codes in results])
            for step, (aligned, unaligned, _) in enumerate(results):
                img = unaligned if unaligned is not None else aligned
                step_dir = out_dir / f"step_{step}"
                step_dir.mkdir(exist_ok=True)
                tensor2im(img[bi]).save(step_dir / name)
        count += x.shape[0]

    np.save(Path(opts.exp_dir) / "latents.npy", all_latents)
    stats = {"mean_per_batch_s": float(np.mean(times)),
             "std_per_batch_s": float(np.std(times)),
             "batches": len(times)}
    with open(Path(opts.exp_dir) / "stats.txt", "w") as f:
        f.write(json.dumps(stats))
    print(f"inverted {count} images on {device} | {stats}")
    return all_latents


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return run(parse_dataclass(TestOptions, argv))


if __name__ == "__main__":
    main()

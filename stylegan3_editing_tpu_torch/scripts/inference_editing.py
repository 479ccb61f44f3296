"""Invert a folder of images, then InterFaceGAN-edit over factor ranges.

The port of the JAX package's `scripts/inference_editing.py` (reference
inversion/scripts/inference_editing.py), with its options and outputs:
per-image ReStyle inversion, then for each direction one batched synthesis
over the factors ``-factor_range … factor_range``, written to
``<exp_dir>/editing_results/<direction>/<image stem>/<factor>.jpg``. It runs
on the CUDA card unless ``--device cpu`` is given, under
`torch.inference_mode`.

    python -m stylegan3_editing_tpu_torch.scripts.inference_editing \\
        --checkpoint_path CKPT --data_path DIR --boundaries_dir DIR \\
        --exp_dir OUT [--edit_directions age smile] [--device cpu]
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from ..configs import model_paths
from ..data import BatchIterator, ImagesDataset, encode_transforms
from ..device import resolve_device
from ..editing.interfacegan import FaceEditor
from ..models.encoders import get_average_image, run_restyle_iterations
from ..utils.cli import parse_dataclass
from ..utils.common import tensor2im
from ..utils.inference_utils import load_encoder


@dataclasses.dataclass
class EditOptions:
    """ReStyle inversion, then InterFaceGAN edits of each image."""

    exp_dir: str = "./experiments/editing"
    checkpoint_path: Optional[str] = None
    data_path: str = "./data"
    boundaries_dir: Optional[str] = None
    edit_directions: List[str] = dataclasses.field(
        default_factory=lambda: ["age", "smile", "pose"])
    factor_range: int = 5
    test_batch_size: int = 2
    n_iters_per_batch: int = 3
    n_images: Optional[int] = None
    device: Optional[str] = None  # cuda unless "cpu"


@torch.inference_mode()
def run(opts: EditOptions) -> Path:
    device = resolve_device(opts.device)
    out = Path(opts.exp_dir) / "editing_results"
    out.mkdir(parents=True, exist_ok=True)

    model, _ = load_encoder(opts.checkpoint_path, device=device)
    avg_image, latent_avg = get_average_image(model)
    editor = FaceEditor(model.decoder, boundaries_dir=opts.boundaries_dir
                        or model_paths["interfacegan_boundaries"])

    t = encode_transforms()["transform_inference"]
    dataset = ImagesDataset(opts.data_path, opts.data_path, target_transform=t)
    names = [p.name for p in dataset.source_paths][:opts.n_images]
    it = BatchIterator(dataset, opts.test_batch_size, shuffle=False)
    count = 0
    for x, _ in it.epoch_batches():
        if opts.n_images and count >= opts.n_images:
            break
        batch_names = names[count:count + x.shape[0]]
        results = run_restyle_iterations(model, torch.from_numpy(x).to(device), avg_image,
                                         latent_avg, n_iters=opts.n_iters_per_batch)
        codes = results[-1][2]
        for direction in opts.edit_directions:
            if direction not in editor.directions:
                print(f"skipping {direction}: no boundary file")
                continue
            images, _ = editor.edit(codes, direction,
                                    factor_range=(-opts.factor_range, opts.factor_range + 1))
            for fi, batch_imgs in enumerate(images):
                factor = -opts.factor_range + fi
                for bi, name in enumerate(batch_names):
                    d = out / direction / Path(name).stem
                    d.mkdir(parents=True, exist_ok=True)
                    tensor2im(batch_imgs[bi]).save(d / f"{factor}.jpg")
        count += x.shape[0]
    print(f"edited {count} images on {device} → {out}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> Path:
    return run(parse_dataclass(EditOptions, argv))


if __name__ == "__main__":
    main()

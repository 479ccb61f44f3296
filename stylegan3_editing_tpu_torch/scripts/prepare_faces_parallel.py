"""Align or crop a folder of face images over a worker pool (CLI, host only).

The port of the JAX package's `scripts/prepare_faces_parallel.py`
(reference prepare_data/preparing_faces_parallel.py), with the same
options: dlib's 68 landmarks of each image, then FFHQ alignment
(``--mode align``) or the fixed crop with an optional random shift
(``--mode crop``), through the port's `utils.alignment_utils`. Nothing runs
on the card: dlib and PIL work in a `multiprocessing` pool; each worker
loads dlib's model (`configs.model_paths["shape_predictor"]`).

    python -m stylegan3_editing_tpu_torch.scripts.prepare_faces_parallel \\
        --mode align --root_path RAW [--output_path OUT] [--num_workers 4]
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
from functools import partial
from pathlib import Path
from typing import Optional, Sequence

from ..configs import model_paths
from ..utils import alignment_utils as au
from ..utils.cli import parse_dataclass


@dataclasses.dataclass
class PrepareOptions:
    mode: str = "align"  # 'align' | 'crop'
    root_path: str = "./raw_images"
    output_path: Optional[str] = None
    num_workers: int = 4
    random_shift: float = 0.05
    output_size: int = 1024


def _process_one(path_str: str, opts: PrepareOptions, out_dir: Path) -> str:
    from PIL import Image

    detector, predictor = au.get_dlib_detector(model_paths["shape_predictor"])
    path = Path(path_str)
    try:
        lm = au.get_landmark(str(path), detector, predictor)
        img = Image.open(path).convert("RGB")
        if opts.mode == "align":
            result = au.align_face_from_landmarks(img, lm, opts.output_size)
        else:
            result = au.crop_face_from_landmarks(img, lm, random_shift=opts.random_shift,
                                                 output_size=opts.output_size)
        result.save(out_dir / path.name)
        return f"ok {path.name}"
    except Exception as e:  # the reference's protocol: report the image and go on
        return f"failed {path.name}: {e}"


def run(opts: PrepareOptions) -> None:
    root = Path(opts.root_path)
    out_dir = Path(opts.output_path or f"{opts.root_path}_{opts.mode}ed")
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = [str(p) for p in sorted(root.iterdir())
             if p.suffix.lower() in (".png", ".jpg", ".jpeg")]
    with mp.Pool(opts.num_workers) as pool:
        for res in pool.imap_unordered(partial(_process_one, opts=opts, out_dir=out_dir),
                                       paths):
            print(res)


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(parse_dataclass(PrepareOptions, argv))


if __name__ == "__main__":
    main()

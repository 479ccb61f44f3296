"""Train a ReStyle-e4e encoder (CLI).

The port of the JAX package's `scripts/train_restyle_e4e.py` (reference
inversion/scripts/train_restyle_e4e.py): the e4e options (latent
discriminator, delta loss, progressive stages) and
``--resume_training_from_ckpt``, trained by `train_restyle_psp.train` (its
`build_coach` and `build_data`). It runs on the CUDA card unless
``--device cpu`` is given.

    python -m stylegan3_editing_tpu_torch.scripts.train_restyle_e4e \\
        --train_root DIR --exp_dir OUT --w_discriminator_lambda 0.1 [--device cpu]
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..training.coach import Coach
from ..training.options import E4eTrainOptions
from ..utils.cli import parse_dataclass
from .train_restyle_psp import train


@dataclasses.dataclass
class E4eCliOptions(E4eTrainOptions):
    train_root: Optional[str] = None
    test_root: Optional[str] = None
    resume_training_from_ckpt: Optional[str] = None
    device: Optional[str] = None  # cuda unless "cpu"


def main(opts) -> Coach:
    return train(opts, opts.resume_training_from_ckpt or opts.checkpoint_path)


if __name__ == "__main__":
    main(parse_dataclass(E4eCliOptions))

"""Training option dataclasses (defaults match the reference).

A copy of the JAX package's `training/options.py` (reference
inversion/options/train_options.py and e4e_train_options.py), so
`utils.inference_utils.load_encoder` rebuilds them from a checkpoint's
sidecar. Parsed from the CLI with `utils.cli.parse_dataclass`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class TrainOptions:
    """ReStyle pSp encoder training options."""

    # General
    exp_dir: str = "./experiments/experiment"
    dataset_type: str = "ffhq_encode"
    encoder_type: str = "BackboneEncoder"
    input_nc: int = 6
    output_size: int = 1024
    n_iters_per_batch: int = 3

    # Dataset
    batch_size: int = 2
    test_batch_size: int = 2
    workers: int = 4

    # Optimizer
    learning_rate: float = 1e-4
    optim_name: str = "ranger"
    train_decoder: bool = False
    start_from_latent_avg: bool = True

    # Loss weights
    lpips_lambda: float = 0.0
    id_lambda: float = 0.0
    l2_lambda: float = 0.0
    w_norm_lambda: float = 0.0
    moco_lambda: float = 0.0

    # Checkpoints
    stylegan_weights: Optional[str] = None
    checkpoint_path: Optional[str] = None

    # Logging / schedule
    max_steps: int = 500000
    image_interval: int = 100
    board_interval: int = 50
    val_interval: int = 1000
    save_interval: Optional[int] = None
    max_val_batches: Optional[int] = None

    # Effective batch per optimizer step (reference: 8 / batch_size grad accum,
    # coach_restyle_psp.py:128-130).
    effective_batch_size: int = 8

    # Additions over the reference
    seed: int = 0
    force_fp32_decoder: bool = True

    # Decoder capacity overrides (None = SG3-R preset defaults). Useful for
    # small-resolution runs and CPU smoke tests.
    decoder_channel_base: Optional[int] = None
    decoder_channel_max: Optional[int] = None
    decoder_num_layers: Optional[int] = None


@dataclasses.dataclass
class E4eTrainOptions(TrainOptions):
    """ReStyle e4e training options (adds latent discriminator etc.)."""

    w_discriminator_lambda: float = 0.0
    w_discriminator_lr: float = 2e-5
    r1: float = 10.0
    d_reg_every: int = 16
    use_w_pool: bool = True
    w_pool_size: int = 50
    truncation_psi: float = 1.0

    n_styles: int = 16

    delta_norm: int = 2
    delta_norm_lambda: float = 2e-4

    progressive_steps: Optional[List[int]] = None
    progressive_start: Optional[int] = None
    progressive_step_every: int = 2000

    encoder_type: str = "ProgressiveBackboneEncoder"

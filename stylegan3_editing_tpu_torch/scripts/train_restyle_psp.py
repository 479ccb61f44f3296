"""Train a ReStyle-pSp encoder (CLI).

The port of the JAX package's `scripts/train_restyle_psp.py` (reference
inversion/scripts/train_restyle_psp.py): dataclass options → `Coach.train`,
then a ``final_model`` checkpoint. The dataset roots come from the registry
(`configs.get_dataset_registry`) keyed by ``--dataset_type``, or from
``--train_root`` / ``--test_root``. ``--stylegan_weights`` reads a
converted ``.npz`` or a reference ``.pt`` state dict; the ``--decoder_*``
options slim the decoder. It runs on the CUDA card unless ``--device cpu``
is given, in one process.

    python -m stylegan3_editing_tpu_torch.scripts.train_restyle_psp \\
        --train_root DIR --exp_dir OUT --lpips_lambda 0.8 --l2_lambda 1 \\
        --id_lambda 0.1 [--device cpu]
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

from ..configs import get_dataset_registry
from ..data import BatchIterator, ImagesDataset, encode_transforms
from ..models.sg3 import sg3_r_config
from ..models.sg3.convert import load_torch_pt, npz_to_variables
from ..runtime.profiling import maybe_start_trace, stop_trace
from ..training.coach import Coach
from ..training.options import TrainOptions
from ..utils.cli import parse_dataclass


@dataclasses.dataclass
class PspCliOptions(TrainOptions):
    train_root: Optional[str] = None
    test_root: Optional[str] = None
    device: Optional[str] = None  # cuda unless "cpu"


def build_coach(opts) -> Coach:
    overrides = {}
    if opts.decoder_channel_base:
        overrides["channel_base"] = opts.decoder_channel_base
    if opts.decoder_channel_max:
        overrides["channel_max"] = opts.decoder_channel_max
    if opts.decoder_num_layers:
        overrides["num_layers"] = opts.decoder_num_layers
    decoder_cfg = sg3_r_config(opts.output_size, **overrides)
    decoder_variables = None
    if opts.stylegan_weights:
        path = str(opts.stylegan_weights)
        if path.endswith(".npz"):
            decoder_variables = npz_to_variables(path)
        else:
            decoder_variables, _ = load_torch_pt(path, decoder_cfg)
    return Coach(opts, decoder_cfg=decoder_cfg, decoder_variables=decoder_variables,
                 device=opts.device)


def build_data(opts):
    t = encode_transforms(seed=opts.seed)
    if opts.train_root:
        train_root = opts.train_root
        test_root = opts.test_root or train_root
    else:
        reg = get_dataset_registry()[opts.dataset_type]
        train_root, test_root = reg["train_target_root"], reg["test_target_root"]
    train_ds = ImagesDataset(train_root, train_root, target_transform=t["transform_gt_train"])
    test_ds = ImagesDataset(test_root, test_root, target_transform=t["transform_test"])
    train_iter = iter(BatchIterator(train_ds, opts.batch_size, seed=opts.seed))

    def val_batches():
        return BatchIterator(test_ds, opts.test_batch_size,
                             shuffle=False).epoch_batches(opts.max_val_batches)

    return train_iter, val_batches


def train(opts, resume_from: Optional[str] = None) -> Coach:
    """Build the data (the roots checked before the model is built) and the
    coach, restore ``resume_from`` if given, train (a `torch.profiler`
    capture when SG3TPU_TRACE_DIR is set) and write ``final_model``."""
    train_iter, val_batches = build_data(opts)
    coach = build_coach(opts)
    if resume_from:
        coach.restore(resume_from)
    maybe_start_trace()
    try:
        coach.train(train_iter, val_batches_fn=val_batches)
    finally:
        trace_dir = stop_trace()
        if trace_dir:
            print(f"profiler trace written to {trace_dir}")
    coach.checkpoint(Path(opts.exp_dir) / "checkpoints" / "final_model")
    print(f"done: {coach.global_step} steps, best_val_loss={coach.best_val_loss}")
    return coach


def main(opts) -> Coach:
    return train(opts, opts.checkpoint_path)


if __name__ == "__main__":
    main(parse_dataclass(PspCliOptions))

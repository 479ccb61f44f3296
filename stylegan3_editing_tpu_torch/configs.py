"""Path registry of the released weights the port reads.

A slice of the JAX package's `configs.py`: the entries a ported module uses.

Parity: reference configs/paths_config.py. Paths are overridable through
SG3TPU_MODELS so the framework runs anywhere without editing source.
"""

from __future__ import annotations

import os
from pathlib import Path

_MODELS = Path(os.environ.get("SG3TPU_MODELS", "/pretrained_models"))

model_paths = {
    "clip_vit_b32": _MODELS / "clip_vit_b32.pt",
    "clip_bpe_vocab": _MODELS / "bpe_simple_vocab_16e6.txt.gz",
    # Face alignment (the video pipeline, prepare_faces_parallel).
    "shape_predictor": _MODELS / "shape_predictor_68_face_landmarks.dat",
    # The ID-similarity metric's detector (calc_id_loss_parallel).
    "mtcnn_pnet": _MODELS / "mtcnn" / "pnet.npy",
    "mtcnn_rnet": _MODELS / "mtcnn" / "rnet.npy",
    "mtcnn_onet": _MODELS / "mtcnn" / "onet.npy",
    # Editing assets.
    "styleclip_delta_i_c": _MODELS / "styleclip" / "delta_i_c.npy",
    "styleclip_s_stats": _MODELS / "styleclip" / "s_stats",
    "interfacegan_boundaries": _MODELS / "interfacegan",
}

"""Path and dataset registries.

A slice of the JAX package's `configs.py`: the model paths a ported module
uses, and the datasets the encoder trainers read.

Parity: reference configs/paths_config.py (model and dataset paths) and
configs/data_configs.py (dataset_type → roots). Paths are overridable
through SG3TPU_DATA and SG3TPU_MODELS so the framework runs anywhere
without editing source.
"""

from __future__ import annotations

import os
from pathlib import Path

_DATA = Path(os.environ.get("SG3TPU_DATA", "/data"))
_MODELS = Path(os.environ.get("SG3TPU_MODELS", "/pretrained_models"))

dataset_paths = {
    "ffhq": _DATA / "ffhq" / "images",
    "ffhq_unaligned": _DATA / "ffhq" / "unaligned",
    "celeba_test": _DATA / "celeba" / "test",
    "animalfaces_train": _DATA / "animalfaces" / "train",
    "animalfaces_test": _DATA / "animalfaces" / "test",
    "flowers_train": _DATA / "flowers" / "train",
    "flowers_test": _DATA / "flowers" / "test",
    "vggface_train": _DATA / "vggface" / "train",
    "vggface_test": _DATA / "vggface" / "test",
    "cifar_train": _DATA / "cifar" / "train",
    "cifar_test": _DATA / "cifar" / "test",
    "mini_train": _DATA / "mini_imagenet" / "train",
    "mini_test": _DATA / "mini_imagenet" / "test",
}

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


def get_dataset_registry():
    """dataset_type → {train/test source/target roots} (EncodeTransforms)."""
    pairs = {
        "ffhq_encode": ("ffhq", "celeba_test"),
        "animalfaces_encode": ("animalfaces_train", "animalfaces_test"),
        "flowers_encode": ("flowers_train", "flowers_test"),
        "vggface_encode": ("vggface_train", "vggface_test"),
        "cifar_encode": ("cifar_train", "cifar_test"),
        "mini_encode": ("mini_train", "mini_test"),
    }
    return {
        name: {
            "train_source_root": dataset_paths[train],
            "train_target_root": dataset_paths[train],
            "test_source_root": dataset_paths[test],
            "test_target_root": dataset_paths[test],
        }
        for name, (train, test) in pairs.items()
    }

"""Checkpoint I/O in the JAX package's numpy format, plus a JSON sidecar.

Counterpart of the JAX package's `runtime/checkpoint.py`. A checkpoint is a
directory holding ``arrays.npz`` (one array per leaf, ``l0``, ``l1``, …) and
``sg3tpu_manifest.json`` (the tree's structure with ``{"__leaf__": i}``
placeholders), and beside it ``<dir>.json`` with the options and progress
counters. The JAX package writes this format from multi-process runs and
reads it always. Its single-process saves are orbax checkpoints, which the
port cannot read (it does not import orbax, and the card machine has none):
`load_pytree` raises on them; the JAX package's `load_pytree` reads one,
and this module's `save_pytree` writes its tree again in the numpy format.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np

_NPZ_MANIFEST = "sg3tpu_manifest.json"


def _leaf(value) -> np.ndarray:
    if hasattr(value, "detach"):  # a torch tensor, on any device
        value = value.detach().cpu().numpy()
    return np.asarray(value)


def _serialize_structure(node, leaves: list):
    """Tree → JSON structure with ``{"__leaf__": i}`` placeholders
    (namedtuples → field-name dicts, tuples → lists, as orbax restores)."""
    if node is None:
        return None
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return {k: _serialize_structure(getattr(node, k), leaves) for k in node._fields}
    if isinstance(node, dict):
        return {str(k): _serialize_structure(v, leaves) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_serialize_structure(v, leaves) for v in node]
    leaves.append(_leaf(node))
    return {"__leaf__": len(leaves) - 1}


def _deserialize_structure(node, arrays):
    if node is None:
        return None
    if isinstance(node, dict):
        if set(node) == {"__leaf__"}:
            return arrays[f"l{node['__leaf__']}"]
        return {k: _deserialize_structure(v, arrays) for k, v in node.items()}
    if isinstance(node, list):
        return [_deserialize_structure(v, arrays) for v in node]
    raise ValueError(f"unexpected manifest node: {type(node)}")


def save_pytree(path, tree, metadata: Optional[dict] = None) -> None:
    """Save a tree of arrays (numpy or torch) in the numpy format, and the
    metadata, if given, as the ``<path>.json`` sidecar. An existing
    directory at ``path`` is replaced."""
    path = Path(path).absolute()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    leaves: list = []
    structure = _serialize_structure(tree, leaves)
    np.savez(path / "arrays.npz", **{f"l{i}": a for i, a in enumerate(leaves)})
    with open(path / _NPZ_MANIFEST, "w") as f:
        json.dump(structure, f)
    if metadata is not None:
        with open(str(path) + ".json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def load_pytree(path) -> Tuple[Any, Optional[dict]]:
    """Load a tree (numpy leaves) and its metadata sidecar (None if absent)."""
    path = Path(path).absolute()
    if not (path / _NPZ_MANIFEST).exists():
        kind = "an orbax checkpoint" if path.is_dir() else "not a checkpoint directory"
        raise ValueError(
            f"{path} is {kind}: the port reads only the numpy format (arrays.npz + "
            f"{_NPZ_MANIFEST}). Load an orbax checkpoint with the JAX package's "
            "runtime.checkpoint.load_pytree and write it again with "
            "stylegan3_editing_tpu_torch.runtime.checkpoint.save_pytree.")
    with open(path / _NPZ_MANIFEST) as f:
        structure = json.load(f)
    with np.load(path / "arrays.npz") as arrays:
        tree = _deserialize_structure(structure, arrays)
    meta = None
    sidecar = Path(str(path) + ".json")
    if sidecar.exists():
        with open(sidecar) as f:
            meta = json.load(f)
    return tree, meta

"""The JAX package's flat ``.npz`` archive of a variable tree, numpy only.

Counterpart of `variables_to_npz` / `npz_to_variables` in the JAX package's
`models/sg3/convert.py`: one array per leaf, keyed by its path as
`jax.tree_util.keystr` writes it for nested dicts (``['params']['mapping']
['fc0']['weight']``). So the ``.npz`` files `scripts/convert_checkpoint.py`
writes load here, and `load_jax_variables` copies the tree into a module.
The reference's ``.pt`` / ``.pkl`` generator converters wait (ROADMAP Queue 1 #4).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np


def _flat_keys(tree: Mapping, prefix: str, out: dict) -> None:
    for key, value in tree.items():
        name = f"{prefix}['{key}']"
        if isinstance(value, Mapping):
            _flat_keys(value, name, out)
        else:
            out[name] = np.asarray(value)


def variables_to_npz(variables: Mapping, path) -> None:
    """Save a nested dict of arrays as a flat ``.npz``."""
    arrays: dict = {}
    _flat_keys(variables, "", arrays)
    np.savez(path, **arrays)


def npz_to_variables(path) -> dict:
    """Inverse of `variables_to_npz`: the nested dict of numpy arrays."""
    tree: dict = {}
    with np.load(path) as arrays:
        for key in arrays.files:
            parts = re.findall(r"\['([^']+)'\]", key)
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = arrays[key]
    return tree

"""Fill a port module's parameters and buffers from the JAX package's variables,
and write a module's state back as such a tree.

``variables`` is the flax tree ``{'params', 'batch_stats', 'buffers', 'ema'}`` as nested
dicts of arrays (numpy, or anything `np.asarray` reads). The port names its
parameters and buffers after the flax paths (``synthesis.L0_36_1024.weight``)
and keeps the same layouts (HWIO conv weights, ``[out, in]`` dense
weights), so each leaf copies into the tensor of the same dotted name, and
`to_jax_variables` nests them back under their collections. That holds
for every module of the port named after its flax paths: a `Generator`, a
`RestyleNet`, and a `SetGAN` (``encoder`` with its batch statistics,
``style_attn.attn_{i}`` / ``style_concat_{i}``, ``decoder`` with its
buffers and EMAs). This module
needs numpy only; the port still imports nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

COLLECTIONS = ("params", "batch_stats", "buffers", "ema")
EMA_BUFFERS = ("w_avg", "magnitude_ema")  # the generator's 'ema' collection


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            _flatten(value, name, out)
        else:
            if name in out:
                raise KeyError(f"{name} appears in more than one collection")
            out[name] = np.asarray(value)


def load_jax_variables(module: nn.Module, variables: Mapping) -> None:
    """Copy every leaf of ``variables`` into ``module``'s state, in place.

    Raises if a name is missing on either side or a shape differs.
    """
    flat: Dict[str, np.ndarray] = {}
    for coll in COLLECTIONS:
        _flatten(variables.get(coll, {}), "", flat)
    state = module.state_dict()
    missing = sorted(set(state) - set(flat))
    unexpected = sorted(set(flat) - set(state))
    if missing or unexpected:
        raise KeyError(f"missing from variables: {missing}; "
                       f"not in the module: {unexpected}")
    with torch.no_grad():
        for name, value in flat.items():
            target = state[name]
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{name}: shape {value.shape} != {tuple(target.shape)}")
            target.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))


def to_jax_variables(module: nn.Module) -> Dict[str, dict]:
    """``module``'s state as the flax tree `load_jax_variables` reads: its
    parameters under ``params``, the statistics of its batch norms under
    ``batch_stats``, the generator's EMAs (`EMA_BUFFERS`) under ``ema`` and
    its other persistent buffers under ``buffers``; numpy leaves (float32),
    empty collections left out."""
    from ..backbones.common import BatchNorm

    params = {name for name, _ in module.named_parameters()}
    tree: Dict[str, dict] = {}
    for name, value in module.state_dict().items():
        owner, _, leaf = name.rpartition(".")
        if name in params:
            coll = "params"
        elif isinstance(module.get_submodule(owner), BatchNorm):
            coll = "batch_stats"
        else:
            coll = "ema" if leaf in EMA_BUFFERS else "buffers"
        node = tree.setdefault(coll, {})
        for key in name.split(".")[:-1]:
            node = node.setdefault(key, {})
        node[leaf] = value.detach().float().cpu().numpy().copy()
    return tree

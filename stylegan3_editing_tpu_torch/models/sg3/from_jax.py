"""Fill a port module's parameters and buffers from the JAX package's variables,
and write a module's state back as such a tree.

``variables`` is the flax tree ``{'params', 'batch_stats', 'buffers', 'ema'}`` as nested
dicts of arrays (numpy, or anything `np.asarray` reads). The port names its
parameters and buffers after the flax paths (``synthesis.L0_36_1024.weight``)
and keeps the same layouts (HWIO conv weights, ``[out, in]`` dense
weights), so each leaf copies into the tensor of the same dotted name, and
`to_jax_variables` nests them back under their collections. That holds
for every module of the port named after its flax paths: a `Generator`, a
`RestyleNet`, a `SetGAN` (``encoder`` with its batch statistics,
``style_attn.attn_{i}`` / ``style_concat_{i}``, ``decoder`` with its
buffers and EMAs) and a `ProjectedSetDiscriminator` (``proj_<backbone>``:
the backbone, its batch statistics, ``ccm*``/``csm*``; ``d_<backbone>``:
``disc*`` and ``set*``).

The SetGAN trainer's snapshots also hold optax's Adam states: `adam_moments`
reads the moments and the step count out of one, and `optax_adam_state`
writes them back in the layout optax gives `SetGANTrainer`'s optimizers,
so a snapshot goes either way between the two packages. This module
needs numpy only; the port still imports nothing of JAX.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

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


def _find_adam(tree):
    """The one ``{count, mu, nu}`` node (optax ``ScaleByAdamState``) of a state tree."""
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        found = [f for f in (_find_adam(v) for v in tree.values()) if f is not None]
    elif isinstance(tree, (list, tuple)):
        found = [f for f in (_find_adam(v) for v in tree) if f is not None]
    else:
        return None
    if len(found) > 1:
        raise ValueError("more than one Adam state in the optimizer tree")
    return found[0] if found else None


def adam_moments(opt_state) -> Tuple[int, Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(step count, first moments, second moments) of the Adam state in an
    optax state tree as a snapshot stores it (namedtuples as dicts, tuples
    as lists); the moments by dotted parameter name, frozen leaves (optax's
    empty ``MaskedNode``) left out."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer tree")
    mu: Dict[str, np.ndarray] = {}
    nu: Dict[str, np.ndarray] = {}
    _flatten(adam["mu"], "", mu)
    _flatten(adam["nu"], "", nu)
    return int(np.asarray(adam["count"])), mu, nu


def _nest(flat: Mapping[str, np.ndarray], names: Iterable[str]) -> dict:
    tree: dict = {}
    for name in names:
        node = tree
        keys = name.split(".")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = np.asarray(flat[name]) if name in flat else {}
    return tree


def optax_adam_state(count: int, mu: Mapping[str, np.ndarray], nu: Mapping[str, np.ndarray],
                     param_names: Iterable[str], schedule: bool,
                     masked: bool) -> object:
    """An optax Adam state tree as `SetGANTrainer` keeps it: ``optax.adam``
    is ``[scale_by_adam, scale_by_schedule or scale]``; ``masked`` wraps it
    in ``multi_transform({"train": adam, "freeze": set_to_zero()})``, where
    the moments of a parameter that does not train are empty (optax's
    ``MaskedNode``). ``param_names`` are all the module's parameters."""
    names = list(param_names)
    c = np.asarray(count, np.int32)
    adam = [{"count": c, "mu": _nest(mu, names), "nu": _nest(nu, names)},
            {"count": c.copy()} if schedule else {}]
    if not masked:
        return adam
    return {"inner_states": {"freeze": {"inner_state": {}}, "train": {"inner_state": adam}}}

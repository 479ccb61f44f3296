"""Checkpoint conversion: reference generator state dicts → the flax variable tree.

Counterpart of the JAX package's `models/sg3/convert.py`, numpy and torch
only. The reference ships generator weights as official `.pkl` pickles
(persistence-embedded classes) and as `.pt` state dicts; both map 1:1 onto
the ``{'params', 'buffers', 'ema'}`` tree of nested numpy arrays, keyed by
the JAX package's flax paths, which `load_jax_variables` copies into a port
`Generator`:

- FC weights keep the reference ``[out, in]`` layout (the same equalized-LR
  convention: stored value = init / lr_multiplier, gains at run time).
- Conv weights transpose OIHW → HWIO.
- ``magnitude_ema`` and ``mapping.w_avg`` go to ``ema``; ``up_filter``,
  ``down_filter`` and the Fourier ``freqs``/``phases`` to ``buffers``.
- ``synthesis.input.transform`` is returned beside the tree, not loaded:
  the user transform is an argument of `synthesize` here.
- Unknown or missing keys and wrong shapes raise, as
  ``load_state_dict(strict=True)``, with an opt-out. The check runs against
  the state dict of a port `Generator` built on the CPU for the config.

`variables_to_npz` / `npz_to_variables` are the JAX package's flat ``.npz``
archive: one array per leaf, keyed by its path as `jax.tree_util.keystr`
writes it for nested dicts (``['params']['mapping']['fc0']['weight']``), so
the files of either package's `convert_checkpoint` load in both.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from .config import SG3Config, build_synthesis_layout


def _assign(tree: dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = np.asarray(value)


def as_numpy(v) -> np.ndarray:
    """A state-dict value (numpy, or a torch tensor on any device) → numpy."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def torch_state_to_variables(
    state: Mapping,
    cfg: SG3Config,
    strict: bool = True,
) -> Tuple[dict, Optional[np.ndarray]]:
    """A reference generator state dict (name → array) → (variables,
    stored transform or None)."""
    layer_names = {spec.name for spec in build_synthesis_layout(cfg).layers}
    params: dict = {}
    buffers: dict = {}
    ema: dict = {}
    transform: Optional[np.ndarray] = None
    unmatched = []

    for name, value in state.items():
        v = as_numpy(value)
        parts = name.split(".")
        if name == "synthesis.input.transform":
            transform = v
        elif parts[0] == "mapping" and parts[1] == "w_avg":
            _assign(ema, ("mapping", "w_avg"), v)
        elif parts[0] == "mapping" and (re.fullmatch(r"fc\d+", parts[1])
                                        or parts[1] == "embed"):
            _assign(params, ("mapping", parts[1], parts[2]), v)
        elif parts[:2] == ["synthesis", "input"] and parts[2] in ("freqs", "phases"):
            _assign(buffers, ("synthesis", "input", parts[2]), v)
        elif parts[:2] == ["synthesis", "input"] and parts[2] == "weight":
            _assign(params, ("synthesis", "input", "weight"), v)
        elif parts[:2] == ["synthesis", "input"] and parts[2] == "affine":
            _assign(params, ("synthesis", "input", "affine", parts[3]), v)
        elif parts[0] == "synthesis" and parts[1] in layer_names:
            lname, leaf = parts[1], parts[2]
            if leaf == "affine":
                _assign(params, ("synthesis", lname, "affine", parts[3]), v)
            elif leaf == "weight":
                _assign(params, ("synthesis", lname, "weight"), v.transpose(2, 3, 1, 0))
            elif leaf == "bias":
                _assign(params, ("synthesis", lname, "bias"), v)
            elif leaf == "magnitude_ema":
                _assign(ema, ("synthesis", lname, "magnitude_ema"), v)
            elif leaf in ("up_filter", "down_filter"):
                _assign(buffers, ("synthesis", lname, leaf), v)
            else:
                unmatched.append(name)
        else:
            unmatched.append(name)

    if strict and unmatched:
        raise ValueError(f"unmatched checkpoint keys: {unmatched[:10]}"
                         f"{'...' if len(unmatched) > 10 else ''}")

    variables = {"params": params, "buffers": buffers, "ema": ema}
    _validate_against_init(variables, cfg, strict=strict)
    return variables, transform


def _validate_against_init(variables: dict, cfg: SG3Config, strict: bool) -> None:
    """Names and shapes of the tree against a port `Generator`'s state dict
    (the counterpart of the JAX package's ``jax.eval_shape`` of its init).
    Not strict, nothing is checked."""
    if not strict:
        return
    import torch

    from .from_jax import _flatten
    from .generator import Generator

    ref = {k: tuple(v.shape) for k, v in Generator(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict().items()}
    flat: Dict[str, np.ndarray] = {}
    for coll in ("params", "buffers", "ema"):
        _flatten(variables.get(coll, {}), "", flat)
    got = {k: tuple(v.shape) for k, v in flat.items()}
    missing = [k for k in ref if k not in got]
    extra = [k for k in got if k not in ref]
    bad_shape = [(k, got[k], ref[k]) for k in ref if k in got and got[k] != ref[k]]
    problems = []
    if missing:
        problems.append(f"missing: {missing[:8]}")
    if extra:
        problems.append(f"unexpected: {extra[:8]}")
    if bad_shape:
        problems.append(f"shape mismatch: {bad_shape[:8]}")
    if problems:
        raise ValueError("checkpoint does not match config: " + "; ".join(problems))


def load_torch_pt(path, cfg: SG3Config, strict: bool = True):
    """A reference ``.pt`` generator state dict (or a ``{"state_dict": ...}``
    wrapper), read by torch's weights-only unpickler → (variables, transform)."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return torch_state_to_variables(state, cfg, strict=strict)


def pkl_generator_state(path, entry: str = "G_ema") -> Tuple[dict, dict]:
    """An official SG3 ``.pkl``'s generator (``entry``, else ``G_ema``, else
    ``G``) → (its state dict, its captured constructor kwargs). The
    embedded class source is never executed and the reference checkout is
    not needed (`persistence.py`); TF1 pickles read through the same entry
    point."""
    from .persistence import load_network_pkl, state_dict_of

    data = load_network_pkl(path)
    g = data.get(entry) or data.get("G_ema") or data.get("G")
    if g is None:
        raise ValueError(f"{path} holds no {entry!r}, G_ema or G entry")
    return state_dict_of(g), dict(getattr(g, "init_kwargs", {}) or {})


def load_pkl(path, cfg: SG3Config, strict: bool = True):
    """An official SG3 ``.pkl`` → (variables, transform), for a known config."""
    state, _ = pkl_generator_state(path)
    return torch_state_to_variables(state, cfg, strict=strict)


def _flat_keys(tree: Mapping, prefix: str, out: dict) -> None:
    for key, value in tree.items():
        name = f"{prefix}['{key}']"
        if isinstance(value, Mapping):
            _flat_keys(value, name, out)
        else:
            out[name] = as_numpy(value)


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
            _assign(tree, tuple(re.findall(r"\['([^']+)'\]", key)), arrays[key])
    return tree

"""Progressive growth ("superres") of the alias-free generator.

Counterpart of the JAX package's `models/sg3/superres.py` (reference
models/styleganxl/training/networks_stylegan3_resetting.py,
`SuperresGenerator`, :595-739): a generator grown from a trained
low-resolution stem keeps the stem's layers below the critically sampled
tail and appends ``head_layers`` new alias-free layers up to the target
resolution, the cutoff schedule re-solved for it (`superres_config`);
`reinit_stem` copies the stem's weights into the grown tree where a leaf's
name and shape match; the rest keeps its fresh init.

The layer names of a grown decoder encode their sampling rates
(``L1_36_256`` there, ``L1_52_256`` in a stem), so at `train_setgan`'s
recipes `reinit_stem` carries the mapping, the input and L0 and leaves
L1–L4 at their init, as the JAX package does (`matching_leaves` lists
what carries). Trees are the port's variable trees: nested dicts of
arrays by collection (``params``, ``buffers``, ``ema``, ``batch_stats``),
as `from_jax.to_jax_variables` writes and `load_jax_variables` reads.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

import numpy as np

from .config import SG3Config, build_synthesis_layout

COLLECTIONS = ("params", "buffers", "ema", "batch_stats")


def superres_config(stem_cfg: SG3Config, super_res: int, head_layers: int,
                    **overrides) -> SG3Config:
    """The config of a generator grown from ``stem_cfg`` to ``super_res``:
    the stem's non-critical layers, then ``head_layers + num_critical`` new
    ones; the geometric schedule re-solved for the larger image."""
    assert super_res > stem_cfg.img_resolution
    stem_layers = stem_cfg.num_layers - stem_cfg.num_critical
    kwargs = dict(
        img_resolution=super_res,
        num_layers=stem_layers + head_layers + stem_cfg.num_critical,
        num_critical=stem_cfg.num_critical,
        channel_base=stem_cfg.channel_base,
        channel_max=stem_cfg.channel_max,
        conv_kernel=stem_cfg.conv_kernel,
        filter_size=stem_cfg.filter_size,
        use_radial_filters=stem_cfg.use_radial_filters,
        magnitude_ema_beta=stem_cfg.magnitude_ema_beta,
        output_scale=stem_cfg.output_scale,
        z_dim=stem_cfg.z_dim,
        c_dim=stem_cfg.c_dim,
        w_dim=stem_cfg.w_dim,
    )
    kwargs.update(overrides)
    return SG3Config(**kwargs)


def head_layer_names(cfg: SG3Config, stem_cfg: SG3Config) -> Tuple[str, ...]:
    """The names of the grown decoder's new (trainable) head layers."""
    layout = build_synthesis_layout(cfg)
    stem_count = stem_cfg.num_layers - stem_cfg.num_critical
    return tuple(spec.name for spec in layout.layers[stem_count:])


def matching_leaves(variables: Mapping, stem_variables: Mapping) -> List[str]:
    """The ``collection/a/b/leaf`` paths that `reinit_stem` carries: present
    in both trees with the same shape."""
    found: List[str] = []

    def walk(dst, src, path):
        for key, sval in src.items():
            if key not in dst:
                continue
            dval = dst[key]
            if isinstance(sval, Mapping) and isinstance(dval, Mapping):
                walk(dval, sval, f"{path}/{key}")
            elif hasattr(sval, "shape") and hasattr(dval, "shape") and \
                    tuple(sval.shape) == tuple(dval.shape):
                found.append(f"{path}/{key}")

    for col in COLLECTIONS:
        if col in stem_variables and col in variables:
            walk(variables[col], stem_variables[col], col)
    return found


def reinit_stem(variables: Mapping, stem_variables: Mapping) -> dict:
    """Copy the stem's leaves into a grown model's tree where name and shape
    match (the reference's ``copy_params_and_buffers`` with
    ``require_all=False``); returns a new tree, ``variables`` unchanged."""

    def copy(tree):
        return {k: copy(v) if isinstance(v, Mapping) else v for k, v in tree.items()}

    out = copy(variables)
    for path in matching_leaves(variables, stem_variables):
        *keys, leaf = path.split("/")
        src, dst = stem_variables, out
        for key in keys:
            src, dst = src[key], dst[key]
        dst[leaf] = np.array(src[leaf])
    return out


def class_embedding_init(num_classes: int, c_dim: int, seed: int = 0) -> np.ndarray:
    """A random (frozen) class-embedding table (the reference's
    ``rand_embedding``): the rows feed the mapping's ``c``."""
    rng = np.random.RandomState(seed)
    return rng.randn(num_classes, c_dim).astype(np.float32)


def load_class_embedding(path) -> np.ndarray:
    """The reference's pretrained ImageNet class embeddings
    (``in_embeddings/*.pkl``: a pickled ``{"embed": nn.Embedding}``) read by
    the allowlist unpickler, no torch class instantiated →
    ``[num_classes, embed_dim]`` float32."""
    from .persistence import _StandaloneUnpickler

    with open(path, "rb") as f:
        data = _StandaloneUnpickler(f).load()
    weight = data["embed"].state_dict()["weight"]
    return np.asarray(weight, dtype=np.float32)

"""Inference helpers: rebuild a trained ReStyle encoder from a checkpoint,
run iterative inversion.

Counterpart of the JAX package's `utils/inference_utils.py` (reference
utils/inference_utils.py): `load_encoder` rebuilds the options from the
checkpoint's sidecar and can swap in another generator; `get_average_image`
and `run_on_batch` are the ReStyle functions.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

from ..device import DeviceLike
from ..models.encoders import restyle as _restyle
from ..models.encoders.restyle import RestyleNet
from ..models.sg3 import SG3Config, load_jax_variables, sg3_r_config
from ..runtime.checkpoint import load_pytree
from ..training.options import E4eTrainOptions, TrainOptions

get_average_image = _restyle.get_average_image
run_on_batch = _restyle.run_restyle_iterations


def load_encoder(checkpoint_path, generator_variables: Optional[Mapping] = None,
                 decoder_cfg: Optional[SG3Config] = None, device: DeviceLike = None
                 ) -> Tuple[RestyleNet, TrainOptions]:
    """Rebuild (model, opts) from a coach checkpoint in the numpy format
    (`runtime.checkpoint`): the tree's ``variables`` fill the model, the
    sidecar's ``opts`` (and ``is_e4e``) rebuild the options.

    ``generator_variables`` (``{params, buffers, ema}`` of a generator)
    swaps in another decoder, such as a PTI-tuned one, or supplies it where
    the checkpoint holds the encoder alone (`scripts.convert_checkpoint`). The model is built on
    the CUDA card unless ``device="cpu"``.
    """
    tree, meta = load_pytree(checkpoint_path)
    assert meta is not None and "opts" in meta, "checkpoint missing opts sidecar"
    opts_cls = E4eTrainOptions if meta.get("is_e4e") else TrainOptions
    field_names = {f.name for f in dataclasses.fields(opts_cls)}
    opts = opts_cls(**{k: v for k, v in dict(meta["opts"]).items() if k in field_names})

    if decoder_cfg is None:
        overrides = {}
        if opts.decoder_channel_base:
            overrides["channel_base"] = opts.decoder_channel_base
        if opts.decoder_channel_max:
            overrides["channel_max"] = opts.decoder_channel_max
        if opts.decoder_num_layers:
            overrides["num_layers"] = opts.decoder_num_layers
        decoder_cfg = sg3_r_config(opts.output_size, **overrides)

    model = RestyleNet(decoder_cfg, encoder_type=opts.encoder_type,
                       n_styles=decoder_cfg.num_ws, input_nc=opts.input_nc, device=device)
    variables = dict(tree["variables"])
    if generator_variables is not None:
        for col in ("params", "buffers", "ema"):
            if col in generator_variables:
                variables[col] = {**variables.get(col, {}), "decoder": generator_variables[col]}
    load_jax_variables(model, variables)
    return model, opts
